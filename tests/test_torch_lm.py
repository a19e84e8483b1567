"""Parity of the port's language models with the JAX package's, on the CPU:
the six REDUCED configs the port has (moonshot-v1-16b-a3b and
deepseek-v2-lite-16b with MoE, deepseek's with MLA; gemma2-2b with local
and global layers and soft-caps; llama3.2-3b, yi-6b, starcoder2-15b).

Both packages run the same weights: the JAX ``init_params`` tree, carried
over by ``interop.lm_params_from_numpy``.  ``prefill_fn`` logits and
``decode_fn`` steps must match the JAX model within rtol = atol = 1e-4
(float32, sums in another order), the MoE configs under ``moe_impl``
"onehot" and "kernel"; greedy tokens from ``greedy_generate`` and
``DecodeEngine`` must be identical.  The decode steps run past gemma2's
window of 8, so its local layers' ring cache is held too.  moonshot's
cases keep their ids; the other configs' carry the config's name.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import zoo as jzoo
from repro.serve import engine as jengine
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import zoo
from repro_torch.serve import engine

CPU = torch.device("cpu")
MOONSHOT = "moonshot_v1_16b_a3b"
MOE = (MOONSHOT, "deepseek_v2_lite_16b")
DENSE = ("llama3_2_3b", "yi_6b", "starcoder2_15b", "gemma2_2b")
OTHERS = (*MOE[1:], *DENSE)


def _jax_reduced(arch):
    return importlib.import_module(f"repro.configs.{arch}").REDUCED


@functools.cache
def _models(arch):
    jcfg = _jax_reduced(arch)
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_reduced(arch)
    model = zoo.build(cfg, device="cpu")
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), CPU)
    return jmodel, jparams, model, params


def _impl_cases():
    """(arch, moe_impl): both impls for the MoE configs, one for the dense
    ones; moonshot's cases keep the ids they had before the other configs."""
    cases = [pytest.param(MOONSHOT, impl, id=impl) for impl in ("onehot", "kernel")]
    cases += [pytest.param(arch, impl, id=f"{arch}-{impl}")
              for arch in MOE[1:] for impl in ("onehot", "kernel")]
    cases += [pytest.param(arch, "onehot", id=arch) for arch in DENSE]
    return cases


def _tokens(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch,impl", _impl_cases())
def test_prefill_logits_vs_jax(arch, impl):
    _, jparams, model, params = _models(arch)
    jcfg = dataclasses.replace(_jax_reduced(arch), moe_impl=impl)
    jmodel = jzoo.build(jcfg)
    tokens = _tokens((2, 64))            # 128 tokens: two MoE dispatch groups
    want = jmodel.prefill_fn(jparams, {"tokens": jnp.asarray(tokens)})
    got = model.prefill_fn(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 64, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _leaves(cache):
    return [(f"{j}.{name}", t) for j, c in sorted(cache.items())
            for name, t in zip(c._fields, c)]


@pytest.mark.parametrize("arch,impl", _impl_cases())
def test_decode_steps_vs_jax(arch, impl):
    """Eleven steps with a scalar length (past gemma2's window of 8), then
    one with per-slot lengths; every cache leaf at the end."""
    _, jparams, model, params = _models(arch)
    jmodel = jzoo.build(dataclasses.replace(_jax_reduced(arch), moe_impl=impl))
    b, max_len, steps = 3, 16, 11
    jcache = jmodel.init_cache(None, b, max_len)
    cache = model.init_cache(None, b, max_len)
    toks = _tokens((steps + 1, b), seed=1)
    lens = [*range(steps), np.array([steps, 2, 0], np.int32)]
    for tok, n in zip(toks, lens):
        want, jcache = jmodel.decode_fn(jparams, {"tokens": jnp.asarray(tok[:, None]),
                                                  "cache": jcache,
                                                  "cache_len": jnp.asarray(n)})
        got, cache = model.decode_fn(params, {"tokens": torch.from_numpy(tok[:, None]),
                                              "cache": cache,
                                              "cache_len": torch.as_tensor(n)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    got_leaves = _leaves(cache)
    want_leaves = _leaves(jcache)
    assert [n for n, _ in got_leaves] == [n for n, _ in want_leaves]
    for (name, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _greedy_generate_tokens_vs_jax(arch):
    jmodel, jparams, model, params = _models(arch)
    prompts = _tokens((3, 6), seed=2)
    want = jengine.greedy_generate(jmodel, jparams, jnp.asarray(prompts), max_new_tokens=4)
    got = engine.greedy_generate(model, params, torch.from_numpy(prompts), max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_tokens_vs_jax():
    _greedy_generate_tokens_vs_jax(MOONSHOT)


@pytest.mark.parametrize("arch", OTHERS)
def test_greedy_generate_tokens_vs_jax_per_config(arch):
    _greedy_generate_tokens_vs_jax(arch)


def _decode_engine_tokens_vs_jax(arch):
    """Three requests over two slots: the third joins mid-flight, and empty
    slots decode their stale token as in the JAX engine."""
    jmodel, jparams, model, params = _models(arch)
    prompts = [_tokens((n,), seed=3 + n) for n in (5, 3, 5)]
    outs = []
    for mod, par, eng, req in ((jmodel, jparams, jengine.DecodeEngine, jengine.Request),
                               (model, params, engine.DecodeEngine, engine.Request)):
        e = eng(mod, par, slots=2, max_len=32)
        reqs = [req(i, p, n) for i, (p, n) in enumerate(zip(prompts, (6, 3, 4)))]
        for r in reqs:
            e.submit(r)
        e.run()
        assert all(r.done for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[1]] == [6, 3, 4]


def test_decode_engine_tokens_vs_jax():
    _decode_engine_tokens_vs_jax(MOONSHOT)


@pytest.mark.parametrize("arch", OTHERS)
def test_decode_engine_tokens_vs_jax_per_config(arch):
    _decode_engine_tokens_vs_jax(arch)


def test_lm_params_from_numpy_rejects_other_config():
    _, jparams, _, _ = _models(MOONSHOT)
    cfg = dataclasses.replace(get_reduced("moonshot-v1-16b-a3b"), num_layers=4)
    with pytest.raises(ValueError, match="stacked over 4 periods"):
        lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), CPU)
