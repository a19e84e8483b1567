"""Parity of the port's MoE LM (moonshot-v1-16b-a3b, reduced) with the JAX
package's, on the CPU.

Both packages run the same weights: the JAX ``init_params`` tree, carried
over by ``interop.lm_params_from_numpy``.  ``prefill_fn`` logits and
``decode_fn`` steps must match the JAX model under ``moe_impl`` "onehot"
and "kernel" within rtol = atol = 1e-4 (float32, sums in another order);
greedy tokens from ``greedy_generate`` and ``DecodeEngine`` must be
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.moonshot_v1_16b_a3b import REDUCED as JAX_REDUCED
from repro.models import zoo as jzoo
from repro.serve import engine as jengine
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import zoo
from repro_torch.serve import engine

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    jmodel = jzoo.build(JAX_REDUCED)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_reduced("moonshot-v1-16b-a3b")
    model = zoo.build(cfg, device="cpu")
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), CPU)
    return jmodel, jparams, model, params


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, JAX_REDUCED.vocab, shape).astype(np.int32)


@pytest.mark.parametrize("impl", ["onehot", "kernel"])
def test_prefill_logits_vs_jax(models, impl):
    jmodel, jparams, model, params = models
    jmodel = jzoo.build(dataclasses.replace(JAX_REDUCED, moe_impl=impl))
    tokens = _tokens((2, 64))            # 128 tokens: two MoE dispatch groups
    want = jmodel.prefill_fn(jparams, {"tokens": jnp.asarray(tokens)})
    got = model.prefill_fn(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 64, JAX_REDUCED.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["onehot", "kernel"])
def test_decode_steps_vs_jax(models, impl):
    """Four steps with a scalar length, then one with per-slot lengths."""
    _, jparams, model, params = models
    jmodel = jzoo.build(dataclasses.replace(JAX_REDUCED, moe_impl=impl))
    b, max_len = 3, 16
    jcache = jmodel.init_cache(None, b, max_len)
    cache = model.init_cache(None, b, max_len)
    toks = _tokens((5, b), seed=1)
    lens = [0, 1, 2, 3, np.array([4, 2, 0], np.int32)]
    for tok, n in zip(toks, lens):
        want, jcache = jmodel.decode_fn(jparams, {"tokens": jnp.asarray(tok[:, None]),
                                                  "cache": jcache,
                                                  "cache_len": jnp.asarray(n)})
        got, cache = model.decode_fn(params, {"tokens": torch.from_numpy(tok[:, None]),
                                              "cache": cache,
                                              "cache_len": torch.as_tensor(n)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache["0"].k.numpy(), np.asarray(jcache["0"].k),
                               rtol=1e-4, atol=1e-4)


def test_greedy_generate_tokens_vs_jax(models):
    jmodel, jparams, model, params = models
    prompts = _tokens((3, 6), seed=2)
    want = jengine.greedy_generate(jmodel, jparams, jnp.asarray(prompts), max_new_tokens=4)
    got = engine.greedy_generate(model, params, torch.from_numpy(prompts), max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_engine_tokens_vs_jax(models):
    """Three requests over two slots: the third joins mid-flight, and empty
    slots decode their stale token as in the JAX engine."""
    jmodel, jparams, model, params = models
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


def test_lm_params_from_numpy_rejects_other_config(models):
    jmodel, jparams, _, _ = models
    cfg = dataclasses.replace(get_reduced("moonshot-v1-16b-a3b"), num_layers=4)
    with pytest.raises(ValueError, match="stacked over 4 periods"):
        lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), CPU)
