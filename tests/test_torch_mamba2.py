"""Parity of the port's Mamba-2 (SSD) and of the SSM and hybrid models
with the JAX package's, on the CPU.

Module level, at mamba2-780m's reduced geometry (d_model 64, d_inner 128,
8 heads of 16, d_state 16, chunks of 16), float32, rtol = atol = 1e-4
(sums in another order): ``_causal_conv``, ``mamba2_forward`` at a length
that is a multiple of the chunk, at one that is not, and from an initial
state (output and final state), and a run of ``mamba2_decode`` steps
(outputs and the cache it writes in place) against JAX's steps and
against both forwards.

Whole model, REDUCED mamba2-780m and jamba-1.5-large (mamba, attention,
dense and MoE layers), weights carried over from JAX's ``init_params`` by
``interop.lm_params_from_numpy``: prefill logits against JAX's
``prefill_fn`` and the port's decode-by-decode logits against its own
prefill at rtol = atol = 2e-3 (the tolerance of
tests/test_decode_equivalence.py), decode steps and the caches against
JAX's at 1e-4, greedy tokens identical to JAX's ``greedy_generate``.

``DecodeEngine`` zeroes a slot's SSM state at admission (a deliberate
divergence from the JAX engine, which hands a reused slot the last
request's state): every admission's logits equal a fresh-cache prefill's
(rtol = atol = 1e-5), and the first two, on fresh slots in both engines,
equal JAX's (1e-4).  Logits, not tokens: random REDUCED weights repeat one
token.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mamba2_780m import REDUCED as JCFG
from repro.models import mamba2 as jm2
from repro.models import zoo as jzoo
from repro.serve import engine as jengine
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_numpy, tree_from_numpy
from repro_torch.models import mamba2 as m2
from repro_torch.models import zoo
from repro_torch.serve import engine

CPU = torch.device("cpu")
GEOM = dict(d_inner=JCFG.d_inner, num_heads=JCFG.ssm_heads, d_state=JCFG.d_state)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("mamba2_780m", "jamba_1_5_large_398b")


def _rng(seed):
    return np.random.default_rng(seed)


def _mixer(seed):
    jp = jm2.mamba2_params(jax.random.PRNGKey(seed), JCFG.d_model, JCFG.d_inner,
                           JCFG.ssm_heads, JCFG.d_state)
    # a_log, dt_bias and the conv bias start at constants: give them values
    # so the decay, the step size and the bias are each exercised
    rng = _rng(seed + 100)
    jp = dict(jp, a_log=jnp.asarray(rng.normal(0, 0.5, JCFG.ssm_heads), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(0, 0.5, JCFG.ssm_heads), jnp.float32),
              conv_b=jnp.asarray(rng.normal(0, 0.1, jp["conv_b"].shape), jnp.float32))
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def test_mamba2_params_layout_matches_jax():
    jp, _ = _mixer(0)
    tp = m2.mamba2_params(torch.Generator().manual_seed(0), JCFG.d_model,
                          JCFG.d_inner, JCFG.ssm_heads, JCFG.d_state)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp))[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), tp))[0]
    assert got == want
    cache = m2.init_mamba_cache(3, JCFG.d_inner, JCFG.ssm_heads, JCFG.d_state,
                                torch.float32, CPU)
    jcache = jm2.init_mamba_cache(3, JCFG.d_inner, JCFG.ssm_heads, JCFG.d_state,
                                  jnp.float32)
    assert [tuple(t.shape) for t in cache] == [c.shape for c in jcache]
    assert m2.CONV_K == jm2.CONV_K


def test_causal_conv_vs_jax():
    rng = _rng(1)
    u = rng.standard_normal((2, 21, 160)).astype(np.float32)
    w = rng.standard_normal((m2.CONV_K, 160)).astype(np.float32)
    bias = rng.standard_normal(160).astype(np.float32)
    want = jm2._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(bias))
    got = m2._causal_conv(*(torch.from_numpy(a) for a in (u, w, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_proj_matches_jax():
    proj = _rng(2).standard_normal((2, 3, 2 * JCFG.d_inner + 2 * JCFG.d_state
                                    + JCFG.ssm_heads)).astype(np.float32)
    want = jm2._split_proj(jnp.asarray(proj), JCFG.d_inner, JCFG.d_state, JCFG.ssm_heads)
    got = m2._split_proj(torch.from_numpy(proj), JCFG.d_inner, JCFG.d_state,
                         JCFG.ssm_heads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("b,s,initial", [(2, 48, False), (2, 37, False), (1, 21, True)],
                         ids=["chunk_multiple", "not_chunk_multiple", "initial_state"])
def test_mamba2_forward_vs_jax(b, s, initial):
    jp, tp = _mixer(s)
    rng = _rng(s)
    x = rng.standard_normal((b, s, JCFG.d_model)).astype(np.float32)
    s0 = (rng.standard_normal((b, JCFG.ssm_heads, JCFG.ssm_head_dim, JCFG.d_state))
          .astype(np.float32) if initial else None)
    want, want_state = jm2.mamba2_forward(
        jp, jnp.asarray(x), chunk=JCFG.ssm_chunk,
        initial_state=None if s0 is None else jnp.asarray(s0), **GEOM)
    got, got_state = m2.mamba2_forward(
        tp, torch.from_numpy(x), chunk=JCFG.ssm_chunk,
        initial_state=None if s0 is None else torch.from_numpy(s0), **GEOM)
    assert got.shape == (b, s, JCFG.d_model)
    assert got_state.shape == (b, JCFG.ssm_heads, JCFG.ssm_head_dim, JCFG.d_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state), **TOL)


def test_mamba2_decode_steps_vs_jax_and_forward():
    """Nine decode steps from a zero cache in both packages: each step's
    output against JAX's, the in-place cache against JAX's returned one, and
    the outputs and final state against both packages' forwards."""
    jp, tp = _mixer(3)
    b, s = 2, 9
    x = _rng(3).standard_normal((b, s, JCFG.d_model)).astype(np.float32)
    jcache = jm2.init_mamba_cache(b, JCFG.d_inner, JCFG.ssm_heads, JCFG.d_state,
                                  jnp.float32)
    cache = m2.init_mamba_cache(b, JCFG.d_inner, JCFG.ssm_heads, JCFG.d_state,
                                torch.float32, CPU)
    outs = []
    for t in range(s):
        want, jcache = jm2.mamba2_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, **GEOM)
        got, back = m2.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]), cache, **GEOM)
        assert back is cache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        outs.append(got[:, 0])
    for g, w in zip(cache, jcache):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    fwd, fwd_state = m2.mamba2_forward(tp, torch.from_numpy(x), chunk=4, **GEOM)
    jfwd, _ = jm2.mamba2_forward(jp, jnp.asarray(x), chunk=4, **GEOM)
    stepped = torch.stack(outs, dim=1).numpy()
    np.testing.assert_allclose(stepped, fwd.numpy(), **TOL)
    np.testing.assert_allclose(stepped, np.asarray(jfwd), **TOL)
    np.testing.assert_allclose(cache.state.numpy(), fwd_state.numpy(), **TOL)
    # the conv tail holds the last CONV_K - 1 pre-conv [x|B|C] rows
    proj = torch.from_numpy(x[:, -(m2.CONV_K - 1):]) @ tp["in_proj"]
    _, xs, bs, cs, _ = m2._split_proj(proj, JCFG.d_inner, JCFG.d_state, JCFG.ssm_heads)
    np.testing.assert_allclose(cache.conv.numpy(), torch.cat([xs, bs, cs], -1).numpy(),
                               **TOL)


def test_mamba2_forward_large_decay_has_no_nan():
    """A steep decay drives cum_i - cum_j far above 0 over the upper
    triangle, where exp overflows: the masked form must stay finite."""
    jp, tp = _mixer(4)
    tp["a_log"] = torch.full_like(tp["a_log"], 4.0)          # a = -e^4
    jp = dict(jp, a_log=jnp.full_like(jp["a_log"], 4.0))
    x = _rng(4).standard_normal((1, 32, JCFG.d_model)).astype(np.float32) * 4
    got, state = m2.mamba2_forward(tp, torch.from_numpy(x), chunk=16, **GEOM)
    want, _ = jm2.mamba2_forward(jp, jnp.asarray(x), chunk=16, **GEOM)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(state).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ whole model

def _jax_reduced(arch):
    return importlib.import_module(f"repro.configs.{arch}").REDUCED


@functools.cache
def _models(arch):
    jmodel = jzoo.build(_jax_reduced(arch))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_reduced(arch)
    model = zoo.build(cfg, device="cpu")
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), CPU)
    return jmodel, jparams, model, params


def _tokens(shape, seed=0, vocab=256):
    return _rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_vs_jax(arch):
    """[8, 40]: 40 is not a multiple of the chunk of 16; 320 tokens are
    five of jamba's MoE dispatch groups of 64."""
    jmodel, jparams, model, params = _models(arch)
    tokens = _tokens((8, 40))
    want = jmodel.prefill_fn(jparams, {"tokens": jnp.asarray(tokens)})
    got = model.prefill_fn(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (8, 40, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def _leaves(cache):
    return [(f"{j}.{name}", t) for j, c in sorted(cache.items())
            for name, t in zip(c._fields, c)]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_vs_jax(arch):
    """Ten steps with a scalar length, then one with per-slot lengths; the
    logits of each and every cache leaf at the end, rtol = atol = 1e-4."""
    jmodel, jparams, model, params = _models(arch)
    b, max_len, steps = 3, 16, 10
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
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_leaves, want_leaves = _leaves(cache), _leaves(jcache)
    assert [n for n, _ in got_leaves] == [n for n, _ in want_leaves]
    for (name, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_prefill(arch):
    """The shape of tests/test_decode_equivalence.py (B = 2, S = 12): each
    decode step's logits against the prefill's at that position."""
    _, _, model, params = _models(arch)
    tokens = torch.from_numpy(_tokens((2, 12), seed=5))
    full = model.prefill_fn(params, {"tokens": tokens})
    cache = model.init_cache(None, 2, 13)
    got = []
    for t in range(12):
        logits, cache = model.decode_fn(params, {"tokens": tokens[:, t:t + 1],
                                                 "cache": cache, "cache_len": t})
        got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_vs_jax(arch):
    jmodel, jparams, model, params = _models(arch)
    prompts = _tokens((3, 6), seed=2)
    want = jengine.greedy_generate(jmodel, jparams, jnp.asarray(prompts), max_new_tokens=4)
    got = engine.greedy_generate(model, params, torch.from_numpy(prompts), max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _admission_logits(mod, eng_mod, model, params, prompts, max_new, monkeypatch):
    """Serve ``prompts`` through a 2-slot DecodeEngine of ``eng_mod``; the
    logits each admission's prefill returned, in admission order."""
    seen = []
    real = eng_mod.prefill_cache

    def recording(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        seen.append(np.asarray(logits[0]))
        return logits, cache

    monkeypatch.setattr(eng_mod, "prefill_cache", recording)
    e = eng_mod.DecodeEngine(model, params, slots=2, max_len=32)
    reqs = [eng_mod.Request(i, p, max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        e.submit(r)
    e.run()
    monkeypatch.setattr(eng_mod, "prefill_cache", real)
    assert all(r.done and len(r.out) == max_new for r in reqs)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_admission_resets_ssm_state(arch, monkeypatch):
    """Four requests of 6 tokens over 2 slots: the 3rd and 4th reuse slots
    whose SSM state the first two (and the empty slots' stale decodes)
    left.  Every admission's logits equal a fresh-cache prefill's; the first
    two equal the JAX engine's."""
    jmodel, jparams, model, params = _models(arch)
    prompts = [_tokens((6,), seed=10 + i) for i in range(4)]
    got = _admission_logits(model, engine, model, params, prompts, 5, monkeypatch)
    assert len(got) == 4
    for i, p in enumerate(prompts):
        fresh, _ = engine.prefill_cache(model, params, torch.from_numpy(p)[None],
                                        model.init_cache(None, 1, 32))
        np.testing.assert_allclose(got[i], fresh[0].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"admission {i}")
    want = _admission_logits(jmodel, jengine, jmodel, jparams, prompts, 5, monkeypatch)
    for i in range(2):
        np.testing.assert_allclose(got[i], want[i], err_msg=f"admission {i}", **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_tokens_vs_jax(arch):
    """Two requests on fresh slots, the engine's greedy tokens against the
    JAX engine's (a reused slot differs by design: see above)."""
    jmodel, jparams, model, params = _models(arch)
    prompts = [_tokens((n,), seed=3 + n) for n in (5, 3)]
    outs = []
    for mod, par, eng in ((jmodel, jparams, jengine), (model, params, engine)):
        e = eng.DecodeEngine(mod, par, slots=2, max_len=32)
        reqs = [eng.Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, (6, 3)))]
        for r in reqs:
            e.submit(r)
        e.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


# ------------------------------------------------------------- interop

def test_lm_params_from_numpy_takes_ffn_less_periods():
    """mamba2's JAX tree has no norm2 or ffn; a tree with them, or one
    without them for a config whose FFN is dense, is refused."""
    _, jparams, _, params = _models("mamba2_780m")
    cfg = get_reduced("mamba2-780m")
    assert set(params["blocks"]) == {"0.norm1", "0.mixer"}
    tree = jax.tree.map(np.asarray, jparams)
    extra = dict(tree, blocks=dict(tree["blocks"], **{
        "0.norm2": {"scale": np.ones((cfg.num_periods, cfg.d_model), np.float32)}}))
    with pytest.raises(ValueError, match="block keys"):
        lm_params_from_numpy(cfg, extra, CPU)
    import dataclasses
    dense = dataclasses.replace(cfg, ffn_pattern=("dense",))
    with pytest.raises(ValueError, match="block keys"):
        lm_params_from_numpy(dense, tree, CPU)


def test_lm_params_from_numpy_takes_jamba_tree():
    _, jparams, _, params = _models("jamba_1_5_large_398b")
    cfg = get_reduced("jamba-1.5-large-398b")
    assert {k for k in params["blocks"] if k.endswith(".ffn")} == \
        {f"{j}.ffn" for j in range(cfg.period)}
    assert set(params["blocks"]["4.mixer"]) == {"wq", "wk", "wv", "wo"}
    assert "a_log" in params["blocks"]["0.mixer"]


def test_admission_zeroes_ssm_state_anywhere_in_a_cache_tree():
    """``DecodeEngine``'s admission reset finds a ``MambaCache`` wherever it
    sits in a cache tree (a dict of periods, a tuple, a list) and zeroes it
    in place; a tensor outside any ``MambaCache`` keeps its values."""
    def mamba():
        return m2.MambaCache(state=torch.ones((1, 2, 3)), conv=torch.ones((1, 3, 4)))

    kv = torch.ones((1, 2, 5))
    tree = {"0": mamba(), "1": (kv, [mamba()]), "2": {"inner": mamba()}}
    engine._zero_ssm_state(tree)
    for cache in (tree["0"], tree["1"][1][0], tree["2"]["inner"]):
        assert all(not t.any() for t in cache)
    assert bool((kv == 1).all())
