"""Parity of the port's whisper-base (the encoder-decoder family) with the
JAX package's, on the CPU, at its REDUCED config in float32.

Both packages run the same weights: the JAX ``init_params`` tree, carried
over by ``interop.whisper_params_from_numpy``; inputs are made from a numpy
seed.  ``encode``, the teacher-forced ``decode_train``, cross-attention
(``attention(kv_override=)``) and ``decode_step`` logits and caches match
the JAX model within rtol = atol = 1e-4 (float32, sums in another order);
greedy tokens of ``greedy_generate`` and ``DecodeEngine`` are identical.
The port's decode steps also match its own teacher-forced pass over an
encoded memory, and its serve CLI serves whisper-base.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models import whisper as jwhisper
from repro.models import zoo as jzoo
from repro.serve import engine as jengine
from repro_torch.configs import get_reduced
from repro_torch.interop import whisper_cache_from_numpy, whisper_params_from_numpy
from repro_torch.models import attention, whisper, zoo
from repro_torch.serve import engine

TOL = dict(rtol=1e-4, atol=1e-4)


@functools.cache
def _models():
    jcfg = importlib.import_module("repro.configs.whisper_base").REDUCED
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_reduced("whisper-base")
    model = zoo.build(cfg, device="cpu")
    params = whisper_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, cfg, model, params


def _frames(b, f=32, d=64, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, f, d)) * 0.02).astype(np.float32)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_encode_vs_jax():
    jcfg, _, jparams, cfg, _, params = _models()
    frames = _frames(2)
    want = jwhisper.encode(jcfg, jparams, jnp.asarray(frames))
    got = whisper.encode(cfg, params, torch.from_numpy(frames))
    assert got.shape == (2, 32, 64)
    _close(got, want)


@pytest.mark.parametrize("s", [12, 32])
def test_decode_train_vs_jax(s):
    """prefill_fn: encode, then the teacher-forced decoder (its cross
    attention with Sq = 12 != Sk = 32, and Sq = Sk)."""
    _, jmodel, jparams, _, model, params = _models()
    frames, tokens = _frames(2, seed=1), _tokens((2, s), seed=1)
    want = jmodel.prefill_fn(jparams, {"frames": jnp.asarray(frames),
                                       "tokens": jnp.asarray(tokens)})
    got = model.prefill_fn(params, {"frames": torch.from_numpy(frames),
                                    "tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, s, 256)
    _close(got, want)


@pytest.mark.parametrize("rope", [False, True])
def test_cross_attention_vs_jax(rope):
    """attention(kv_override=(src, k_positions)): K and V from a source of
    another length, non-causal; with rope the keys turn at their own
    positions."""
    rng = np.random.default_rng(2)
    w = {name: (rng.standard_normal(shape) * 0.2).astype(np.float32)
         for name, shape in (("wq", (16, 4, 8)), ("wk", (16, 2, 8)), ("wv", (16, 2, 8)),
                             ("wo", (4, 8, 16)))}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    src = rng.standard_normal((2, 9, 16)).astype(np.float32)
    k_pos = np.arange(9, dtype=np.int32)
    kw = dict(num_heads=4, num_kv=2, head_dim=8, causal=False, rope=rope)
    want = jattention.attention({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                                positions=jnp.arange(5, dtype=jnp.int32),
                                kv_override=(jnp.asarray(src), jnp.asarray(k_pos)), **kw)
    got = attention.attention({k: torch.from_numpy(v) for k, v in w.items()},
                              torch.from_numpy(x),
                              kv_override=(torch.from_numpy(src), torch.from_numpy(k_pos)),
                              **kw)
    _close(got, want)


def _jcache_leaves(c):
    return [np.asarray(t) for t in (c.self_kv.k, c.self_kv.v, c.cross_k, c.cross_v)]


def _cache_leaves(c):
    return [t.numpy() for t in (c.self_kv.k, c.self_kv.v, c.cross_k, c.cross_v)]


@pytest.mark.parametrize("memory", [False, True], ids=["zero-memory", "encoded"])
def test_decode_steps_and_caches_vs_jax(memory):
    """Six decode steps from init_cache (zero memory, as the engine serves
    it, or the encoder's memory of seeded frames): logits and every cache
    leaf after each step."""
    jcfg, jmodel, jparams, cfg, model, params = _models()
    tokens = _tokens((2, 6), seed=3)
    jmem = mem = None
    if memory:
        frames = _frames(2, seed=3)
        jmem = jwhisper.encode(jcfg, jparams, jnp.asarray(frames))
        mem = whisper.encode(cfg, params, torch.from_numpy(frames))
    jc = jmodel.init_cache(jparams, 2, 16, memory=jmem)
    c = model.init_cache(params, 2, 16, memory=mem)
    for t in range(6):
        jlog, jc = jmodel.decode_fn(jparams, {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                                              "cache": jc, "cache_len": t})
        log, c = model.decode_fn(params, {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
                                          "cache": c, "cache_len": t})
        _close(log, jlog)
        for got, want in zip(_cache_leaves(c), _jcache_leaves(jc)):
            np.testing.assert_allclose(got, want, **TOL)


def test_decode_steps_equal_own_teacher_forced_pass():
    """Decode steps over an encoded memory give the logits of the port's
    own decode_train at every position."""
    _, _, _, cfg, model, params = _models()
    frames, tokens = torch.from_numpy(_frames(2, seed=4)), torch.from_numpy(_tokens((2, 8), 4))
    mem = whisper.encode(cfg, params, frames)
    want = whisper.decode_train(cfg, params, tokens, mem)
    cache = model.init_cache(params, 2, 8, memory=mem)
    for t in range(8):
        log, cache = model.decode_fn(params, {"tokens": tokens[:, t:t + 1], "cache": cache,
                                              "cache_len": t})
        torch.testing.assert_close(log[:, 0], want[:, t], **TOL)


def test_per_slot_cache_len_gathers_positions():
    """A [B] cache_len (the engine's) gathers pos_dec per slot ([B, 1, D]):
    slots at lengths 0 and 3 decode as two scalar-length calls do."""
    _, _, _, cfg, model, params = _models()
    tokens = torch.from_numpy(_tokens((2, 4), seed=5))
    solo = []
    for b, length in ((0, 0), (1, 3)):
        cache = model.init_cache(params, 1, 8)
        for t in range(length):
            _, cache = model.decode_fn(params, {"tokens": tokens[b:b + 1, t:t + 1],
                                                "cache": cache, "cache_len": t})
        log, _ = model.decode_fn(params, {"tokens": tokens[b:b + 1, 3:4], "cache": cache,
                                          "cache_len": length})
        solo.append(log)
    cache = model.init_cache(params, 2, 8)
    for t in range(3):   # slot 1 fills its cache; slot 0's rows are rewritten below
        _, cache = model.decode_fn(params, {"tokens": tokens[:, t:t + 1], "cache": cache,
                                            "cache_len": t})
    log, _ = model.decode_fn(params, {"tokens": tokens[:, 3:4], "cache": cache,
                                      "cache_len": torch.tensor([0, 3], dtype=torch.int32)})
    torch.testing.assert_close(log[1:], solo[1], **TOL)
    torch.testing.assert_close(log[:1], solo[0], **TOL)


def test_greedy_generate_vs_jax():
    _, jmodel, jparams, _, model, params = _models()
    prompts = _tokens((2, 5), seed=6)
    want = jengine.greedy_generate(jmodel, jparams, jnp.asarray(prompts), max_new_tokens=8)
    got = engine.greedy_generate(model, params, torch.from_numpy(prompts), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_engine_tokens_vs_jax():
    """Continuous batching over 2 slots, 5 requests of 3-9 prompt tokens:
    each request's tokens equal the JAX engine's.  Admission slices every
    leaf of the WhisperCache at axis 1 (the cross K/V too), as JAX's
    tree map does."""
    _, jmodel, jparams, _, model, params = _models()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 10))).astype(np.int32)
               for _ in range(5)]
    jeng = jengine.DecodeEngine(jmodel, jparams, slots=2, max_len=32)
    eng = engine.DecodeEngine(model, params, slots=2, max_len=32)
    jreqs = [jengine.Request(i, p, 6) for i, p in enumerate(prompts)]
    reqs = [engine.Request(i, p, 6) for i, p in enumerate(prompts)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    jeng.run()
    eng.run()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 6 for r in reqs)


def test_engine_admission_writes_through_to_the_engine_cache():
    """The slot view that admission prefills is the engine's own cache: the
    self-attention rows of the admitted slot change, the other slot's stay."""
    _, _, _, _, model, params = _models()
    eng = engine.DecodeEngine(model, params, slots=2, max_len=16)
    before = eng.cache.self_kv.k.clone()
    eng.submit(engine.Request(0, _tokens((4,), seed=8), 2))
    eng._admit()
    after = eng.cache.self_kv.k
    assert not torch.equal(after[:, 0, :4], before[:, 0, :4])
    assert torch.equal(after[:, 1], before[:, 1])


def test_whisper_cache_from_numpy_continues_a_jax_decode():
    """A JAX WhisperCache after three steps, carried over: the port's next
    step equals JAX's."""
    _, jmodel, jparams, _, model, params = _models()
    tokens = _tokens((2, 4), seed=9)
    jc = jmodel.init_cache(jparams, 2, 8)
    for t in range(3):
        _, jc = jmodel.decode_fn(jparams, {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                                           "cache": jc, "cache_len": t})
    cache = whisper_cache_from_numpy(*_jcache_leaves(jc), device="cpu")
    jlog, _ = jmodel.decode_fn(jparams, {"tokens": jnp.asarray(tokens[:, 3:]), "cache": jc,
                                         "cache_len": 3})
    log, _ = model.decode_fn(params, {"tokens": torch.from_numpy(tokens[:, 3:]),
                                      "cache": cache, "cache_len": 3})
    _close(log, jlog)


def test_whisper_params_from_numpy_rejects_other_config():
    import dataclasses
    _, _, jparams, cfg, _, _ = _models()
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="stacked"):
        whisper_params_from_numpy(dataclasses.replace(cfg, num_layers=3), tree, "cpu")
    with pytest.raises(ValueError, match="pos_dec"):
        whisper_params_from_numpy(dataclasses.replace(cfg, max_positions=64), tree, "cpu")


def test_serve_cli_serves_whisper(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", "whisper-base"])
    assert "served 8 requests / 128 tokens" in capsys.readouterr().out
