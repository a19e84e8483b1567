"""Parity of the port's VLM backbone (phi-3-vision, the stub patch
frontend) with the JAX package's, on the CPU.

REDUCED phi-3-vision (2 layers, MHA 4 x 16, 8 patches of 32), weights
carried over from JAX's ``init_params`` (``patch_proj`` included) by
``interop.lm_params_from_numpy``.  The prefill on seeded patches and tokens
must match JAX's ``prefill_fn`` within rtol = atol = 2e-3 (the tolerance of
tests/test_decode_equivalence.py; float32, sums in another order), logits
over the patch positions too, as JAX's.  The VLM serves text only, as the
JAX engine does: its decode-by-decode logits against its own prefill of the
same backbone without patches (2e-3), its greedy tokens and its
``DecodeEngine``'s identical to JAX's.  The frontend stub's shapes equal
JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.phi3_vision_4_2b import REDUCED as JCFG
from repro.models import frontends as jfrontends
from repro.models import zoo as jzoo
from repro.serve import engine as jengine
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import frontends, zoo
from repro_torch.serve import engine

CPU = torch.device("cpu")
ARCH = "phi-3-vision-4.2b"


@functools.cache
def _models():
    jmodel = jzoo.build(JCFG)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    model = zoo.build(cfg, device="cpu")
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), CPU)
    return jmodel, jparams, model, params


def _batch(b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JCFG.vocab, (b, s)).astype(np.int32)
    patches = (rng.standard_normal((b, JCFG.num_patches, JCFG.patch_embed_dim))
               * 0.02).astype(np.float32)
    return tokens, patches


@pytest.mark.parametrize("b,s", [(2, 24), (1, 7)])
def test_prefill_with_patches_vs_jax(b, s):
    jmodel, jparams, model, params = _models()
    tokens, patches = _batch(b, s, seed=s)
    want = jmodel.prefill_fn(jparams, {"tokens": jnp.asarray(tokens),
                                       "patches": jnp.asarray(patches)})
    got = model.prefill_fn(params, {"tokens": torch.from_numpy(tokens),
                                    "patches": torch.from_numpy(patches)})
    assert got.shape == (b, JCFG.num_patches + s, JCFG.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_prefill_without_patches_raises():
    _, _, model, params = _models()
    with pytest.raises(ValueError, match="patches"):
        model.prefill_fn(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_text_decode_matches_own_prefill():
    """Text only: each decode step's logits against the prefill of the same
    backbone and weights with the patch frontend off (B = 2, S = 12)."""
    _, _, model, params = _models()
    text = zoo.build(dataclasses.replace(model.cfg, num_patches=0), device="cpu")
    tokens = torch.from_numpy(_batch(2, 12, seed=5)[0])
    full = text.prefill_fn({k: v for k, v in params.items() if k != "patch_proj"},
                           {"tokens": tokens})
    cache = model.init_cache(None, 2, 13)
    got = []
    for t in range(12):
        logits, cache = model.decode_fn(params, {"tokens": tokens[:, t:t + 1],
                                                 "cache": cache, "cache_len": t})
        got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_greedy_generate_tokens_vs_jax():
    jmodel, jparams, model, params = _models()
    prompts = _batch(3, 6, seed=2)[0]
    want = jengine.greedy_generate(jmodel, jparams, jnp.asarray(prompts), max_new_tokens=4)
    got = engine.greedy_generate(model, params, torch.from_numpy(prompts), max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_engine_tokens_vs_jax():
    """Three requests over two slots, the third joining mid-flight."""
    jmodel, jparams, model, params = _models()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, JCFG.vocab, n).astype(np.int32) for n in (5, 3, 5)]
    outs = []
    for mod, par, eng in ((jmodel, jparams, jengine), (model, params, engine)):
        e = eng.DecodeEngine(mod, par, slots=2, max_len=32)
        reqs = [eng.Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, (6, 3, 4)))]
        for r in reqs:
            e.submit(r)
        e.run()
        assert all(r.done for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_frontend_stub_shapes_match_jax():
    cfg = get_reduced(ARCH)
    assert frontends.vision_patches_shape(cfg, 3) == jfrontends.vision_patches_shape(JCFG, 3)
    assert frontends.audio_frames_shape(cfg, 3) == jfrontends.audio_frames_shape(JCFG, 3)
    gen = torch.Generator().manual_seed(0)
    patches = frontends.random_patches(cfg, gen, 2)
    assert patches.shape == (2, JCFG.num_patches, JCFG.patch_embed_dim)
    assert patches.dtype == cfg.cdtype
    assert 0.01 < float(patches.std()) < 0.03
    assert frontends.random_frames(cfg, gen, 2).shape == (2, 0, cfg.d_model)


def test_lm_params_from_numpy_takes_patch_proj():
    """The JAX tree's patch_proj comes over; a tree without it, or with one
    of another width, is refused, and so is a patch_proj for a config
    without patches."""
    _, jparams, _, params = _models()
    cfg = get_reduced(ARCH)
    assert tuple(params["patch_proj"]["w"].shape) == (JCFG.patch_embed_dim, JCFG.d_model)
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="patch_proj None"):
        lm_params_from_numpy(cfg, {k: v for k, v in tree.items() if k != "patch_proj"}, CPU)
    wide = dict(tree, patch_proj={"w": np.zeros((64, JCFG.d_model), np.float32)})
    with pytest.raises(ValueError, match="patch_proj"):
        lm_params_from_numpy(cfg, wide, CPU)
    with pytest.raises(ValueError, match="patch_proj"):
        lm_params_from_numpy(dataclasses.replace(cfg, num_patches=0), tree, CPU)
