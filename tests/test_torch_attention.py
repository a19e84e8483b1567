"""Parity of the port's attention with the JAX package's, on the CPU.

The plain flash attention (``repro_torch.kernels.ref``, reached through
``dispatch`` for CPU tensors, the CPU path of the model's ``attention``)
against ``repro.kernels.ref.flash_attention`` at the shapes of
tests/test_kernels.py plus a window case, and against the JAX model's
``sdpa_chunked``, soft-capped too (gemma2's cap of 50, with GQA and a
window); then the model's ``attention`` (soft-capped at 30 too) and
``attention_decode`` (per-slot lengths, the ring buffer) against
``repro.models.attention`` on the same weights and inputs.
Tolerances: 1e-5 in float32 (sums in another order), 2e-2 in bfloat16,
as in tests/test_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.interop import tree_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn

SHAPES = [(1, 16, 16, 2, 2, 8), (2, 33, 33, 4, 2, 16), (1, 64, 64, 4, 1, 32)]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, b, sq, sk, h, kv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, sk, kv, dh)).astype(np.float32),
            rng.standard_normal((b, sk, kv, dh)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,dh", SHAPES)
def test_plain_flash_vs_jax_ref(b, sq, sk, h, kv, dh, dtype):
    q, k, v = _qkv(sq * h, b, sq, sk, h, kv, dh)
    got = dispatch.flash_attention(*(torch.from_numpy(a).to(TORCH_DTYPES[dtype])
                                     for a in (q, k, v)))
    want = jref.flash_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_window_vs_jax_ref(causal):
    q, k, v = _qkv(1, 1, 48, 48, 2, 2, 16)
    got = dispatch.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                   window=8)
    want = jref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_plain_flash_equals_sdpa_chunked(window):
    """The port's attention (the flash kernel's function) and the JAX
    model's chunked online-softmax attention compute one function."""
    q, k, v = _qkv(2, 2, 32, 32, 4, 2, 16)
    pos = jnp.arange(32)
    got = dispatch.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window or 0)
    want = jattn.sdpa_chunked(*map(jnp.asarray, (q, k, v)), q_pos=pos, k_pos=pos,
                              window=window, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_scale", [1, 8])
@pytest.mark.parametrize("window", [None, 8])
def test_plain_flash_softcap_equals_sdpa_chunked(window, q_scale):
    """gemma2's cap of 50 with GQA (4 heads over 2), with and without a
    window; q scaled by 8 puts scores where the cap bends them."""
    q, k, v = _qkv(5, 2, 40, 40, 4, 2, 16)
    q = q * q_scale
    pos = jnp.arange(40)
    got = dispatch.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window or 0,
                                   softcap=50.0)
    want = jattn.sdpa_chunked(*map(jnp.asarray, (q, k, v)), q_pos=pos, k_pos=pos,
                              window=window, softcap_val=50.0, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if q_scale == 8:      # the cap moved the answer
        uncapped = dispatch.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                            window=window or 0)
        assert float((uncapped - got).abs().max()) > 1e-3


def _params(seed, d, h, kv, dh):
    jp = jattn.attn_params(jax.random.PRNGKey(seed), d, h, kv, dh)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), torch.device("cpu"))


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (8, 0.0), (None, 30.0)])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
def test_attention_vs_jax(h, kv, window, softcap):
    """A nonzero soft-cap goes into the flash attention, as JAX's goes into
    ``sdpa_chunked`` (gemma2-2b sets one)."""
    d, dh, s = 64, 16, 40
    jp, tp = _params(h + kv, d, h, kv, dh)
    x = np.random.default_rng(4).standard_normal((2, s, d)).astype(np.float32)
    kw = dict(num_heads=h, num_kv=kv, head_dim=dh, rope_theta=50000.0,
              window=window, softcap_val=softcap)
    want = jattn.attention(jp, jnp.asarray(x), positions=jnp.arange(s),
                           q_chunk=16, kv_chunk=16, **kw)
    got = attn.attention(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("lens", [[3, 0, 7], 5])
def test_attention_decode_vs_jax(lens, ring):
    """Per-slot lengths ([B]) and a scalar length; ring=True wraps the
    lengths past the cache (a sliding-window layer's buffer)."""
    d, h, kv, dh, max_len, window = 64, 4, 2, 16, 8, 6
    jp, tp = _params(7, d, h, kv, dh)
    rng = np.random.default_rng(9)
    b = 3
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    ck = rng.standard_normal((b, max_len, kv, dh)).astype(np.float32)
    cv = rng.standard_normal((b, max_len, kv, dh)).astype(np.float32)
    lens = np.asarray(lens, np.int32) + (9 if ring else 0)
    kw = dict(num_heads=h, num_kv=kv, head_dim=dh, rope_theta=10000.0,
              window=window if ring else None, ring=ring)
    want_y, want_c = jattn.attention_decode(
        jp, jnp.asarray(x), jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
        jnp.asarray(lens), **kw)
    cache = attn.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    got_y, got_c = attn.attention_decode(tp, torch.from_numpy(x), cache,
                                         torch.as_tensor(lens), **kw)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c.k.numpy(), np.asarray(want_c.k), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_c.v.numpy(), np.asarray(want_c.v), rtol=1e-6, atol=1e-6)
