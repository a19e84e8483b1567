"""Parity of the port's Multi-head Latent Attention with the JAX package's,
on the CPU, at deepseek-v2-lite's reduced geometry (4 heads, kv_lora 32,
qk_nope 16, qk_rope 8, v_head 16).

The same weights (JAX ``mla_params`` carried over through numpy) and the
same seeded inputs go through both packages.  ``mla_attention`` (the
prefill, V padded to the qk head dim through the plain flash attention)
and ``mla_decode`` (the absorbed form, with a scalar and with a per-slot
``cache_len``, one slot past the cache) must match within rtol = atol =
1e-5 in float32, and the caches they write must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deepseek_v2_lite_16b import REDUCED as JCFG
from repro.models import mla as jmla
from repro_torch.interop import tree_from_numpy
from repro_torch.models import mla

CPU = torch.device("cpu")
GEOM = dict(num_heads=JCFG.num_heads, qk_nope=JCFG.qk_nope_dim,
            qk_rope=JCFG.qk_rope_dim, v_head=JCFG.v_head_dim, rope_theta=10000.0)


def _params(seed):
    jp = jmla.mla_params(jax.random.PRNGKey(seed), JCFG.d_model, JCFG.num_heads,
                         JCFG.kv_lora_rank, JCFG.qk_nope_dim, JCFG.qk_rope_dim,
                         JCFG.v_head_dim)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def test_mla_params_layout_matches_jax():
    jp, _ = _params(0)
    gen = torch.Generator().manual_seed(0)
    tp = mla.mla_params(gen, JCFG.d_model, JCFG.num_heads, JCFG.kv_lora_rank,
                        JCFG.qk_nope_dim, JCFG.qk_rope_dim, JCFG.v_head_dim)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda a: a.shape, jp))[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: tuple(t.shape), tp))[0]
    assert got == want


@pytest.mark.parametrize("b,s", [(2, 40), (1, 7)])
def test_mla_attention_vs_jax(b, s):
    jp, tp = _params(s)
    x = np.random.default_rng(s).standard_normal((b, s, JCFG.d_model)).astype(np.float32)
    want = jmla.mla_attention(jp, jnp.asarray(x), positions=jnp.arange(s),
                              q_chunk=16, kv_chunk=16, **GEOM)
    got = mla.mla_attention(tp, torch.from_numpy(x), **GEOM)
    assert got.shape == (b, s, JCFG.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lens", [5, [3, 0, 7], [2, 9, 4]],
                         ids=["scalar", "per_slot", "per_slot_past_cache"])
def test_mla_decode_vs_jax(lens):
    """A scalar length and per-slot lengths over a seeded cache of 8; in the
    last case one slot's length is past the cache (its write is dropped,
    as ``.at[].set`` drops it)."""
    jp, tp = _params(3)
    rng = np.random.default_rng(11)
    b, max_len = 3, 8
    x = rng.standard_normal((b, 1, JCFG.d_model)).astype(np.float32)
    c_kv = rng.standard_normal((b, max_len, JCFG.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((b, max_len, JCFG.qk_rope_dim)).astype(np.float32)
    n = np.asarray(lens, np.int32)
    want_y, want_c = jmla.mla_decode(
        jp, jnp.asarray(x), jmla.MLACache(jnp.asarray(c_kv), jnp.asarray(k_rope)),
        jnp.asarray(n), **GEOM)
    cache = mla.MLACache(torch.from_numpy(c_kv.copy()), torch.from_numpy(k_rope.copy()))
    got_y, got_c = mla.mla_decode(tp, torch.from_numpy(x), cache, torch.as_tensor(n),
                                  **GEOM)
    assert got_c.c_kv.data_ptr() == cache.c_kv.data_ptr()      # written in place
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c.c_kv.numpy(), np.asarray(want_c.c_kv),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c.k_rope.numpy(), np.asarray(want_c.k_rope),
                               rtol=1e-5, atol=1e-5)


def test_mla_decode_continues_prefill():
    """Decoding a sequence token by token from an empty cache gives the
    prefill's outputs position by position: the absorbed form computes
    the expanded one."""
    _, tp = _params(5)
    s = 6
    x = np.random.default_rng(2).standard_normal((2, s, JCFG.d_model)).astype(np.float32)
    full = mla.mla_attention(tp, torch.from_numpy(x), **GEOM)
    cache = mla.init_mla_cache(2, s, JCFG.kv_lora_rank, JCFG.qk_rope_dim,
                               torch.float32, CPU)
    steps = []
    for i in range(s):
        y, cache = mla.mla_decode(tp, torch.from_numpy(x[:, i:i + 1]), cache, i, **GEOM)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
