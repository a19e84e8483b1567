"""Parity of the port's apps and hashes (``repro_torch.apps``) with the JAX
package: hashes on keys with the high bit set, the exact integer clz of
HLL (including rest == 0), each app's PrePE ``pre`` on the same chunk, and
the numpy oracles.  Everything here is integer and must match bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import hashes as jhashes
from repro.apps import hhd as jhhd
from repro.apps import histo as jhisto
from repro.apps import hll as jhll
from repro_torch.apps import hashes, hhd, histo, hll


def _keys(n=4096, seed=0):
    """int32 keys spanning the whole range, high bit set included."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    keys[:6] = [0, 1, -1, 2**31 - 1, -2**31, 0x7F4A7C15]
    return keys


def _fmix32_inverse(h: int) -> int:
    """The key whose murmur3 fmix32 is ``h`` (fmix32 is a bijection)."""
    m = 0xFFFFFFFF
    h ^= h >> 16
    h = (h * pow(0xC2B2AE35, -1, 2**32)) & m
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 2**32)) & m
    return h ^ (h >> 16)


@pytest.mark.parametrize("seed", [0, 0x9E3779B9, 0xD6E8FEB8])
def test_murmur3_vs_jax_and_numpy(seed):
    keys = _keys()
    got = hashes.murmur3_fmix32(torch.from_numpy(keys), seed=seed).numpy()
    want = np.asarray(jhashes.murmur3_fmix32(jnp.asarray(keys), seed=seed))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(hashes.murmur3_fmix32_np(keys, seed),
                                  jhashes.murmur3_fmix32_np(keys, seed))


def test_radix_vs_jax():
    keys = _keys()
    np.testing.assert_array_equal(hashes.radix(torch.from_numpy(keys), 7).numpy(),
                                  np.asarray(jhashes.radix(jnp.asarray(keys), 7)))
    np.testing.assert_array_equal(hashes.radix_np(keys, 7), jhashes.radix_np(keys, 7))


def test_clz32_exact_vs_lax_clz():
    edges = [0, 1, 2, 3, 2**31 - 1, 2**31, 2**32 - 1]
    edges += [v + d for k in range(32) for v in (1 << k,) for d in (-1, 0, 1)
              if 0 <= v + d < 2**32]
    x = np.array(edges + list(np.random.default_rng(1).integers(0, 2**32, 2000)),
                 np.uint32)
    got = hashes.clz32(torch.from_numpy(x.astype(np.int64))).numpy()
    want = np.asarray(jax.lax.clz(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_hll_rho_when_rest_is_zero():
    """Keys whose hash has all 32-P high bits clear: clz(0) = 32 gives
    rho = 33 - P in both packages and in the oracle."""
    p = 12
    keys = np.array([_fmix32_inverse(r) for r in (0, 5, (1 << p) - 1)],
                    np.uint32).view(np.int32)
    assert (jhashes.murmur3_fmix32_np(keys) >> p == 0).all()
    chunk = np.stack([keys, np.zeros_like(keys)], axis=1)
    _, _, rho = hll.make_spec(p, 16).pre(torch.from_numpy(chunk), 16)
    _, _, jrho = jhll.make_spec(p, 16).pre(jnp.asarray(chunk), 16)
    assert rho.tolist() == [33 - p] * 3
    np.testing.assert_array_equal(rho.numpy(), np.asarray(jrho))
    assert set(hll.oracle(keys, p, 16).ravel()) <= {0, 33 - p}


APPS = {
    "histo": (lambda m: histo.make_spec(64, 1 << 16, m),
              lambda m: jhisto.make_spec(64, 1 << 16, m)),
    "hll": (lambda m: hll.make_spec(8, m), lambda m: jhll.make_spec(8, m)),
    "hhd": (lambda m: hhd.make_spec(4, 128, m), lambda m: jhhd.make_spec(4, 128, m)),
}


@pytest.mark.parametrize("app", list(APPS))
def test_pre_vs_jax(app):
    mk, jmk = APPS[app]
    keys = _keys(seed=3)
    if app == "histo":               # HISTO keys live in its domain
        keys = np.abs(keys.astype(np.int64) % (1 << 16)).astype(np.int32)
    chunk = np.stack([keys, np.arange(len(keys), dtype=np.int32)], axis=1)
    out = mk(8).pre(torch.from_numpy(chunk), 8)
    jout = jmk(8).pre(jnp.asarray(chunk), 8)
    for got, want in zip(out, jout):
        want = np.asarray(want)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    spec, jspec = mk(8), jmk(8)
    assert (spec.combine, spec.tuple_bytes, spec.ii_pre, spec.ii_pe) == \
        (jspec.combine, jspec.tuple_bytes, jspec.ii_pre, jspec.ii_pe)
    buf = spec.init_buffer(11, torch.device("cpu"))
    jbuf = jspec.init_buffer(11)
    assert tuple(buf.shape) == jbuf.shape and buf.dtype == torch.int32


def test_oracles_match_reference():
    keys = np.random.default_rng(4).integers(0, 1 << 16, 3000).astype(np.int32)
    np.testing.assert_array_equal(histo.oracle(keys, 64, 1 << 16, 8),
                                  jhisto.oracle(keys, 64, 1 << 16, 8))
    np.testing.assert_array_equal(hll.oracle(keys, 8, 8), jhll.oracle(keys, 8, 8))
    np.testing.assert_array_equal(hhd.oracle(keys, 4, 128, 8),
                                  jhhd.oracle(keys, 4, 128, 8))
