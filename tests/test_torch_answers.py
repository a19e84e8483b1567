"""The answers the port computes from a run's state, held against the JAX
package on the CPU: HLL's cardinality, HHD's point query and heavy
hitters, the perf model's yardsticks, the public op API of
``repro_torch.kernels.ops`` (the plain versions; the CUDA branch is in
tests/test_torch_cuda.py), and ``ArchConfig.moe_capacity``/``has``.

Integers must match bit for bit, HLL's float64 estimate and the perf
model's float32 values exactly, the MoE pack and unpack exactly (each
packed cell takes at most one tuple, so no sum is reordered), float sums
of ``scatter_accumulate`` within rtol 1e-6 (index_add_ and XLA's scatter
add in different orders) and flash attention within atol 1e-5.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import hhd as jhhd
from repro.apps import hll as jhll
from repro.core import perfmodel as jperf
from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro_torch import configs
from repro_torch.apps import hhd, hll
from repro_torch.core import Ditto, perfmodel
from repro_torch.data.zipf import zipf_tuples
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops

M = 16


def _port_run(spec, data, chunk=256):
    """Merged buffers of a port run of ``data`` at Ditto's X, on the CPU."""
    d = Ditto(spec, chunk_size=chunk, device="cpu")
    merged, _ = d.build(data[:, 0]).run(d.chunk(data))
    return merged


# ---------------------------------------------------------------- HLL
@pytest.mark.parametrize("p_bits", [4, 6, 7, 12])
@pytest.mark.parametrize("n_keys", [10, 300, 50000])
def test_hll_estimate_equals_jax_on_oracle_registers(p_bits, n_keys):
    """p = 4, 6 hit the small-m alpha table, 7 and 12 the formula; few keys
    leave zero registers (the linear-counting branch)."""
    keys = np.random.default_rng(n_keys).integers(0, 1 << 30, n_keys)
    merged = hll.oracle(keys, p_bits, M)
    want = jhll.estimate(merged, p_bits)
    assert hll.estimate(merged, p_bits) == want
    assert hll.estimate(torch.as_tensor(merged), p_bits) == want


@pytest.mark.parametrize("p_bits", [4, 6, 7, 12])
def test_hll_estimate_equals_jax_on_a_port_run(p_bits):
    data = zipf_tuples(4096, 1 << 20, 1.5, seed=p_bits)
    merged = _port_run(hll.make_spec(p_bits, M), data)
    np.testing.assert_array_equal(merged.numpy(), hll.oracle(data[:, 0], p_bits, M))
    assert hll.estimate(merged, p_bits) == jhll.estimate(merged.numpy(), p_bits)


def test_hll_estimate_accuracy():
    keys = np.random.default_rng(0).integers(0, 1 << 30, 50000)
    true_card = len(np.unique(keys))
    est = hll.estimate(hll.oracle(keys, 12, M), 12)
    assert abs(est - true_card) / true_card < 0.05   # ~1.04/sqrt(2^12)=1.6%


# ---------------------------------------------------------------- HHD
def _hhd_case(seed):
    data = zipf_tuples(8192, 10000, 2.0, seed=seed)
    return data, np.unique(data[:, 0])


@pytest.mark.parametrize("source", ["oracle", "port_run"])
def test_hhd_estimate_and_heavy_hitters_equal_jax(source):
    data, cand = _hhd_case(3)
    if source == "oracle":
        merged = hhd.oracle(data[:, 0], 4, 1024, M)             # int64
        merged_np = merged
    else:
        merged = _port_run(hhd.make_spec(4, 1024, M), data)    # int32 tensor
        merged_np = merged.numpy()
        np.testing.assert_array_equal(merged_np, hhd.oracle(data[:, 0], 4, 1024, M))
    keys = np.concatenate([cand, np.array([-1, 2**31 - 1, -2**31], np.int64)])
    got = hhd.estimate(merged, keys, 4, 1024)
    want = jhhd.estimate(merged_np, keys, 4, 1024)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    for thr in (1, 50, 100, 10**6):
        got = hhd.heavy_hitters(merged, cand, 4, 1024, thr)
        np.testing.assert_array_equal(got.numpy(),
                                      jhhd.heavy_hitters(merged_np, cand, 4, 1024, thr))


def test_hhd_recall_is_one():
    """tests/test_apps.py's case: every key counted at least the threshold
    is reported."""
    data = zipf_tuples(8192, 10000, 2.0, seed=3)
    keys = data[:, 0]
    merged = hhd.oracle(keys, 4, 1024, 8)
    thr = 100
    true_counts = np.bincount(keys, minlength=10000)
    true_hh = np.where(true_counts >= thr)[0]
    cand = np.unique(keys)
    found = hhd.heavy_hitters(merged, cand, 4, 1024, thr)
    assert len(true_hh) and set(true_hh).issubset(set(found.tolist()))


# ---------------------------------------------------------------- perf model
CHUNKS = [0, 1, 7, 256, 4096, (1 << 16) + 777, 3 * 2**22]
CYCLES = np.array([0.0, 0.25, 0.999, 1.0, 1.5, 3.0, 255.0, 4096.0, 1e6 / 3,
                   2**24 + 1.0, float("inf")], np.float32)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_perfmodel_throughput_bit_equal(chunk):
    got = perfmodel.throughput(chunk, torch.from_numpy(CYCLES))
    want = np.asarray(jperf.throughput(chunk, jnp.asarray(CYCLES)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for c in (0.5, 3, 1000.0):                 # cycles as a Python number
        assert (perfmodel.throughput(chunk, c).numpy()
                == np.asarray(jperf.throughput(chunk, c))).all()


@pytest.mark.parametrize("chunk", CHUNKS)
def test_perfmodel_uniform_cycles_bit_equal(chunk):
    for w in (1, 3, 7, 8, 16, 100):
        got = perfmodel.uniform_cycles(chunk, w)
        want = np.asarray(jperf.uniform_cycles(chunk, w))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert got.numpy() == want
    batch = np.array(CHUNKS, np.int32)
    np.testing.assert_array_equal(perfmodel.uniform_cycles(torch.from_numpy(batch), 3).numpy(),
                                  np.asarray(jperf.uniform_cycles(jnp.asarray(batch), 3)))


def test_perfmodel_reschedule_overhead_cycles_equal():
    assert perfmodel.reschedule_overhead_cycles() == jperf.reschedule_overhead_cycles()
    for f, ms in ((100.0, 0.5), (250.0, 2.0), (300, 1)):
        got = perfmodel.reschedule_overhead_cycles(f, ms)
        assert isinstance(got, float)
        assert got == jperf.reschedule_overhead_cycles(f, ms)


# ---------------------------------------------------------------- kernels/ops
def _assert_same(got, want, exact=True):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("combine", ["add", "max"])
def test_ops_scatter_accumulate_equals_jax(combine, dtype):
    rng = np.random.default_rng(0)
    bins = 96
    idx = rng.integers(-5, bins + 5, 1000).astype(np.int32)
    idx[:4] = [-1, bins, -bins, 2**31 - 1]                   # dropped
    val = (rng.integers(-100, 100, 1000) if dtype == np.int32
           else rng.standard_normal(1000)).astype(dtype)
    got = ops.scatter_accumulate(torch.from_numpy(idx), torch.from_numpy(val), bins, combine)
    want = jops.scatter_accumulate(jnp.asarray(idx), jnp.asarray(val), bins, combine,
                                   use_kernel=False)
    _assert_same(got, want, exact=dtype == np.int32 or combine == "max")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_ops_cms_update_equals_jax(dtype):
    rng = np.random.default_rng(1)
    num_pe, depth, width, t = 6, 4, 128, 700
    eff = rng.integers(0, num_pe, t).astype(np.int32)
    eff[::7] = -1                                            # padding
    eff[3::11] = num_pe                                      # the masked sentinel
    cols = rng.integers(0, width, (t, depth)).astype(np.int32)
    val = rng.integers(1, 5, t).astype(dtype)
    got = ops.cms_update(torch.from_numpy(eff), torch.from_numpy(cols),
                         torch.from_numpy(val), num_pe, depth, width)
    want = jops.cms_update(jnp.asarray(eff), jnp.asarray(cols), jnp.asarray(val),
                           num_pe, depth, width, use_kernel=False)
    _assert_same(got, want)          # small integer values: float sums are exact


def _moe_case(seed, t=300, num_pe=8, capacity=24, d=32):
    rng = np.random.default_rng(seed)
    eff = rng.integers(0, num_pe, t).astype(np.int32)
    eff[::13] = -1                                           # dropped tuples
    eff[5::17] = num_pe
    slot = np.asarray(jops.occurrence_rank(jnp.asarray(eff), num_pe)).astype(np.int32)
    values = rng.standard_normal((t, d)).astype(np.float32)
    gate = rng.random(t).astype(np.float32)
    return eff, slot, values, gate, num_pe, capacity


def test_ops_onehot_dispatch_equals_jax():
    eff, slot, values, _, num_pe, cap = _moe_case(2)
    assert (slot >= cap).any()                               # overflow dropped
    got = ops.onehot_dispatch(torch.from_numpy(eff), torch.from_numpy(slot),
                              torch.from_numpy(values), num_pe, cap)
    want = jops.onehot_dispatch(jnp.asarray(eff), jnp.asarray(slot), jnp.asarray(values),
                                num_pe, cap, use_kernel=False)
    _assert_same(got, want)


@pytest.mark.parametrize("with_gate", [False, True])
def test_ops_onehot_combine_equals_jax(with_gate):
    eff, slot, values, gate, num_pe, cap = _moe_case(3)
    packed = np.random.default_rng(4).standard_normal((num_pe, cap, values.shape[1]))
    packed = packed.astype(np.float32)
    g = gate if with_gate else None
    got = ops.onehot_combine(torch.from_numpy(eff), torch.from_numpy(slot),
                             torch.from_numpy(packed),
                             None if g is None else torch.from_numpy(g))
    want = jops.onehot_combine(jnp.asarray(eff), jnp.asarray(slot), jnp.asarray(packed),
                               None if g is None else jnp.asarray(g), use_kernel=False)
    _assert_same(got, want)


@pytest.mark.parametrize("causal, window, heads, kv_heads", [
    (True, 0, 4, 4), (False, 0, 4, 4), (True, 16, 4, 4), (True, 0, 8, 2), (True, 24, 6, 2)])
def test_ops_flash_attention_equals_jax(causal, window, heads, kv_heads):
    rng = np.random.default_rng(5)
    b, s, dh = 2, 64, 32
    q = rng.standard_normal((b, s, heads, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv_heads, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv_heads, dh)).astype(np.float32)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              window=window)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, use_kernel=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_ops_occurrence_rank_equals_jax():
    eff = np.random.default_rng(6).integers(-1, 9, 500).astype(np.int32)
    got = ops.occurrence_rank(torch.from_numpy(eff)[None], 8)[0]
    want = jops.occurrence_rank(jnp.asarray(eff), 8)
    valid = (eff >= 0) & (eff < 8)
    np.testing.assert_array_equal(got.numpy()[valid], np.asarray(want)[valid])


def test_flash_neg_inf_equals_jax():
    assert flash.NEG_INF == jflash.NEG_INF


# ---------------------------------------------------------------- ArchConfig
KINDS = ("attn", "attn_local", "attn_nocausal", "mla", "mamba", "dense", "moe", "none")


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_arch_config_methods_equal_jax(arch, which):
    got = getattr(importlib.import_module(f"repro_torch.configs.{arch}"), which)
    want = getattr(importlib.import_module(f"repro.configs.{arch}"), which)
    assert [got.has(k) for k in KINDS] == [want.has(k) for k in KINDS]
    try:
        cap = want.moe_capacity()
    except ZeroDivisionError:            # no experts: JAX divides by zero
        with pytest.raises(ZeroDivisionError):
            got.moe_capacity()
    else:
        assert got.moe_capacity() == cap
