"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  The kernels have no CPU mode, so every test here carries the
``cuda`` marker and skips without a CUDA device.  This file imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer results and float ``max`` must be bit-exact; float ``add`` may
differ by the order of the atomic adds (rtol = atol = 1e-5).
"""
import numpy as np
import pytest
import torch

from repro_torch.apps import hhd, histo, hll
from repro_torch.core import Ditto
from repro_torch.data.zipf import zipf_tuples
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.cms_update import cms_update
from repro_torch.kernels.route_accumulate import route_accumulate

DTYPES = {"int32": torch.int32, "float32": torch.float32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _values(rng, n, dtype, signed=True):
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-100 if signed else 0, 100, n).astype(np.int32))
    v = rng.standard_normal(n) if signed else rng.random(n)
    return torch.from_numpy(v.astype(np.float32))


def _assert_same(got, want, exact):
    torch.cuda.synchronize()
    if exact:
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("combine", ["add", "max"])
@pytest.mark.parametrize("num_pe,local", [(31, 256), (31, 32), (1, 1 << 20)])
def test_route_accumulate_vs_plain(cuda_device, num_pe, local, combine, dtype):
    """HLL- and HISTO-sized buffers (31 x 256, 31 x 32) and 2^20 bins; -1
    padding, the sentinel eff = num_pe and negative values under max."""
    rng = np.random.default_rng(num_pe * local)
    t = 4096
    buffers = _values(rng, num_pe * local, dtype).view(num_pe, local)
    eff = torch.from_numpy(rng.integers(-1, num_pe + 1, t).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-1, local + 1, t).astype(np.int32))
    val = _values(rng, t, dtype)
    want = ref.pe_buffer_update(buffers.clone(), eff, idx, val, combine)
    before = route_accumulate.launches
    got = dispatch.pe_buffer_update(buffers.to(cuda_device), eff.to(cuda_device),
                                    idx.to(cuda_device), val.to(cuda_device), combine)
    assert route_accumulate.launches == before + 1
    _assert_same(got, want, exact=dtype == "int32" or combine == "max")


@pytest.mark.cuda
def test_route_accumulate_single_hot_cell(cuda_device):
    """Zipf alpha=3-like contention: every tuple hits one cell."""
    t = 1 << 16
    buf = torch.zeros((16, 32), dtype=torch.int32, device=cuda_device)
    one = torch.ones(t, dtype=torch.int32, device=cuda_device)
    route_accumulate(buf, one * 3, one * 7, one, "add")
    torch.cuda.synchronize()
    assert int(buf[3, 7]) == t and int(buf.sum()) == t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cms_update_vs_plain(cuda_device, dtype):
    rng = np.random.default_rng(3)
    t, pe, d, w = 4096, 31, 4, 1024
    eff = torch.from_numpy(rng.integers(-1, pe + 1, t).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, w, (t, d)).astype(np.int32))
    val = _values(rng, t, dtype, signed=False)
    sketch = torch.zeros((pe, d, w), dtype=DTYPES[dtype])
    want = ref.cms_update(sketch.clone(), eff, cols, val)
    before = cms_update.launches
    got = dispatch.cms_update(sketch.to(cuda_device), eff.to(cuda_device),
                              cols.to(cuda_device), val.to(cuda_device))
    assert cms_update.launches == before + 1
    _assert_same(got, want, exact=dtype == "int32")


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["histo", "hll", "hhd"])
def test_executor_on_card_matches_cpu_and_oracle(cuda_device, app):
    """A short stream through Ditto on the card and on the CPU: the same X,
    the same merged buffers (equal to the oracle) and the same stats."""
    specs = {"histo": (histo.make_spec(512, 1 << 20, 16), lambda k: histo.oracle(k, 512, 1 << 20, 16)),
             "hll": (hll.make_spec(12, 16), lambda k: hll.oracle(k, 12, 16)),
             "hhd": (hhd.make_spec(4, 1024, 16), lambda k: hhd.oracle(k, 4, 1024, 16))}
    spec, oracle = specs[app]
    tuples = zipf_tuples(4096 * 16 + 123, 1 << 20, 2.0, seed=7)
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        d = Ditto(spec, chunk_size=4096, device=device)
        impl = d.build(tuples[:, 0])
        chunks, mask = d.chunk_masked(tuples)
        merged, stats = impl.run(chunks, mask=mask)
        outs.append((impl.num_sec, merged.cpu(), stats))
    (x_gpu, m_gpu, s_gpu), (x_cpu, m_cpu, s_cpu) = outs
    assert x_gpu == x_cpu
    assert torch.equal(m_gpu, m_cpu)
    np.testing.assert_array_equal(m_cpu.numpy(), oracle(tuples[:, 0]))
    for field in ("max_load", "modeled_cycles", "mode", "rescheduled", "workload"):
        assert torch.equal(getattr(s_gpu, field).cpu(), getattr(s_cpu, field)), field
