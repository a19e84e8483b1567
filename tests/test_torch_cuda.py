"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  The kernels have no CPU mode, so every test of a kernel here
carries the ``cuda`` marker and skips without a CUDA device; only the tests
of the backward check's own power to fail run on the CPU.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer results and float ``max`` must be bit-exact; float ``add`` may
differ by the order of the atomic adds (rtol = atol = 1e-5).  The MoE pack
and unpack are exact on unique cells.  Where duplicate cells sum, the
atomics and ``index_add_`` round each partial sum in another order, so a
cell's error scales with the sum of |x| that went into it, not with the
result: |got - want| <= tol * (1 + that sum), cell by cell, with tol 1e-5
(float32) or 2e-2 (bfloat16).  Flash attention within 1e-5 (float32) or
2e-2 (bfloat16), as in tests/test_kernels.py; the bfloat16 kernel also
rounds the probabilities to bf16 before P @ V, which that tolerance covers.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.apps import hhd, histo, hll
from repro_torch.core import Ditto
from repro_torch.data.zipf import zipf_tuples
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.cms_update import cms_update
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_onehot import onehot_combine, onehot_dispatch
from repro_torch.kernels.route_accumulate import route_accumulate

DTYPES = {"int32": torch.int32, "float32": torch.float32}
FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
@pytest.mark.parametrize("case", ["random", "one_key", "depth3", "depth5"])
def test_cms_update_vs_plain(cuda_device, case, dtype):
    """HHD's shape with -1 padding and the sentinel eff = num_pe (random);
    a chunk whose tuples all carry one key, so every lane of a warp adds
    to the same cells (one_key; integer values, so float sums are exact in
    any order); and depths 3 and 5, which take the kernel's column loop in
    place of its 16-byte load."""
    rng = np.random.default_rng(3)
    t, pe, w = 4096, 31, 1024
    d = {"depth3": 3, "depth5": 5}.get(case, 4)
    eff = torch.from_numpy(rng.integers(-1, pe + 1, t).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, w, (t, d)).astype(np.int32))
    val = _values(rng, t, dtype, signed=False)
    if case == "one_key":
        eff[:] = 7
        cols[:] = cols[0]
        val = torch.from_numpy(rng.integers(0, 100, t)).to(DTYPES[dtype])
    sketch = torch.zeros((pe, d, w), dtype=DTYPES[dtype])
    want = ref.cms_update(sketch.clone(), eff, cols, val)
    before = cms_update.launches
    got = dispatch.cms_update(sketch.to(cuda_device), eff.to(cuda_device),
                              cols.to(cuda_device), val.to(cuda_device))
    assert cms_update.launches == before + 1
    _assert_same(got, want, exact=dtype == "int32" or case == "one_key")


@pytest.mark.cuda
def test_cms_update_launches_on_the_current_stream(cuda_device):
    """Captured into a CUDA graph (which records only the capturing
    stream's work), the update runs once per replay."""
    rng = np.random.default_rng(5)
    t, pe, d, w = 4096, 31, 4, 1024
    eff = torch.from_numpy(rng.integers(-1, pe + 1, t).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, w, (t, d)).astype(np.int32))
    val = torch.ones(t, dtype=torch.int32)
    want = ref.cms_update(torch.zeros((pe, d, w), dtype=torch.int32), eff, cols, val)
    sketch = torch.zeros((pe, d, w), dtype=torch.int32, device=cuda_device)
    eff, cols, val = eff.to(cuda_device), cols.to(cuda_device), val.to(cuda_device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cms_update(sketch, eff, cols, val)
    torch.cuda.synchronize()
    assert int(sketch.abs().sum()) == 0
    graph.replay()
    graph.replay()
    _assert_same(sketch, 2 * want, exact=True)


@pytest.mark.cuda
def test_cms_update_raises_on_what_it_does_not_take(cuda_device):
    """Without the dispatch layer's conversions, a wrong dtype, device,
    shape or layout reaches the wrapper, which raises; nothing launches."""
    sketch = torch.zeros((3, 4, 16), dtype=torch.int32, device=cuda_device)
    eff = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    cols = torch.zeros((8, 4), dtype=torch.int32, device=cuda_device)
    val = torch.ones(8, dtype=torch.int32, device=cuda_device)
    before = cms_update.launches
    with pytest.raises(ValueError, match="eff must be"):
        dispatch.cms_update(sketch, eff.long(), cols, val)
    with pytest.raises(ValueError, match="cols must be"):
        cms_update(sketch, eff, cols[:, :3], val)
    with pytest.raises(ValueError, match="value must be"):
        cms_update(sketch, eff, cols, val.float())
    with pytest.raises(ValueError, match="value must be"):
        cms_update(sketch, eff, cols, val.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        cms_update(sketch, eff, cols.t().contiguous().t(), val)
    with pytest.raises(ValueError, match="3-D"):
        cms_update(sketch[0], eff, cols, val)
    with pytest.raises(ValueError, match="CUDA"):
        cms_update(sketch.cpu(), eff, cols, val)
    assert cms_update.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["add", "max"])
def test_route_accumulate_launches_on_the_current_stream(cuda_device, combine):
    """Captured into a CUDA graph (which records only the capturing
    stream's work), the update runs once per replay."""
    rng = np.random.default_rng(6)
    t, pe, local = 4096, 31, 256
    eff = torch.from_numpy(rng.integers(-1, pe + 1, t).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-1, local + 1, t).astype(np.int32))
    val = torch.from_numpy(rng.integers(1, 100, t).astype(np.int32))
    want = ref.pe_buffer_update(torch.zeros((pe, local), dtype=torch.int32), eff, idx,
                                val, combine)
    buf = torch.zeros((pe, local), dtype=torch.int32, device=cuda_device)
    eff, idx, val = eff.to(cuda_device), idx.to(cuda_device), val.to(cuda_device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        route_accumulate(buf, eff, idx, val, combine)
    torch.cuda.synchronize()
    assert int(buf.abs().sum()) == 0
    graph.replay()
    graph.replay()
    _assert_same(buf, 2 * want if combine == "add" else want, exact=True)


@pytest.mark.cuda
def test_route_accumulate_raises_on_what_it_does_not_take(cuda_device):
    """The extension module refuses a wrong dtype, device, shape or layout
    and the wrapper raises with its message; an empty chunk is taken and
    launches nothing."""
    buf = torch.zeros((3, 16), dtype=torch.int32, device=cuda_device)
    i = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    val = torch.ones(8, dtype=torch.int32, device=cuda_device)
    before = route_accumulate.launches
    with pytest.raises(ValueError, match="eff must be"):
        dispatch.pe_buffer_update(buf, i.long(), i, val, "add")
    with pytest.raises(ValueError, match="idx must be"):
        route_accumulate(buf, i, i[:7], val, "add")
    with pytest.raises(ValueError, match="value must be"):
        route_accumulate(buf, i, i, val.float(), "max")
    with pytest.raises(ValueError, match="value must be"):
        route_accumulate(buf, i, i, val.cpu(), "add")
    with pytest.raises(ValueError, match="idx must be"):
        route_accumulate(buf, i, i[:, None], val, "add")
    with pytest.raises(ValueError, match="contiguous"):
        route_accumulate(buf, i[::2], i[::2], val[::2], "add")
    with pytest.raises(ValueError, match="contiguous"):
        route_accumulate(buf.t(), i, i, val, "add")
    with pytest.raises(ValueError, match="2-D"):
        route_accumulate(buf[0], i, i, val, "add")
    with pytest.raises(ValueError, match="2-D"):
        route_accumulate(buf.double(), i, i, val.double(), "add")
    with pytest.raises(ValueError, match="CUDA"):
        route_accumulate(buf.cpu(), i.cpu(), i.cpu(), val.cpu(), "add")
    with pytest.raises(ValueError, match="combine"):
        route_accumulate(buf, i, i, val, "min")
    assert route_accumulate.launches == before
    assert route_accumulate(buf, i[:0], i[:0], val[:0], "add") is buf
    torch.cuda.synchronize()
    assert route_accumulate.launches == before and int(buf.abs().sum()) == 0


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


def _leaves(obj, prefix=""):
    """{path: CPU tensor} over an ExecState / ExecStats."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_leaves(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: obj.cpu()}


def _assert_tree_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert got[key].dtype == val.dtype and torch.equal(got[key], val), key


def _sweep_lanes(cuda_device, chunks):
    """The benchmark's step shape at a few chunks: six lanes at Zipf alpha
    0-3, M = 16, X = 14, chunks of 4096; a resumable executor with spans."""
    from repro_torch import obs as obs_lib
    from repro_torch.core import executor
    o = obs_lib.Observability()
    res = executor.make_resumable_executor(histo.make_spec(512, 1 << 20, 16), 16, 14, 4096,
                                           device=cuda_device, obs=o)
    tuples = np.stack([zipf_tuples(4096 * chunks, 1 << 20, a, seed=40 + i)
                       for i, a in enumerate((0.0, 0.5, 1.0, 1.5, 2.0, 3.0))])
    tuples = torch.as_tensor(tuples).view(6, chunks, 4096, 2).to(cuda_device)
    return res, executor.stack_states(res.init_state(), 6), tuples, o


def _plan_spans(o) -> int:
    n = sum(e["name"] == "executor.plan" for e in o.tracer.events())
    o.tracer.clear()
    return n


@pytest.mark.cuda
def test_settled_steps_add_no_host_sync_and_equal_the_full_step(cuda_device):
    """A lane-batched run with its chunks on the card and no mask: every
    step past the first is settled (one ``executor.plan`` span), the run
    makes no host sync (sync debug mode "error" raises on one), and its
    state and stats equal those of the full step called directly, bit for
    bit."""
    from repro_torch.core import executor
    res, states, tuples, o = _sweep_lanes(cuda_device, 6)
    res.scan_lanes(states, tuples[:, :2])          # the kernel's build, the shapes
    torch.cuda.synchronize()
    _plan_spans(o)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, stats = res.scan_lanes(states, tuples)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _plan_spans(o) == 1
    state, full = states.clone(), []
    for k in range(tuples.shape[1]):
        state, s = res.step(state, tuples[:, k])
        full.append(s)
    assert _plan_spans(o) == tuples.shape[1]
    _assert_tree_equal(got, state)
    _assert_tree_equal(stats, executor._stack_stats(full, state, 16))


@pytest.mark.cuda
def test_a_mask_on_the_card_runs_the_full_step(cuda_device):
    """A mask already on the card gives the loops no host facts: every step
    is full, with the results of the same mask passed from the host (whose
    steps past the first settle)."""
    res, states, tuples, o = _sweep_lanes(cuda_device, 4)
    mask = np.ones(tuples.shape[:3], bool)
    mask[5] = False                                # a pad lane
    mask[0, -1, 1000:] = False                     # a ragged tail
    on_card, on_card_stats = res.scan_lanes(states, tuples,
                                            torch.as_tensor(mask).to(cuda_device))
    assert _plan_spans(o) == tuples.shape[1]
    host, host_stats = res.scan_lanes(states, tuples, mask)
    assert _plan_spans(o) == 1
    _assert_tree_equal(on_card, host)
    _assert_tree_equal(on_card_stats, host_stats)


def _moe_cells(rng, g, t, pe, cap, unique, device):
    """eff, slot [G, T] int32 on ``device``: occurrence-rank slots (unique
    cells) or random ones (duplicates), with eff = -1, eff = pe and
    slot >= cap among them (dropped)."""
    eff = torch.from_numpy(rng.integers(0, pe, (g, t)).astype(np.int32))
    slot = (ops.occurrence_rank(eff, pe) if unique
            else torch.from_numpy(rng.integers(0, cap, (g, t)).astype(np.int32)))
    drop = torch.from_numpy(rng.random((g, t)))
    eff[drop < 0.03] = -1
    eff[(drop >= 0.03) & (drop < 0.06)] = pe
    slot[(drop >= 0.06) & (drop < 0.09)] = cap + 1
    return eff.to(device), slot.to(device)


def _close(got, want, dtype, exact, magnitude=None):
    """Bit-exact, or |got - want| <= tol * (1 + ``magnitude``) element by
    element: the sum of |x| that went into each cell where duplicates sum,
    else |want| (rtol = atol = tol)."""
    torch.cuda.synchronize()
    if exact:
        assert torch.equal(got.cpu(), want.cpu())
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    want = want.float()
    err = (got.float() - want).abs()
    bound = tol * (1 + (want.abs() if magnitude is None else magnitude))
    assert bool((err <= bound).all()), \
        f"max |err| {float(err.max())}, worst err/bound {float((err / bound).max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("g,t,pe,cap,d", [(8, 3072, 72, 60, 2048), (1, 24, 72, 4, 2048),
                                          (1, 384, 72, 7, 2048), (1, 1, 72, 60, 2048),
                                          (2, 37, 5, 8, 100), (2, 37, 5, 8, 6)])
def test_onehot_dispatch_vs_plain(cuda_device, g, t, pe, cap, d, dtype, unique):
    """The prefill (8 groups of 512 tokens, top-6), decode (4 slots) and
    serving-load decode (64 slots) shapes of moonshot at full width, one
    tuple, and ragged widths (bf16 at 100 and both dtypes at 6 take the
    scalar path)."""
    rng = np.random.default_rng(g * t + d)
    eff, slot = _moe_cells(rng, g, t, pe, cap, unique, cuda_device)
    x = torch.from_numpy(rng.standard_normal((g, t, d)).astype(np.float32))
    x = x.to(cuda_device, FLOATS[dtype])
    want = ref.onehot_dispatch(eff, slot, x, pe, cap)
    before = onehot_dispatch.launches
    got = dispatch.onehot_dispatch(eff, slot, x, pe, cap)
    assert onehot_dispatch.launches == before + 1
    magnitude = ref.onehot_dispatch(eff, slot, x.float().abs(), pe, cap)
    _close(got, want, dtype, exact=unique, magnitude=magnitude)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("case", ["one_cell", "all_dropped"])
def test_onehot_dispatch_fills_every_cell(cuda_device, case, dtype):
    """Every kept tuple in one cell (a list of all T tuples, summed in
    float), and every tuple dropped (all rows zero) into memory that the
    caching allocator hands back after a NaN-filled tensor."""
    g, t, pe, cap, d = 2, 3072, 72, 60, 2048
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((g, t, d)).astype(np.float32))
    x = x.to(cuda_device, FLOATS[dtype])
    eff = torch.full((g, t), 5, dtype=torch.int32, device=cuda_device)
    slot = torch.full((g, t), 3, dtype=torch.int32, device=cuda_device)
    if case == "all_dropped":
        eff[0], slot[1] = pe, -1
    # a freed NaN-filled block of packed's size, and one of the scratch's
    # size filled with -7 (no list end), for the wrapper to be handed back
    junk = torch.full((g, pe, cap, d), float("nan"), dtype=FLOATS[dtype], device=cuda_device)
    torch.full((g * pe * cap + g * t,), -7, dtype=torch.int32, device=cuda_device)
    reused = junk.data_ptr()
    del junk
    before = onehot_dispatch.launches
    got = dispatch.onehot_dispatch(eff, slot, x, pe, cap)
    assert got.data_ptr() == reused and onehot_dispatch.launches == before + 1
    want = ref.onehot_dispatch(eff, slot, x, pe, cap)
    assert bool(want.any()) == (case == "one_cell")
    magnitude = ref.onehot_dispatch(eff, slot, x.float().abs(), pe, cap)
    _close(got, want, dtype, exact=case == "all_dropped", magnitude=magnitude)


@pytest.mark.cuda
@pytest.mark.parametrize("with_gate", [True, False])
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("g,t,pe,cap,d", [(8, 3072, 72, 60, 2048), (2, 37, 5, 8, 100)])
def test_onehot_combine_vs_plain(cuda_device, g, t, pe, cap, d, dtype, with_gate):
    rng = np.random.default_rng(g + t + d)
    eff, slot = _moe_cells(rng, g, t, pe, cap, False, cuda_device)
    packed = torch.from_numpy(rng.standard_normal((g, pe, cap, d)).astype(np.float32))
    packed = packed.to(cuda_device, FLOATS[dtype])
    gate = (torch.from_numpy(rng.random((g, t)).astype(np.float32))
            .to(cuda_device, FLOATS[dtype]) if with_gate else None)
    want = ref.onehot_combine(eff, slot, packed, gate)
    before = onehot_combine.launches
    got = dispatch.onehot_combine(eff, slot, packed, gate)
    assert onehot_combine.launches == before + 1
    _close(got, want, dtype, exact=True)


# b, sq, sk, h, kv, dh, causal, window, q_scale
FLASH_CASES = [
    (4, 1024, 1024, 16, 16, 128, True, 0, 1),    # moonshot's prefill
    (4, 1000, 1000, 16, 16, 128, True, 0, 1),
    (4, 1024, 1024, 16, 4, 128, True, 256, 1),
    (4, 1000, 1000, 16, 4, 128, True, 256, 1),
    (2, 77, 77, 4, 2, 64, True, 0, 1),
    *((2, 256, 256, 4, 4, dh, True, 0, 1) for dh in (32, 64, 128, 256)),
    *((2, s, s, 4, 1, 128, True, 0, 1) for s in (1, 17, 64, 65)),
    (2, 100, 300, 4, 4, 64, False, 0, 1),        # Sq != Sk, no mask but padding
    (2, 300, 100, 4, 2, 128, False, 0, 1),
    (2, 200, 200, 4, 4, 64, False, 50, 1),
    (2, 300, 300, 4, 1, 128, True, 40, 1),       # a window inside one key tile
    (2, 512, 512, 8, 2, 128, True, 0, 8),        # the running max moves
    (2, 65, 65, 4, 2, 50, True, 0, 1),           # dh not a multiple of 8: padded
    (2, 130, 130, 4, 2, 202, True, 0, 1),        # to 56 and to 208 (the 256 template)
    # the wgmma kernel's tiles (192 query rows in three consumer warpgroups
    # of 64 at dh 64 and 128, 128 rows in two at 192 and 256; 128 keys at
    # dh 64, 64 at 128 and 256, 96 at 192): Sq < 64 (the other warpgroups
    # idle) and 129 (a partial or second q-tile); causal with Sq < Sk, and
    # Sq > Sk under a window, where the last q-tiles keep no key and load
    # nothing; Sk off the key tile at each template; Jamba's GQA 64/8; dh 96
    # (in the 128 template) and 192
    (2, 40, 40, 4, 2, 128, True, 0, 1),
    (2, 129, 129, 4, 4, 64, True, 0, 1),
    (2, 129, 129, 4, 2, 256, True, 0, 8),
    (2, 100, 300, 4, 2, 128, True, 0, 1),
    (2, 400, 100, 4, 2, 64, True, 32, 1),
    (1, 520, 200, 4, 4, 192, True, 64, 1),
    (2, 256, 200, 4, 4, 128, False, 0, 1),
    (2, 256, 100, 4, 2, 256, False, 0, 1),
    (2, 256, 200, 4, 4, 192, False, 0, 1),
    (1, 256, 256, 64, 8, 128, True, 0, 1),
    (2, 300, 300, 4, 2, 96, True, 0, 1),
    (2, 300, 300, 4, 4, 192, True, 0, 8),
    (1, 5, 0, 2, 2, 64, False, 0, 1),            # no key: zeros, nothing loaded
]


def _keeps_no_key(sq, sk, causal, window, device):
    """[Sq] True where a query row keeps no key under the masks."""
    i = torch.arange(sq, device=device)
    hi = torch.clamp(i + 1, max=sk) if causal else torch.full_like(i, sk)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return hi <= lo


def _flash_want(q, k, v, causal, window, softcap=0.0):
    """The plain version, with 0 for rows that keep no key: the kernels
    divide by max(l, 1e-20), the plain softmax of all-masked scores is
    uniform."""
    want = ref.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    empty = _keeps_no_key(q.shape[1], k.shape[1], causal, window, q.device)
    return want.masked_fill(empty[None, :, None, None], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,q_scale", FLASH_CASES)
def test_flash_attention_vs_plain(cuda_device, b, sq, sk, h, kv, dh, causal, window,
                                  q_scale, dtype):
    """The prefill shape (B=4, S=1024, dh=128), ragged S, GQA (16/4, 4/1,
    64/8) and windows; dh 32-256; S from 1; Sq != Sk; q scaled by 8, so
    that the running max moves and the rescale of O and l runs; dh = 50
    and 202 run padded to a multiple of 8; rows that keep no key give 0.
    bfloat16 runs the wgmma kernel, float32 the CUDA cores; one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + sk + h + kv + dh)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    q, k, v = ((q * q_scale).to(FLOATS[dtype]), k.to(FLOATS[dtype]), v.to(FLOATS[dtype]))
    want = _flash_want(q, k, v, causal, window)
    before = flash_attention.launches
    got = dispatch.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    _close(got, want, dtype, exact=False)


# b, sq, sk, h, kv, dh, causal, window, q_scale: gemma2's shape (8 heads
# over 4, dh 256, its local window), MLA's head dim 192, the other head
# dims, one query, and q x 8 (scores where the cap bends them)
FLASH_CAP_CASES = [
    (2, 1024, 1024, 8, 4, 256, True, 0, 1),
    (1, 600, 600, 8, 4, 256, True, 256, 8),
    *((2, 256, 256, 4, 2, dh, True, 0, 8) for dh in (64, 128, 192, 256)),
    *((2, 300, 300, 4, 2, dh, True, 40, 1) for dh in (64, 128, 192, 256)),
    (2, 1, 1, 4, 2, 128, True, 0, 8),
    (2, 130, 130, 4, 4, 64, False, 0, 8),
    # the wgmma kernel's edges under the cap: Sq < 64 and 129, Jamba's GQA
    # 64/8, dh 96, and Sq > Sk under a window (q-tiles that keep no key)
    (2, 40, 40, 4, 4, 192, True, 0, 8),
    (2, 129, 129, 4, 2, 256, True, 0, 8),
    (1, 200, 200, 64, 8, 128, True, 0, 8),
    (2, 256, 256, 4, 2, 96, True, 0, 8),
    (2, 400, 100, 4, 2, 128, True, 32, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,q_scale", FLASH_CAP_CASES)
def test_flash_attention_softcap_vs_plain(cuda_device, b, sq, sk, h, kv, dh, causal,
                                          window, q_scale, dtype):
    """gemma2's attention soft-cap of 50 inside the kernel, in both of its
    bodies, against the plain version; the causal first row reads key 0
    alone, so a sentinel that the cap had turned into -50 would show there
    (and at every window's edge)."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + h + kv + dh + window)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    q, k, v = ((q * q_scale).to(FLOATS[dtype]), k.to(FLOATS[dtype]), v.to(FLOATS[dtype]))
    want = _flash_want(q, k, v, causal, window, softcap=50.0)
    before = flash_attention.launches
    got = dispatch.flash_attention(q, k, v, causal=causal, window=window, softcap=50.0)
    assert flash_attention.launches == before + 1
    _close(got, want, dtype, exact=False)
    if causal:
        first = v[:, :1].repeat_interleave(h // kv, dim=2)
        _close(got[:, :1], first, dtype, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("dh", [64, 96, 128, 192, 202, 256])
def test_flash_attention_misaligned_base_vs_plain(cuda_device, dh, cap):
    """bf16 q, k and v whose bases sit one element past a 16-byte boundary:
    TMA cannot address them, so the wrapper copies them (or pads them, dh
    202) and launches the one wgmma kernel once; the output is bit for bit
    that of the same values aligned, and agrees with the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(dh)
    shapes = ((2, 150, 4, dh), (2, 150, 2, dh), (2, 150, 2, dh))
    aligned = [torch.randn(s, generator=gen, device=cuda_device).to(torch.bfloat16)
               for s in shapes]
    shifted = []
    for t in aligned:
        buf = torch.empty(t.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
        buf[1:] = t.reshape(-1)
        shifted.append(buf[1:].view(t.shape))
    assert all(t.data_ptr() % 16 == 2 for t in shifted)
    want = _flash_want(*aligned, True, 0, softcap=cap)
    got = []
    for tensors in (shifted, aligned):
        before = flash_attention.launches
        got.append(flash_attention(*tensors, causal=True, softcap=cap))
        assert flash_attention.launches == before + 1
        _close(got[-1], want, "bfloat16", exact=False)
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,cap", [
    (2, 1024, 1024, 16, 16, 128, True, 0, 0.0),
    (1, 400, 100, 4, 2, 64, True, 32, 0.0),
    (1, 300, 300, 4, 4, 192, True, 0, 0.0),
    (1, 129, 129, 4, 2, 96, True, 0, 0.0),
    (1, 300, 700, 8, 4, 256, False, 0, 50.0),
    (1, 520, 200, 4, 4, 192, True, 64, 50.0),
    (1, 129, 129, 4, 2, 50, True, 0, 50.0),
])
def test_flash_attention_lse_vs_plain(cuda_device, b, sq, sk, h, kv, dh, causal, window,
                                      cap, dtype):
    """``return_lse``: each row's logsumexp of the kept, scaled and capped
    scores against a float32 logsumexp of the plain scores (rtol = atol =
    1e-4), +inf exactly where a row keeps no key (Sq > Sk under a window),
    and the output beside it against the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + sk + dh)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(FLOATS[dtype])
               for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    out, lse = flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                               return_lse=True)
    kk = k.float().repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * dh ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    i, j = torch.arange(sq, device=cuda_device)[:, None], torch.arange(sk, device=cuda_device)
    keep = torch.ones((sq, sk), dtype=torch.bool, device=cuda_device)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    want = torch.logsumexp(torch.where(keep, s, float("-inf")), dim=-1)
    empty = _keeps_no_key(sq, sk, causal, window, cuda_device)
    assert bool(empty.any()) == (sq > sk and window > 0)
    assert bool(torch.isposinf(lse[:, :, empty]).all())
    assert bool(torch.isfinite(lse[:, :, ~empty]).all())
    torch.testing.assert_close(lse[:, :, ~empty], want[:, :, ~empty], rtol=1e-4, atol=1e-4)
    _close(out, _flash_want(q, k, v, causal, window, softcap=cap), dtype, exact=False)


@pytest.mark.cuda
def test_flash_attention_noncausal_vs_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 130, 2, 32), generator=gen, device=cuda_device)
               for _ in range(3))
    got = dispatch.flash_attention(q, k, v, causal=False)
    _close(got, ref.flash_attention(q, k, v, causal=False), "float32", exact=False)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    """Wrong dtype, device or contiguity raises; nothing launches."""
    eff = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    x = torch.zeros((1, 8, 16), device=cuda_device)
    q = torch.zeros((1, 8, 2, 16), device=cuda_device)
    before = (onehot_dispatch.launches, onehot_combine.launches, flash_attention.launches)
    with pytest.raises(ValueError, match="int32"):
        onehot_dispatch(eff.long(), eff, x, 2, 4)
    with pytest.raises(ValueError, match="float32"):
        onehot_dispatch(eff, eff, x.double(), 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        onehot_dispatch(eff.cpu(), eff.cpu(), x.cpu(), 2, 4)
    with pytest.raises(ValueError, match="contiguous"):
        onehot_dispatch(eff, eff, x[..., ::2], 2, 4)
    with pytest.raises(ValueError, match="gate"):
        onehot_combine(eff, eff, torch.zeros((1, 2, 4, 16), device=cuda_device),
                       torch.ones((1, 8), device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q.cpu(), q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="dh <= 256"):
        flash_attention(*(torch.zeros((1, 8, 2, 272), device=cuda_device),) * 3)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(q, q, q, softcap=-30.0)
    assert before == (onehot_dispatch.launches, onehot_combine.launches,
                      flash_attention.launches)


@pytest.mark.cuda
def test_cuda_tensors_never_reach_a_plain_version(cuda_device, monkeypatch):
    """With every plain version made to raise, the dispatch entry points and
    the MoE LM's prefill and decode still run on CUDA tensors: a CUDA
    tensor goes to a kernel or nowhere."""
    from repro_torch.configs import get_reduced

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("pe_buffer_update", "cms_update", "onehot_dispatch",
                 "onehot_combine", "flash_attention"):
        monkeypatch.setattr(ref, name, refuse)
    assert _lm_launches(get_reduced("moonshot-v1-16b-a3b"), cuda_device) == (2, 2, 1)


def _lm_launches(cfg, device):
    """One prefill and one decode step of ``cfg`` at random weights on the
    card; each kernel's launches over them, a layer."""
    from repro_torch.models import zoo
    model = zoo.build(cfg, device=device)
    params = model.init_params(model.generator(0))
    tokens = torch.randint(0, 256, (2, 64), device=device)
    counts = (onehot_dispatch.launches, onehot_combine.launches, flash_attention.launches)
    logits = model.prefill_fn(params, {"tokens": tokens})
    cache = model.init_cache(params, 2, 8)
    model.decode_fn(params, {"tokens": tokens[:, :1], "cache": cache, "cache_len": 0})
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    layers = cfg.num_layers
    return ((onehot_dispatch.launches - counts[0]) / layers,
            (onehot_combine.launches - counts[1]) / layers,
            (flash_attention.launches - counts[2]) / layers)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "gemma2-2b", "llama3.2-3b",
                                  "yi-6b", "starcoder2-15b"])
def test_lm_configs_never_reach_a_plain_version(cuda_device, monkeypatch, arch):
    """The other REDUCED configs as moonshot's above, in bfloat16: MLA's
    prefill and gemma2's soft-capped local and global layers launch the
    flash kernel once a layer, deepseek's MoE the pack and unpack once a
    layer a call."""
    import dataclasses
    from repro_torch.configs import get_reduced

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("onehot_dispatch", "onehot_combine", "flash_attention"):
        monkeypatch.setattr(ref, name, refuse)
    cfg = dataclasses.replace(get_reduced(arch), compute_dtype="bfloat16")
    moe = cfg.family == "moe"
    assert _lm_launches(cfg, cuda_device) == (2 * moe, 2 * moe, 1)


@pytest.mark.cuda
def test_placed_moe_apply_on_card_matches_cpu(cuda_device):
    """deepseek's reduced MoE with weights placed for a plan (pad_to 16:
    16 slots for 8 + 4): the card's pack and unpack at P = 16 against the
    CPU's plain versions, float32."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe
    from repro_torch.models.transformer import tree_to
    cfg = get_reduced("deepseek-v2-lite-16b")
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_params(gen, cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
                            num_shared=cfg.num_shared_experts,
                            shared_d_ff=cfg.shared_d_ff)
    placed = moe.place_slot_weights(params, torch.tensor([0, 3, 0, -1]),
                                    cfg.num_experts)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
              num_secondary=cfg.ditto_secondary, group_size=cfg.moe_group_size)
    want, _ = moe.moe_apply(placed, x, **kw)
    on_card = tree_to(placed, cuda_device)
    before = onehot_dispatch.launches
    got, _ = moe.moe_apply(on_card, x.to(cuda_device), **kw)
    assert onehot_dispatch.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_pagerank_scatter_on_card_equals_oracle(cuda_device):
    """One PageRank scatter phase through Ditto on the card (edge
    contributions on the card too): the oracle's sums bit for bit, and one
    route_accumulate launch per chunk."""
    from repro_torch.apps import pagerank
    from repro_torch.data.graphs import out_degrees, rmat_graph
    v = 1 << 12
    edges = rmat_graph(v, v * 8, seed=4)                  # 2^16 edges: 16 chunks
    deg = out_degrees(edges, v)
    rank = pagerank.init_rank(v) + np.arange(v, dtype=np.int32)
    d = Ditto(pagerank.make_spec(v, 16), chunk_size=4096, device=cuda_device)
    impl = d.build(edges[:, 1])
    assert impl.num_sec > 0
    contrib = pagerank.edge_contributions(torch.as_tensor(edges, device=cuda_device),
                                          torch.as_tensor(rank, device=cuda_device),
                                          torch.as_tensor(deg, device=cuda_device))
    before = route_accumulate.launches
    merged, _ = impl.run(contrib.view(-1, 4096, 2))
    torch.cuda.synchronize()
    assert route_accumulate.launches - before == 16
    np.testing.assert_array_equal(merged.cpu().numpy(),
                                  pagerank.oracle_scatter(edges, rank, deg, v, 16))


@pytest.mark.cuda
def test_dp_card_equals_cpu(cuda_device):
    """DP through Ditto on the card and on the CPU, with a masked ragged
    tail: the same regions slot for slot, cursors and tags; no PE kernel
    launches (DP's update is plain PyTorch on every device)."""
    from repro_torch.apps import dp
    tuples = zipf_tuples(4096 * 12 + 321, 1 << 20, 2.0, seed=8)
    outs = []
    before = (route_accumulate.launches, cms_update.launches)
    for device in (cuda_device, torch.device("cpu")):
        d = Ditto(dp.make_spec(8, 16, 1 << 15), chunk_size=4096, device=device)
        impl = d.build(tuples[:, 0])
        chunks, mask = d.chunk_masked(tuples)
        bufs, _ = impl.run(chunks, mask=mask)
        outs.append((impl.num_sec, bufs))
    torch.cuda.synchronize()
    assert (route_accumulate.launches, cms_update.launches) == before
    (x_gpu, b_gpu), (x_cpu, b_cpu) = outs
    assert x_gpu == x_cpu > 0 and int(b_cpu.cursor.max()) < 1 << 15
    for name in ("out", "cursor", "dst_part"):
        assert torch.equal(getattr(b_gpu, name).cpu(), getattr(b_cpu, name)), name
    for got, want in zip(dp.partitions_from_buffers(b_gpu, 256), dp.oracle(tuples, 8)):
        assert dp.multiset_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["histo", "hll", "hhd"])
def test_replicated_baseline_on_card_equals_oracle(cuda_device, app):
    """The static-dispatch baseline on the card: the flat oracle, and one PE
    kernel launch per chunk (route_accumulate, or cms_update for HHD)."""
    from repro_torch.core import make_replicated_executor
    mk, oracle, kernel = {
        "histo": (lambda m: histo.make_spec(512, 1 << 20, m),
                  lambda k: histo.oracle(k, 512, 1 << 20, 1), route_accumulate),
        "hll": (lambda m: hll.make_spec(12, m), lambda k: hll.oracle(k, 12, 1),
                route_accumulate),
        "hhd": (lambda m: hhd.make_spec(4, 1024, m), lambda k: hhd.oracle(k, 4, 1024, 1),
                cms_update)}[app]
    tuples = zipf_tuples(4096 * 10, 1 << 20, 3.0, seed=6)
    run = make_replicated_executor(mk(1), 16, 4096, device=cuda_device)
    before = kernel.launches
    agg, stats = run(torch.as_tensor(tuples.reshape(10, 4096, 2), device=cuda_device))
    torch.cuda.synchronize()
    assert kernel.launches - before == 10
    np.testing.assert_array_equal(agg.cpu().numpy(), oracle(tuples[:, 0]))
    assert stats["chunk_cycles"].shape == (10,) and stats["merge_cycles"].dtype == torch.float32


@pytest.mark.cuda
def test_ditto_tune_on_card_returns_a_plan(cuda_device):
    """Ditto.tune on the card: the model pass picks what the CPU picks, the
    measured pass returns a plan among its candidates, and the plan drives
    make_executor on the card bit-exact against the oracle."""
    from repro_torch.core import make_executor
    tuples = zipf_tuples(1 << 17, 1 << 20, 1.5, seed=3)
    spec = histo.make_spec(512, 1 << 20, 16)
    model = Ditto(spec, device=cuda_device).tune(tuples[:, 0])
    assert model.num_sec == Ditto(spec, device="cpu").tune(tuples[:, 0]).num_sec
    plan = Ditto(spec, device=cuda_device).tune(tuples[:, 0], measure=True,
                                                chunk_sizes=(2048, 4096))
    assert plan.source == "measured" and plan.chunk_size in (2048, 4096)
    assert plan.route_plan.table.is_cuda
    merged, _ = make_executor(spec, plan, device=cuda_device)(
        torch.as_tensor(tuples.reshape(-1, plan.chunk_size, 2), device=cuda_device),
        plan.route_plan)
    np.testing.assert_array_equal(merged.cpu().numpy(),
                                  histo.oracle(tuples[:, 0], 512, 1 << 20, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("combine", ["add", "max"])
def test_lane_flattened_route_accumulate(cuda_device, combine, lanes):
    """The executor's lane-batched PE update: one route_accumulate launch
    over [L * num_pe, local] equals L per-lane launches and the plain
    version, with masked sentinels (eff = num_pe) and -1 in every lane."""
    from repro_torch.core.executor import _lane_pe_update
    rng = np.random.default_rng(lanes)
    num_pe, local, t = 30, 32, 4096
    bufs = torch.from_numpy(rng.integers(-50, 50, (lanes, num_pe, local)).astype(np.int32))
    eff = torch.from_numpy(rng.integers(0, num_pe + 1, (lanes, t)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-1, local + 1, (lanes, t)).astype(np.int32))
    val = torch.from_numpy(rng.integers(-100, 100, (lanes, t)).astype(np.int32))
    want = torch.stack([ref.pe_buffer_update(bufs[l].clone(), eff[l], idx[l], val[l], combine)
                        for l in range(lanes)])
    pe = lambda b, e, i, v: dispatch.pe_buffer_update(b, e, i, v, combine)
    per_lane = bufs.to(cuda_device)
    for l in range(lanes):
        pe(per_lane[l], eff[l].to(cuda_device), idx[l].to(cuda_device), val[l].to(cuda_device))
    before = route_accumulate.launches
    got = _lane_pe_update(pe, bufs.to(cuda_device), eff.to(cuda_device), idx.to(cuda_device),
                          val.to(cuda_device), num_pe)
    assert route_accumulate.launches == before + 1
    _assert_same(got, want, exact=True)
    _assert_same(per_lane, want, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8])
def test_lane_flattened_cms_update(cuda_device, lanes):
    from repro_torch.core.executor import _lane_pe_update
    rng = np.random.default_rng(lanes + 100)
    num_pe, depth, width, t = 30, 4, 1024, 4096
    sketch = torch.from_numpy(rng.integers(0, 50, (lanes, num_pe, depth, width)).astype(np.int32))
    eff = torch.from_numpy(rng.integers(0, num_pe + 1, (lanes, t)).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, width, (lanes, t, depth)).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 100, (lanes, t)).astype(np.int32))
    want = torch.stack([ref.cms_update(sketch[l].clone(), eff[l], cols[l], val[l])
                        for l in range(lanes)])
    before = cms_update.launches
    got = _lane_pe_update(dispatch.cms_update, sketch.to(cuda_device), eff.to(cuda_device),
                          cols.to(cuda_device), val.to(cuda_device), num_pe)
    assert cms_update.launches == before + 1
    _assert_same(got, want, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["histo", "hll", "hhd"])
def test_multistream_on_card_matches_cpu(cuda_device, app):
    """make_multistream_executor on the card equals the CPU lane by lane,
    ragged tails and an all-masked pad lane included, one PE launch per
    batched chunk."""
    from repro_torch.core.executor import make_multistream_executor
    spec = {"histo": lambda: histo.make_spec(512, 1 << 20, 16),
            "hll": lambda: hll.make_spec(12, 16),
            "hhd": lambda: hhd.make_spec(4, 1024, 16)}[app]()
    lanes, chunks, chunk = 4, 6, 4096
    tuples = np.stack([zipf_tuples(chunks * chunk, 1 << 20, 1.0 * l, seed=l)
                       for l in range(lanes)]).reshape(lanes, chunks, chunk, 2)
    mask = np.ones((lanes, chunks, chunk), bool)
    mask[0, -1, 1000:] = False
    mask[-1] = False
    outs = []
    kernel = cms_update if app == "hhd" else route_accumulate
    for dev in (cuda_device, torch.device("cpu")):
        before = kernel.launches
        merged, stats = make_multistream_executor(spec, 16, 14, chunk, device=dev)(
            torch.as_tensor(tuples), mask=torch.as_tensor(mask))
        if dev.type == "cuda":
            assert kernel.launches == before + chunks
        outs.append((merged.cpu(), stats))
    (m_gpu, s_gpu), (m_cpu, s_cpu) = outs
    assert torch.equal(m_gpu, m_cpu)
    for f in ("max_load", "modeled_cycles", "mode", "rescheduled", "workload"):
        assert torch.equal(getattr(s_gpu, f).cpu(), getattr(s_cpu, f)), f


def _session_script(eng, seed=0, rounds=6, close_all=True):
    """A seeded op script over a session engine: a storm, opens that queue,
    ragged appends, queries in both scopes, engine and per-session flushes
    and closes (of every session at the end with ``close_all``).  Returns
    every answer in order."""
    rng = np.random.default_rng(seed)
    chunk = eng.chunk_size
    feed = lambda n, a: zipf_tuples(n, 1 << 20, a, seed=int(rng.integers(1 << 30)))
    answers = []
    sids = eng.open_batch([f"s{i}" for i in range(3)],
                          first=[feed(2 * chunk + 17, 2.0), feed(chunk, 0.0), None])
    sids += [eng.open(f"o{i}") for i in range(3)]
    for r in range(rounds):
        for sid in sids:
            if not eng.sessions[sid].closed:
                eng.append(sid, feed(int(rng.integers(0, 3 * chunk)), (0.0, 3.0)[sid % 2]))
        live = [s for s in sids if not eng.sessions[s].closed
                and eng.sessions[s].slot is not None]
        if r % 2 == 0:
            eng.flush()
        else:
            eng.flush_session(live[0])
        answers.append(eng.query(live[-1], scope=("session", "engine")[r % 2]))
        if r in (2, 4):
            answers.append(eng.close(live[0])[0])
    for sid in sids if close_all else ():
        if not eng.sessions[sid].closed:
            answers.append(eng.close(sid)[0])
    return answers


def _session_kw():
    return dict(num_pri=4, num_sec=2, chunk_size=256, primary_slots=3, secondary_slots=2,
                aot_buckets=2)


@pytest.mark.cuda
def test_session_engine_on_card_matches_cpu(cuda_device):
    """The same op script through a HISTO SessionEngine on the card and on
    the CPU: identical answers, slot tables and integer telemetry fields;
    route_accumulate launches once per batched chunk step (the rows' lane
    widths), and no build event after warmup()."""
    from repro_torch.core import compilemon
    from repro_torch.serve import SessionEngine
    spec = histo.make_spec(512, 1 << 20, 4)
    runs = []
    compilemon.install()
    for dev in (cuda_device, torch.device("cpu")):
        eng = SessionEngine(spec, device=dev, **_session_kw())
        eng.warmup(dtype=np.int32, feat_shape=(2,))
        before, snap = route_accumulate.launches, compilemon.snapshot()
        answers = _session_script(eng)
        rows = [{k: v for k, v in r.items() if not k.endswith("ms")} for r in eng._telemetry]
        if dev.type == "cuda":
            assert route_accumulate.launches - before == sum(r["lane_width"] for r in rows)
            assert compilemon.since(snap).n_compiles == 0
        runs.append((answers, rows, list(eng._slot_sid), eng._sec_assign.tolist()))
    (a_gpu, r_gpu, s_gpu, g_gpu), (a_cpu, r_cpu, s_cpu, g_cpu) = runs
    assert len(a_gpu) == len(a_cpu)
    for x, y in zip(a_gpu, a_cpu):
        assert np.array_equal(x, y)
    assert r_gpu == r_cpu and s_gpu == s_cpu and g_gpu == g_cpu


@pytest.mark.cuda
@pytest.mark.parametrize("first,then", [("cpu", "cuda"), ("cuda", "cpu")])
def test_durable_directory_moves_between_devices(cuda_device, tmp_path, first, then):
    """A durable directory written on one device, abandoned mid-stream,
    recovers on the other with the answers, slot table and backlogs of an
    uninterrupted run on the first."""
    from repro_torch.serve import DurableSessionEngine, SessionEngine
    spec = histo.make_spec(512, 1 << 20, 4)
    engines = {}
    for name in ("crashed", "reference"):
        eng = DurableSessionEngine(spec, directory=tmp_path / name, device=first,
                                   checkpoint_every=2, **_session_kw())
        _session_script(eng, seed=5, rounds=3, close_all=False)
        eng._mgr.wait()
        engines[name] = eng
    ref = engines["reference"]
    rec = SessionEngine.recover(spec, tmp_path / "crashed", device=then)
    assert rec.device.type == then and rec.recovery_info["replay_anomalies"] == 0
    assert rec._slot_sid == ref._slot_sid and list(rec._queue) == list(ref._queue)
    assert {s: x.backlog_tuples for s, x in rec.sessions.items()} == \
        {s: x.backlog_tuples for s, x in ref.sessions.items()}
    for sid, s in ref.sessions.items():
        if s.slot is not None:
            assert np.array_equal(rec.query(sid), ref.query(sid))
    rec.shutdown()
    for eng in engines.values():
        eng.shutdown()


@pytest.mark.cuda
def test_dp_scan_lanes_on_card_matches_cpu(cuda_device):
    """DP under lanes on the card equals the CPU slot for slot (regions,
    cursors, tags and stats), and no PE kernel launches."""
    from repro_torch.apps import dp
    from repro_torch.core import executor
    spec = dp.make_spec(8, 16, 1 << 14)
    lanes, chunks, chunk = 4, 5, 4096
    tuples = np.stack([zipf_tuples(chunks * chunk, 1 << 20, 1.0 * l, seed=l)
                       for l in range(lanes)]).reshape(lanes, chunks, chunk, 2)
    mask = np.ones((lanes, chunks, chunk), bool)
    mask[1, -1, 700:] = False
    mask[-1] = False
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        before = (route_accumulate.launches, cms_update.launches)
        res = executor.make_resumable_executor(spec, 16, 14, chunk, device=dev)
        st, stats = res.scan_lanes(executor.stack_states(res.init_state(), lanes),
                                   torch.as_tensor(tuples), torch.as_tensor(mask))
        assert (route_accumulate.launches, cms_update.launches) == before
        outs.append(({f: getattr(st.buffers, f).cpu() for f in ("out", "cursor", "dst_part")},
                     stats))
    (b_gpu, s_gpu), (b_cpu, s_cpu) = outs
    for f in b_gpu:
        assert torch.equal(b_gpu[f], b_cpu[f]), f
    for f in ("max_load", "modeled_cycles", "mode", "rescheduled", "workload"):
        assert torch.equal(getattr(s_gpu, f).cpu(), getattr(s_cpu, f)), f


@pytest.mark.cuda
def test_no_build_event_after_warmup(cuda_device):
    """warmup() builds and loads the PE kernels; afterwards a ragged HHD
    session workload records no compilemon event on any flush path."""
    from repro_torch.core import compilemon
    from repro_torch.serve import SessionEngine
    compilemon.install()
    eng = SessionEngine(hhd.make_spec(4, 1024, 4), device=cuda_device, **_session_kw())
    info = eng.warmup(dtype=np.int32, feat_shape=(2,))
    assert info["n_executables"] == len(eng._aot)
    snap = compilemon.snapshot()
    before = cms_update.launches
    _session_script(eng, seed=9, rounds=4)
    assert compilemon.since(snap).n_compiles == 0
    assert cms_update.launches - before == sum(r["lane_width"] for r in eng._telemetry)
    assert eng.telemetry_record()["extra"]["totals"]["n_retraces"] == 0


def _served_engine(dev, **kw):
    from repro_torch.serve import SessionEngine
    eng = SessionEngine(histo.make_spec(512, 1 << 20, 4), device=dev, **_session_kw(), **kw)
    eng.warmup(dtype=np.int32, feat_shape=(2,))
    return eng


def _service_oracle(parts):
    keys = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return histo.oracle(keys, 512, 1 << 20, 4)


@pytest.mark.cuda
def test_service_over_card_engine_bit_exact(cuda_device):
    """A service in front of a CUDA engine, over loopback: open, open_batch
    with first appends, ragged and empty appends, queries in both scopes
    and close, every answer bit-exact against the oracle."""
    from repro_torch.serve.service import ServiceClient, ServiceConfig, SessionService
    eng = _served_engine(cuda_device)
    with SessionService(eng, ServiceConfig()) as svc, \
            ServiceClient(*svc.address, timeout=120) as c:
        d1, d2 = zipf_tuples(3 * 256 + 5, 1 << 20, 1.5, seed=1), zipf_tuples(17, 1 << 20, 0.0, seed=2)
        sid = c.open("a")
        assert c.append(sid, d1) == len(d1) and c.append(sid, d2) == len(d2)
        assert c.append(sid, d1[:0]) == 0
        want = _service_oracle([d1[:, 0], d2[:, 0]])
        assert np.array_equal(c.query(sid), want)
        assert np.array_equal(c.query(sid, scope="engine"), want)
        firsts = [zipf_tuples(600, 1 << 20, 3.0, seed=3), None]
        sids = c.open_batch(["b", "c"], first=firsts)
        assert np.array_equal(c.query(sids[0]), _service_oracle([firsts[0][:, 0]]))
        merged, stats = c.close(sid)
        assert np.array_equal(merged, want) and stats["tuples_appended"] == len(d1) + len(d2)
        for s in sids:
            c.close(s)


@pytest.mark.cuda
def test_service_worker_runs_under_the_engine_device(cuda_device):
    """Every engine call runs on the service's worker thread with the
    engine's device current."""
    import threading
    from repro_torch.serve.service import ServiceClient, ServiceConfig, SessionService
    eng = _served_engine(cuda_device)
    seen = []
    for name in ("open", "append", "query", "close"):
        fn = getattr(eng, name)

        def rec(*a, _fn=fn, **k):
            seen.append((threading.current_thread().name, torch.cuda.current_device()))
            return _fn(*a, **k)
        setattr(eng, name, rec)
    with SessionService(eng, ServiceConfig()) as svc, \
            ServiceClient(*svc.address, timeout=120) as c:
        sid = c.open("a")
        c.append(sid, zipf_tuples(1000, 1 << 20, 1.0, seed=4))
        c.query(sid)
        c.close(sid)
    want = eng.device.index if eng.device.index is not None else torch.cuda.current_device()
    assert len(seen) == 4
    assert all(t.startswith("svc-engine") and d == want for t, d in seen), seen


@pytest.mark.cuda
def test_service_records_no_build_after_warmup(cuda_device):
    """With the engine warmed up before start(), 200 requests record no
    build event and launch route_accumulate once per batched chunk step."""
    from repro_torch.core import compilemon
    from repro_torch.serve.service import ServiceClient, ServiceConfig, SessionService
    compilemon.install()
    eng = _served_engine(cuda_device)
    snap, before = compilemon.snapshot(), route_accumulate.launches
    rng = np.random.default_rng(5)
    n = 0
    with SessionService(eng, ServiceConfig()) as svc, \
            ServiceClient(*svc.address, timeout=120) as c:
        sids = [c.open(f"t{i}") for i in range(3)]
        n += 3
        while n < 197:
            sid = int(rng.choice(sids))
            if rng.random() < 0.6:
                c.append(sid, zipf_tuples(int(rng.integers(0, 700)), 1 << 20, 2.0,
                                          seed=int(rng.integers(1 << 30))))
            else:
                c.query(sid, scope=("session", "engine")[n % 2])
            n += 1
        for sid in sids:
            c.close(sid)
    assert compilemon.since(snap).n_compiles == 0
    assert route_accumulate.launches - before == sum(r["lane_width"] for r in eng._telemetry)


@pytest.mark.cuda
def test_service_recovery_on_card_answers_as_before(cuda_device, tmp_path):
    """A durable CUDA engine behind a service, dropped without shutdown;
    recover(device="cuda") behind a new service answers every open session
    as the old one did, and takes further appends."""
    from repro_torch.serve import DurableSessionEngine, SessionEngine
    from repro_torch.serve.service import ServiceClient, ServiceConfig, SessionService
    spec = histo.make_spec(512, 1 << 20, 4)
    eng = DurableSessionEngine(spec, directory=tmp_path, device=cuda_device,
                               checkpoint_every=2, **_session_kw())
    eng.warmup(dtype=np.int32, feat_shape=(2,))
    parts = {}
    with SessionService(eng, ServiceConfig()) as svc, \
            ServiceClient(*svc.address, timeout=120) as c:
        for i in range(3):
            sid = c.open(f"t{i}")
            parts[sid] = []
            for j in range(4):
                d = zipf_tuples(300 + 211 * j, 1 << 20, 1.0 * i, seed=10 * i + j)
                c.append(sid, d)
                parts[sid].append(d[:, 0])
                if j % 2:
                    c.query(sid)
        before = {sid: c.query(sid) for sid in parts}
    eng._mgr.wait()
    rec = SessionEngine.recover(spec, tmp_path, device=cuda_device)
    rec.warmup(dtype=np.int32, feat_shape=(2,))
    with SessionService(rec, ServiceConfig()) as svc, \
            ServiceClient(*svc.address, timeout=120) as c:
        for sid, want in before.items():
            assert np.array_equal(c.query(sid), want)
            d = zipf_tuples(999, 1 << 20, 2.0, seed=sid)
            c.append(sid, d)
            parts[sid].append(d[:, 0])
            merged, _ = c.close(sid)
            assert np.array_equal(merged, _service_oracle(parts[sid]))
    rec.shutdown()
    eng.shutdown()


# ---------------------------------------------------- multi-device, sharded

@pytest.mark.cuda
@pytest.mark.parametrize("app", ["histo", "hll"])
def test_run_stream_on_card_shards_matches_cpu_mesh(cuda_device, app):
    """run_stream with one PE a shard on 4 logical shards of the card
    (3 + 1) equals the same on 4 CPU shards chunk by chunk; route_accumulate
    launches once a shard a chunk."""
    from repro_torch.core import distributed as D
    spec = histo.make_spec(96, 1 << 20, 3) if app == "histo" else hll.make_spec(10, 3)
    chunks, chunk = 8, 4 * 1024
    data = zipf_tuples(chunks * chunk, 1 << 20, 1.5, seed=5).reshape(chunks, chunk, 2)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        per = []
        before = route_accumulate.launches
        merged, stats = D.run_stream(
            spec, D.make_mesh(4, "pe", device=dev), data, 3, 1, capacity=400,
            on_chunk=lambda c, b, l, d, w: per.append(
                [torch.cat([x.cpu() for x in b]), l.cpu(), d.cpu(), w.cpu()]))
        if dev.type == "cuda":
            assert route_accumulate.launches - before == 4 * chunks
        runs.append((merged.cpu(), stats, per))
    (m_gpu, s_gpu, p_gpu), (m_cpu, s_cpu, p_cpu) = runs
    assert torch.equal(m_gpu, m_cpu)
    assert s_gpu["loads"] == s_cpu["loads"] and s_gpu["drops"] == s_cpu["drops"]
    for a, b in zip(p_gpu, p_cpu):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_lane_sharded_ops_on_card_match_unsharded(cuda_device, shards):
    """run_lanes, merge_lane and a cross-shard fold_lane on card shards
    against the unsharded scan_lanes on the card; one PE launch a shard a
    batched chunk."""
    from repro_torch.core import distributed as D
    from repro_torch.core import executor as E
    res = E.make_resumable_executor(histo.make_spec(512, 1 << 20, 16), 16, 6, 1024,
                                    device=cuda_device)
    lanes, chunks = 4, 3
    tuples = np.stack([zipf_tuples(chunks * 1024, 1 << 20, 1.0 * l, seed=20 + l)
                       for l in range(lanes)]).reshape(lanes, chunks, 1024, 2)
    mask = np.ones((lanes, chunks, 1024), bool)
    mask[1, -1, 300:] = False
    sh = D.make_lane_sharded_executor(res, D.make_mesh(shards, "lanes", device=cuda_device),
                                      lanes)
    before = route_accumulate.launches
    states, stats = sh.run_lanes(sh.init_states(), tuples, mask)
    assert route_accumulate.launches - before == shards * chunks
    want, wstats = res.scan_lanes(E.stack_states(res.init_state(), lanes), tuples, mask)
    got = sh.gather_states(states)
    assert torch.equal(got.buffers, want.buffers)
    assert torch.equal(stats.max_load, wstats.max_load)
    for i in range(lanes):
        assert torch.equal(sh.merge_lane(states, i).cpu(),
                           res.merge_state(E.take_lanes(want, i)).cpu())
    src, dst = lanes - 1, 0
    folded = sh.gather_states(sh.fold_lane(states, src, dst))
    expect = want.buffers[dst].clone()
    expect[:16] += res.merge_state(E.take_lanes(want, src))
    assert torch.equal(folded.buffers[dst], expect)
    assert torch.equal(folded.buffers[src], res.init_state().buffers)


@pytest.mark.cuda
def test_meshed_session_engine_on_card_matches_local(cuda_device):
    """The session op script on an engine whose 3 + 1 lanes lie on 4 card
    shards and on a local card engine: identical answers, slot tables and
    integer telemetry; the PE kernel once a shard an engine-wide step and
    once a per-session step; no build event after warmup()."""
    from repro_torch.core import compilemon
    from repro_torch.core import distributed as D
    from repro_torch.serve import SessionEngine
    spec = histo.make_spec(512, 1 << 20, 4)
    kw = {**_session_kw(), "secondary_slots": 1}
    runs = []
    compilemon.install()
    for mesh in (D.make_mesh(4, "lanes", device=cuda_device), None):
        eng = SessionEngine(spec, device=cuda_device, mesh=mesh, **kw)
        eng.warmup(dtype=np.int32, feat_shape=(2,))
        before, snap = route_accumulate.launches, compilemon.snapshot()
        answers = _session_script(eng)
        rows = [{k: v for k, v in r.items() if not k.endswith("ms")} for r in eng._telemetry]
        per_step = 1 if mesh is None else 4
        assert route_accumulate.launches - before == sum(
            r["lane_width"] * (per_step if r["scope"] == "engine" else 1) for r in rows)
        assert compilemon.since(snap).n_compiles == 0
        runs.append((answers, rows, list(eng._slot_sid), eng._sec_assign.tolist()))
    (a_m, r_m, s_m, g_m), (a_l, r_l, s_l, g_l) = runs
    assert len(a_m) == len(a_l)
    for x, y in zip(a_m, a_l):
        assert np.array_equal(x, y)
    assert r_m == r_l and s_m == s_l and g_m == g_l


NEW_LM_ARCHS = ["mamba2-780m", "jamba-1.5-large-398b", "phi-3-vision-4.2b"]


def _lm_batch(cfg, device, b=2, s=64, seed=0):
    """Seeded tokens (and patches for the VLM) for a prefill of ``cfg``."""
    from repro_torch.models import frontends
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen)}
    if cfg.num_patches:
        batch["patches"] = frontends.random_patches(cfg, gen, b)
    return {k: v.to(device) for k, v in batch.items()}


def _layer_kinds(cfg):
    attn = sum(k != "mamba" for k in cfg.block_pattern) * cfg.num_periods
    moe = sum(k == "moe" for k in cfg.ffn_pattern) * cfg.num_periods
    return attn, moe


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_LM_ARCHS)
def test_new_lm_configs_on_card_match_cpu(cuda_device, monkeypatch, arch):
    """The SSM, hybrid and VLM REDUCED configs (float32, TF32 off), the same
    seeded weights on the card and on the CPU: prefill logits (with patches
    for the VLM) and eight decode steps' logits within rtol = atol = 1e-4,
    greedy tokens identical.  On the card the flash kernel runs once an
    attention layer a prefill and the MoE pack and unpack once an MoE layer
    a call; the SSD is plain PyTorch on both."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import zoo
    from repro_torch.models.transformer import tree_to
    from repro_torch.serve import engine
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_reduced(arch)
    cpu = torch.device("cpu")
    models = {d: zoo.build(cfg, device=d) for d in (cpu, cuda_device)}
    params = {cpu: models[cpu].init_params(models[cpu].generator(0))}
    params[cuda_device] = tree_to(params[cpu], cuda_device)
    attn, moe = _layer_kinds(cfg)
    out = {}
    for d in (cpu, cuda_device):
        model, p = models[d], params[d]
        before = (flash_attention.launches, onehot_dispatch.launches,
                  onehot_combine.launches)
        logits = model.prefill_fn(p, _lm_batch(cfg, d))
        after = (flash_attention.launches, onehot_dispatch.launches,
                 onehot_combine.launches)
        want = (attn, moe, moe) if d.type == "cuda" else (0, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == want
        cache = model.init_cache(None, 2, 16)
        toks = _lm_batch(cfg, d, s=8, seed=1)["tokens"]
        steps = []
        for t in range(8):
            lg, cache = model.decode_fn(p, {"tokens": toks[:, t:t + 1], "cache": cache,
                                            "cache_len": t})
            steps.append(lg[:, 0])
        gen = engine.greedy_generate(model, p, toks[:, :5], max_new_tokens=4)
        out[d.type] = (logits.cpu(), torch.stack(steps, 1).cpu(), gen.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-4)
    assert torch.equal(out["cuda"][2], out["cpu"][2])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_LM_ARCHS)
def test_new_lm_configs_never_reach_a_plain_version(cuda_device, monkeypatch, arch):
    """The same configs in bfloat16 with every plain kernel version made to
    raise: a prefill and a decode step run on the card's kernels alone."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import zoo

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("onehot_dispatch", "onehot_combine", "flash_attention"):
        monkeypatch.setattr(ref, name, refuse)
    cfg = dataclasses.replace(get_reduced(arch), compute_dtype="bfloat16")
    model = zoo.build(cfg, device=cuda_device)
    params = model.init_params(model.generator(0))
    before = flash_attention.launches
    logits = model.prefill_fn(params, _lm_batch(cfg, cuda_device))
    cache = model.init_cache(params, 2, 8)
    model.decode_fn(params, {"tokens": torch.zeros((2, 1), dtype=torch.int32,
                                                   device=cuda_device),
                             "cache": cache, "cache_len": 0})
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits.float()).all())
    assert flash_attention.launches - before == _layer_kinds(cfg)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_decode_engine_admission_on_card_starts_from_zero_state(cuda_device, arch):
    """Four requests of 6 tokens over 2 card slots: every admission's
    logits equal a fresh-cache prefill's on the card (rtol = atol = 1e-5,
    float32)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import zoo
    from repro_torch.serve import engine
    cfg = get_reduced(arch)
    model = zoo.build(cfg, device=cuda_device)
    params = model.init_params(model.generator(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 6).astype(np.int32) for _ in range(4)]
    seen = []
    real = engine.prefill_cache

    def recording(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        seen.append(logits[0].cpu())
        return logits, cache

    eng = engine.DecodeEngine(model, params, slots=2, max_len=32)
    for i, p in enumerate(prompts):
        eng.submit(engine.Request(i, p, 5))
    engine.prefill_cache = recording
    try:
        eng.run()
    finally:
        engine.prefill_cache = real
    assert len(seen) == 4
    for got, p in zip(seen, prompts):
        fresh, _ = real(model, params, torch.as_tensor(p, device=cuda_device)[None],
                        model.init_cache(None, 1, 32))
        torch.testing.assert_close(got, fresh[0].cpu(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------- flash attention backward
# b, sq, sk, h, kv, dh, causal, window, cap: causal and not, GQA, a window,
# the cap at dh 256 (two dK/dV column slices), whisper's Sk = 1500 (not a
# multiple of the 64-key tile) with Sq != Sk, odd Sq, dh 96 in the 128
# template, one query; the last two under cap 2, where unit scores make
# 1 - tanh^2(s / cap) average ~0.8 (at cap 50 it is >= 0.99: the cap's
# derivative would go untested).  Then the one-pass layout's edges: llama's
# group of 3 (three query heads' CTAs sum one KV head's dK/dV), Sk = 200 off
# the 64-key block at dh 64 under 5 query tiles, dh 256 with a window over
# many 32-query tiles, 256 CTAs (more than the card's 132 SMs), a group of
# 8 (the largest cluster) at dh 256 (the most shared memory a CTA), and a
# group of 12 (starcoder2's 48/4), larger than a cluster.  Then causal with
# Sq < Sk, where the key blocks past Sq keep no query and their dK/dV must
# be zero: groups of 2 at dh 64 and of 4 at dh 128 (in a cluster), of 16 at
# dh 256 (through partials); and a group of 11 (partials) at Sq = Sk
FLASH_BWD_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, 0.0),
    (2, 100, 100, 4, 2, 64, False, 0, 0.0),
    (1, 200, 200, 4, 2, 128, True, 48, 0.0),
    (1, 160, 160, 4, 2, 256, True, 0, 50.0),
    (1, 96, 96, 2, 1, 256, True, 32, 50.0),
    (2, 77, 1500, 4, 4, 64, False, 0, 0.0),
    (1, 131, 131, 2, 1, 96, True, 0, 0.0),
    (2, 1, 40, 2, 2, 64, False, 0, 0.0),
    (1, 160, 160, 4, 2, 256, True, 0, 2.0),
    (2, 77, 300, 4, 2, 64, False, 0, 2.0),
    (1, 130, 130, 24, 8, 128, True, 0, 0.0),
    (1, 300, 200, 4, 2, 64, False, 0, 0.0),
    (1, 300, 300, 4, 2, 256, True, 100, 0.0),
    (2, 512, 512, 16, 4, 128, True, 0, 0.0),
    (1, 96, 96, 8, 1, 256, True, 0, 0.0),
    (1, 70, 70, 12, 1, 64, True, 0, 0.0),
    (1, 64, 200, 4, 2, 64, True, 0, 0.0),
    (1, 64, 200, 8, 2, 128, True, 0, 0.0),
    (1, 64, 200, 16, 1, 256, True, 0, 0.0),
    (1, 100, 100, 11, 1, 64, True, 0, 0.0),
]
# Against the plain backward of float32 copies, each of dQ, dK and dV is
# held to two bounds.  Element by element, |got - want| <= tol * (1 + max
# |want|) (BWD_TOL): float32 sums in another order (1e-4); bfloat16 rounds
# P and dS to bf16 before their products (3e-2).  In norm, ||got - want||_F
# / ||want||_F <= rel (BWD_REL): the elementwise bound is never below tol and
# grows with the largest value, so it can be as large as a typical element;
# bf16 rounding gives a few 1e-3 of the norm, dropping the ragged last query
# tile's share of dK and dV at whisper's 1500 queries 0.14
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}


def _bwd_inputs(cuda_device, b, sq, sk, h, kv, dh, dtype, seed):
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda_device).to(FLOATS[dtype])
            for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh), (b, sq, h, dh))]


def _bwd_errors(got, want, dtype):
    """max |got - want|, its bound, and ||got - want||_F / ||want||_F."""
    if got.is_cuda:
        torch.cuda.synchronize()
    delta = got.double() - want.double()
    bound = BWD_TOL[dtype] * (1 + float(want.abs().max()))
    return float(delta.abs().max()), bound, float(delta.norm() / want.double().norm())


def _close_bwd(got, want, dtype):
    """``got`` within BWD_TOL of ``want`` element by element and within
    BWD_REL of it in norm."""
    diff, bound, rel = _bwd_errors(got, want, dtype)
    assert diff <= bound and rel <= BWD_REL[dtype], \
        f"max |err| {diff} (bound {bound}), norm err {rel} (bound {BWD_REL[dtype]})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,cap", FLASH_BWD_CASES)
def test_flash_attention_bwd_vs_plain(cuda_device, b, sq, sk, h, kv, dh, causal, window,
                                      cap, dtype):
    """dQ, dK and dV of the backward kernel, through FlashAttention's
    backward, against ``ref.flash_attention_bwd`` (autograd through the
    plain forward) on float32 copies of the same inputs; one forward and
    one backward launch."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v, do = _bwd_inputs(cuda_device, b, sq, sk, h, kv, dh, dtype, sq + sk + dh)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(), do.float(),
                                   causal=causal, window=window, softcap=cap)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = dispatch.flash_attention(*leaves, causal=causal, window=window, softcap=cap)
    got = torch.autograd.grad(out, leaves, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == FLOATS[dtype] and g.shape == w.shape, name
        _close_bwd(g, w, dtype)


def _bwd_formula(q, k, v, do, cap, cap_derivative=True, dq_keys=None, dkv_heads=None):
    """FlashAttention-2's backward written out, non-causal, in float64: the
    plain version's gradients, or those of a backward with a fault: one that
    leaves out the cap's derivative 1 - tanh^2(s / cap)
    (``cap_derivative=False``), one whose dQ sums only the keys of the mask
    ``dq_keys`` [Sk], one whose dK and dV sum only the heads of each GQA
    group at the offsets ``dkv_heads``."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    q, k, v, do = (t.double() for t in (q, k, v, do))
    kk, vv = (t.repeat_interleave(h // kvh, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * dh ** -0.5
    t = torch.tanh(s / cap) if cap else None
    p = torch.softmax(cap * t if cap else s, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vv)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if cap and cap_derivative:
        ds = ds * (1 - t * t)
    ds = ds * dh ** -0.5

    def per_kv_head(x):
        x = x.reshape(b, x.shape[1], kvh, h // kvh, dh)
        return (x if dkv_heads is None else x[:, :, :, dkv_heads]).sum(3)

    ds_q = ds if dq_keys is None else ds * dq_keys.double()
    return (torch.einsum("bhqk,bkhd->bqhd", ds_q, kk),
            per_kv_head(torch.einsum("bhqk,bqhd->bkhd", ds, q)),
            per_kv_head(torch.einsum("bhqk,bqhd->bkhd", p, do)))


# (fault, b, sq, sk, h, kv, dh, cap): a bf16 backward that drops the ragged
# last query tile from dK and dV at whisper's encoder length (1500 = 23 x 64
# + 28 queries); one that leaves out the cap's derivative under cap 2; two
# of the one-pass layout: one key block's dQ atomics lost at whisper
# cross's Sk = 1500 (the ragged last block of 64 keys, 28 of them), and dK
# and dV from only the first head of each group of 3
BWD_FAULTS = [("ragged_query_tile", 1, 1500, 1500, 2, 2, 64, 0.0),
              ("no_cap_derivative", 2, 77, 300, 4, 2, 64, 2.0),
              ("lost_key_block_dq", 1, 448, 1500, 2, 2, 64, 0.0),
              ("first_head_of_group", 1, 128, 128, 6, 2, 64, 0.0)]


def _fault_inputs(b, sq, sk, h, kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16).float()
            for shape in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh), (b, sq, h, dh))]


@pytest.mark.parametrize("fault,b,sq,sk,h,kv,dh,cap", BWD_FAULTS)
def test_bwd_formula_matches_plain(fault, b, sq, sk, h, kv, dh, cap):
    """The written-out backward that the fault test plants its faults in is
    the plain version's, ``ref.flash_attention_bwd`` (float32) within 1e-5
    of the largest value (CPU)."""
    q, k, v, do = _fault_inputs(b, sq, sk, h, kv, dh)
    want = ref.flash_attention_bwd(q, k, v, do, causal=False, softcap=cap)
    for name, g, w in zip(("dq", "dk", "dv"), _bwd_formula(q, k, v, do, cap), want):
        torch.testing.assert_close(g.float(), w, rtol=0, atol=1e-5 * float(w.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("fault,b,sq,sk,h,kv,dh,cap", BWD_FAULTS)
def test_bwd_check_fails_a_planted_fault(fault, b, sq, sk, h, kv, dh, cap):
    """The bf16 check of test_flash_attention_bwd_vs_plain (``_close_bwd``)
    passes the plain gradients rounded to bf16 and fails a backward with a
    planted fault in dQ, dK or dV, by its norm bound alone (CPU: the faults
    are planted in the written-out backward)."""
    q, k, v, do = _fault_inputs(b, sq, sk, h, kv, dh)
    want = ref.flash_attention_bwd(q, k, v, do, causal=False, softcap=cap)
    for w in want:
        _close_bwd(w.to(torch.bfloat16), w, "bfloat16")
    if fault == "ragged_query_tile":     # dV without the last 13 queries' share
        kept = do.clone()
        kept[:, sq - sq % 64:] = 0
        faulty, right = _bwd_formula(q, k, v, kept, cap)[2], want[2]
    elif fault == "no_cap_derivative":   # dK without c'(s)
        faulty, right = _bwd_formula(q, k, v, do, cap, cap_derivative=False)[1], want[1]
    elif fault == "lost_key_block_dq":   # dQ without keys [1472, 1500)
        keys = torch.arange(sk) < sk - sk % 64
        faulty, right = _bwd_formula(q, k, v, do, cap, dq_keys=keys)[0], want[0]
    else:                                # dK from each group's first head
        faulty, right = _bwd_formula(q, k, v, do, cap, dkv_heads=[0])[1], want[1]
    assert _bwd_errors(faulty.to(torch.bfloat16), right, "bfloat16")[2] > BWD_REL["bfloat16"]
    with pytest.raises(AssertionError, match="norm err"):
        _close_bwd(faulty.to(torch.bfloat16), right, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
def test_flash_attention_lse_is_the_row_logsumexp(cuda_device, dtype):
    """The forward's log-sum-exp output: each row's logsumexp of the kept,
    scaled and capped scores (float32 reference), +inf for a row that keeps
    no key (Sk = 0 here is not a case: every row keeps its diagonal)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v, _ = _bwd_inputs(cuda_device, 2, 90, 90, 4, 2, 64, dtype, 7)
    out, lse = fa(q, k, v, causal=True, window=16, softcap=30.0, return_lse=True)
    kk = k.float().repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * 64 ** -0.5
    s = 30.0 * torch.tanh(s / 30.0)
    i = torch.arange(90, device=cuda_device)
    keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 16)
    want = torch.logsumexp(torch.where(keep, s, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)
    _close(out, ref.flash_attention(q, k, v, causal=True, window=16, softcap=30.0),
           dtype, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (False, 0, 0.0),
                                               (True, 3, 5.0)])
def test_flash_attention_autograd_gradcheck(cuda_device, causal, window, cap):
    """FlashAttention under torch.autograd.gradcheck at a tiny float32
    shape (GQA 2/1, Sq 5 against Sk 7): finite differences with eps 1e-3,
    so atol = rtol = 1e-2 (float32 inputs, not float64)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((1, 5, 2, 8), generator=gen, device=cuda_device, requires_grad=True)
    k = torch.randn((1, 7, 1, 8), generator=gen, device=cuda_device, requires_grad=True)
    v = torch.randn((1, 7, 1, 8), generator=gen, device=cuda_device, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: dispatch.flash_attention(a, b, c, causal=causal, window=window,
                                                 softcap=cap),
        (q, k, v), eps=1e-3, atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("with_gate", [True, False], ids=["gate", "gate_none"])
def test_moe_functions_gradcheck(cuda_device, with_gate):
    """OnehotDispatch and OnehotCombine on CUDA tensors under
    torch.autograd.gradcheck (float32, eps 1e-3, so atol = rtol = 1e-2: the
    kernels take no float64), with dropped tuples (eff = -1, the sentinel
    eff = P, slots past capacity); each backward launches its kernels: the
    pack's one unpack, the unpack's one pack and, for dgate, one unpack."""
    rng = np.random.default_rng(7)
    g, t, pe, cap, d = 2, 24, 3, 5, 8
    eff = rng.integers(0, pe, (g, t)).astype(np.int32)
    slot = ops.occurrence_rank(torch.from_numpy(eff), pe).numpy()
    drop = rng.random((g, t))
    eff[drop < 0.1], eff[(drop >= 0.1) & (drop < 0.25)] = -1, pe
    slot[(drop >= 0.25) & (drop < 0.3)] = cap + 3
    eff, slot = (torch.from_numpy(a).to(cuda_device) for a in (eff, slot))
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((g, t, d), generator=gen, device=cuda_device, requires_grad=True)
    packed = torch.randn((g, pe, cap, d), generator=gen, device=cuda_device,
                         requires_grad=True)
    gate = torch.rand((g, t), generator=gen, device=cuda_device, requires_grad=True)
    before = (onehot_dispatch.launches, onehot_combine.launches)
    dispatch.onehot_dispatch(eff, slot, x, pe, cap).sum().backward()
    dispatch.onehot_combine(eff, slot, packed, gate if with_gate else None).sum().backward()
    torch.cuda.synchronize()
    assert (onehot_dispatch.launches - before[0],
            onehot_combine.launches - before[1]) == (2, 2 + with_gate)
    tol = {"eps": 1e-3, "atol": 1e-2, "rtol": 1e-2}
    assert torch.autograd.gradcheck(
        lambda v: dispatch.onehot_dispatch(eff, slot, v, pe, cap), (x,), **tol)
    if with_gate:
        assert torch.autograd.gradcheck(
            lambda p, gt: dispatch.onehot_combine(eff, slot, p, gt), (packed, gate), **tol)
    else:
        assert torch.autograd.gradcheck(
            lambda p: dispatch.onehot_combine(eff, slot, p), (packed,), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "llama3.2-3b", "gemma2-2b",
                                  "phi-3-vision-4.2b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b", "mamba2-780m",
                                  "jamba-1.5-large-398b"])
def test_loss_grads_on_card_match_cpu(cuda_device, arch):
    """The loss and every gradient of a REDUCED config in float32 (TF32
    off) on the card, under its default remat="full", through the flash
    forward and backward kernels and the MoE pack and unpack (per layer
    ``_train_launches``), against the CPU's plain path on the same weights
    and batch: the loss within rtol 1e-5, each gradient leaf within atol =
    1e-4 * (1 + its max) (sums in another order).  The MoE, SSM and hybrid
    configs take 2 x 64 tokens (two dispatch groups, four SSD chunks), the
    others 2 x 16."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models import zoo
    from repro_torch.models.transformer import tree_to
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch)
    cpu_model = zoo.build(cfg, device="cpu")
    params = cpu_model.init_params(cpu_model.generator(0))
    rng = np.random.default_rng(0)
    st = 64 if cfg.family in ("moe", "ssm", "hybrid") else 16
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, st + 1)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, cfg.encoder_len, cfg.d_model)).astype(np.float32)) * 0.02
    if cfg.num_patches:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.num_patches, cfg.patch_embed_dim)).astype(np.float32)) * 0.02
    assert cfg.remat == "full"
    kernels = (flash_attention, flash_attention_bwd, onehot_dispatch, onehot_combine)
    out = []
    for where in (cuda_device, torch.device("cpu")):
        model = zoo.build(cfg, device=where)
        leaves = tree_map(lambda p: p.detach().clone().requires_grad_(),
                          tree_to(params, where))
        before = [k.launches for k in kernels]
        loss, _ = model.loss_fn(leaves, {k: v.to(where) for k, v in batch.items()})
        loss.backward()
        torch.cuda.synchronize()
        if where.type == "cuda":
            assert [k.launches - n for k, n in zip(kernels, before)] == \
                _train_launches(cfg)
        out.append((float(loss.detach()), [t.grad.cpu() for t in tree_leaves(leaves)]))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for g, w in zip(g_gpu, g_cpu):
        assert bool(((g - w).abs() <= 1e-4 * (1 + w.abs().max())).all())


def _train_launches(cfg) -> list:
    """Launches of one loss and backward of ``cfg``: [flash forward, flash
    backward, MoE pack, MoE unpack].  An attention (or MLA) layer runs the
    flash forward once and its backward once; a MoE layer packs once and
    unpacks once, and its backward unpacks (the pack's transpose), packs
    and unpacks (the unpack's dpacked and dgate's rows).  Under remat other
    than "none" the backward recomputes every layer's forward first (each
    period's last saved tensor comes after its last kernel, so the early
    stop skips none): one more flash forward, pack and unpack a layer."""
    if cfg.family == "encdec":
        attn, moe = cfg.encoder_layers + 2 * cfg.num_layers, 0
    else:
        attn = sum(k != "mamba" for k in cfg.block_pattern) * cfg.num_periods
        moe = sum(k == "moe" for k in cfg.ffn_pattern) * cfg.num_periods
    fwd = 1 if cfg.remat == "none" else 2
    return [fwd * attn, attn, (fwd + 1) * moe, (fwd + 2) * moe]


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-lite-16b"])
def test_remat_grads_on_card_match_none(cuda_device, arch, remat):
    """The card's loss and gradients of a REDUCED MoE config (float32, TF32
    off, 2 x 64 tokens) under ``remat`` against the card's under "none" on
    the same weights and batch: the flash and MoE kernels run again in the
    recompute, and the MoE routing must recompute to the same slots.  The
    loss equal, each gradient leaf within atol = 1e-4 * (1 + its max), and
    each kernel launched as ``_train_launches`` counts."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models import zoo
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_reduced(arch)
    params = zoo.build(base, device=cuda_device).init_params(
        torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, base.vocab, (2, 65)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].to(cuda_device), "labels": toks[:, 1:].to(cuda_device)}
    kernels = (flash_attention, flash_attention_bwd, onehot_dispatch, onehot_combine)
    out = {}
    for r in ("none", remat):
        cfg = dataclasses.replace(base, remat=r)
        leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
        before = [k.launches for k in kernels]
        loss, _ = zoo.build(cfg, device=cuda_device).loss_fn(leaves, batch)
        loss.backward()
        torch.cuda.synchronize()
        assert [k.launches - n for k, n in zip(kernels, before)] == _train_launches(cfg)
        out[r] = (loss.detach().cpu(), [t.grad.cpu() for t in tree_leaves(leaves)])
    assert torch.equal(out[remat][0], out["none"][0])
    for g, w in zip(out[remat][1], out["none"][1]):
        assert bool(((g - w).abs() <= 1e-4 * (1 + w.abs().max())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_dry_run_residency_equals_the_cards(cuda_device, optimizer):
    """The dry run's bytes of a training state on a 1 x 1 mesh against what
    the card allocates for it: llama3.2-3b at full width, 2 of 28 layers
    (chip_smoke.py phase H (c) holds its 4-layer state the same way)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.launch.dryrun import train_state_bytes
    from repro_torch.models import zoo
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.train.state import TrainState
    cfg = dataclasses.replace(get("llama3.2-3b"), num_layers=2, optimizer=optimizer)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    model = zoo.build(cfg, device=cuda_device)
    params = model.init_params(model.generator(0))
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=cuda_device),
                       params=params,
                       opt_state=make_optimizer(optimizer, constant(1e-3)).init(params))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda_device) - before
    want = train_state_bytes(cfg, dict(kind="train", seq_len=1024, global_batch=2))
    assert abs(held - want) <= 0.02 * want, (held, want)
    del state, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- the public op API
def _launches():
    return {k.__name__: k.launches for k in (route_accumulate, cms_update, onehot_dispatch,
                                             onehot_combine, flash_attention)}


def _launched(before, name):
    """The op launched its kernel (once) and no other."""
    torch.cuda.synchronize()
    after = _launches()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == name) for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("combine", ["add", "max"])
def test_ops_scatter_accumulate_vs_plain(cuda_device, combine, dtype):
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(-5, 1000, 4096))         # int64, some dropped
    idx[:3] = torch.tensor([2**32 + 5, -1, 1000])
    val = _values(rng, 4096, dtype).to(DTYPES[dtype])
    want = ops.scatter_accumulate(idx, val, 1000, combine)
    before = _launches()
    got = ops.scatter_accumulate(idx.to(cuda_device), val.to(cuda_device), 1000, combine)
    _launched(before, "route_accumulate")
    _assert_same(got, want, exact=dtype == "int32" or combine == "max")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_cms_update_vs_plain(cuda_device, dtype):
    rng = np.random.default_rng(12)
    eff = torch.from_numpy(rng.integers(0, 16, 4096))             # int64
    eff[::7], eff[3::11] = -1, 16                                  # padding, sentinel
    cols = torch.from_numpy(rng.integers(0, 1024, (4096, 4)))
    val = _values(rng, 4096, dtype, signed=False).to(DTYPES[dtype])
    want = ops.cms_update(eff, cols, val, 16, 4, 1024)
    before = _launches()
    got = ops.cms_update(eff.to(cuda_device), cols.to(cuda_device), val.to(cuda_device),
                         16, 4, 1024)
    _launched(before, "cms_update")
    _assert_same(got, want, exact=dtype == "int32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("with_gate", [False, True])
def test_ops_onehot_pack_and_unpack_vs_plain(cuda_device, dtype, with_gate):
    rng = np.random.default_rng(13)
    eff, slot = _moe_cells(rng, 1, 512, 16, 40, True, cuda_device)
    eff, slot = eff[0], slot[0]
    x = torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32))
    x = x.to(cuda_device, FLOATS[dtype])
    gate = (torch.from_numpy(rng.random(512).astype(np.float32)).to(cuda_device)
            if with_gate else None)
    before = _launches()
    packed = ops.onehot_dispatch(eff, slot, x, 16, 40)
    _launched(before, "onehot_dispatch")
    _close(packed, ops.onehot_dispatch(eff.cpu(), slot.cpu(), x.cpu(), 16, 40), dtype, True)
    before = _launches()
    y = ops.onehot_combine(eff, slot, packed, gate)
    _launched(before, "onehot_combine")
    want = ops.onehot_combine(eff.cpu(), slot.cpu(), packed.cpu(),
                              None if gate is None else gate.cpu())
    _close(y, want, dtype, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("causal,window,h,kv", [(True, 0, 8, 8), (True, 64, 8, 2),
                                                (False, 0, 6, 2)])
def test_ops_flash_attention_vs_plain(cuda_device, dtype, causal, window, h, kv):
    gen = torch.Generator().manual_seed(14)
    q, k, v = (torch.randn((2, 256, n, 64), generator=gen) for n in (h, kv, kv))
    q, k, v = (t.to(cuda_device, FLOATS[dtype]) for t in (q, k, v))
    before = _launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    _launched(before, "flash_attention")
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    _close(got, want, dtype, False)


@pytest.mark.cuda
def test_hhd_heavy_hitters_on_card_equal_cpu(cuda_device):
    """The point query and the heavy-hitter set of a sketch on the card
    equal those of the same sketch on the CPU, bit for bit and in the
    candidates' order, with recall 1 against the true counts."""
    tuples = zipf_tuples(4096 * 8, 50000, 1.5, seed=15)
    keys = tuples[:, 0]
    merged = torch.as_tensor(hhd.oracle(keys, 4, 1024, 16)).to(torch.int32)
    cand = np.unique(keys)
    est = hhd.estimate(merged.to(cuda_device), cand, 4, 1024)
    assert est.is_cuda and torch.equal(est.cpu(), hhd.estimate(merged, cand, 4, 1024))
    thr = len(keys) // 1000
    got = hhd.heavy_hitters(merged.to(cuda_device), cand, 4, 1024, thr)
    want = hhd.heavy_hitters(merged, cand, 4, 1024, thr)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    true_hh = set(np.flatnonzero(np.bincount(keys) >= thr).tolist())
    assert true_hh and true_hh <= set(got.tolist())
