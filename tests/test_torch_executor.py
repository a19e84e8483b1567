"""End-to-end parity of the port's streaming executor with the JAX package.

HISTO, HLL and HHD go through ``Ditto.build`` + ``run`` in both packages
on the same seeded streams (static plan, profiled plan, masked ragged
tail), HISTO also with threshold > 0 re-schedules on an evolving stream,
and a mid-stream ``ExecState`` is carried across with ``interop``.  The
merged buffers must match bit for bit (and the numpy oracle), and every
``ExecStats`` field chunk by chunk.  Small sizes: M = 8 (64-byte memory
word halved), chunks of 256 tuples.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.apps import hhd as jhhd
from repro.apps import histo as jhisto
from repro.apps import hll as jhll
from repro.core import executor as jexecutor
from repro.core.framework import Ditto as JDitto
from repro_torch import interop
from repro_torch.apps import hhd, histo, hll
from repro_torch.core import Ditto, executor
from repro_torch.core.types import ExecStats
from repro_torch.data.zipf import evolving_zipf_tuples, zipf_tuples

CHUNK = 256
MEM_WIDTH = 32          # Eq. 1: 32 B / 8 B tuples x II_pe 2 -> M = 8
APPS = {
    "histo": (lambda m: histo.make_spec(64, 1 << 16, m),
              lambda m: jhisto.make_spec(64, 1 << 16, m),
              lambda k, m: histo.oracle(k, 64, 1 << 16, m)),
    "hll": (lambda m: hll.make_spec(8, m), lambda m: jhll.make_spec(8, m),
            lambda k, m: hll.oracle(k, 8, m)),
    "hhd": (lambda m: hhd.make_spec(4, 128, m), lambda m: jhhd.make_spec(4, 128, m),
            lambda k, m: hhd.oracle(k, 4, 128, m)),
}


def _stats_eq(stats: ExecStats, jstats):
    for f in dataclasses.fields(ExecStats):
        got = getattr(stats, f.name).numpy()
        want = np.asarray(getattr(jstats, f.name))
        assert got.dtype == want.dtype, (f.name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def _pair(app, **kw):
    mk, jmk, oracle = APPS[app]
    d = Ditto(mk(8), chunk_size=CHUNK, mem_width_bytes=MEM_WIDTH, device="cpu", **kw)
    jd = JDitto(jmk(8), chunk_size=CHUNK, mem_width_bytes=MEM_WIDTH, **kw)
    assert d.num_pri == jd.num_pri == 8
    return d, jd, oracle


@pytest.mark.parametrize("app", list(APPS))
def test_profiled_plan_with_ragged_tail(app):
    """Ditto.build (Eq. 2 on a sample) picks the same X; the run profiles
    one chunk, plans, and pads the tail with a mask."""
    d, jd, oracle = _pair(app)
    tuples = zipf_tuples(CHUNK * 12 + 77, 1 << 16, 1.5, seed=21)
    impl, jimpl = d.build(tuples[:, 0]), jd.build(tuples[:, 0])
    assert impl.num_sec == jimpl.num_sec > 0
    chunks, mask = d.chunk_masked(tuples)
    merged, stats = impl.run(chunks, mask=mask)
    jchunks, jmask = jd.chunk_masked(tuples)
    jmerged, jstats = jimpl.run(jchunks, mask=jmask)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    np.testing.assert_array_equal(merged.numpy(), oracle(tuples[:, 0], 8))
    _stats_eq(stats, jstats)


@pytest.mark.parametrize("app", list(APPS))
def test_static_plan(app):
    d, jd, oracle = _pair(app)
    tuples = zipf_tuples(CHUNK * 8, 1 << 16, 2.0, seed=5)
    x = d.select(tuples[:, 0])
    workload = np.bincount(np.asarray(
        d.spec.pre(torch.from_numpy(tuples[:CHUNK]), 8)[0]), minlength=8)
    plan = executor.make_static_plan(8, x, workload, device="cpu")
    jplan = jexecutor.make_static_plan(8, x, workload)
    run = executor.make_executor(d.spec, 8, x, CHUNK, static_plan=True,
                                 mem_width_tuples=d.mem_width_tuples, device="cpu")
    jrun = jexecutor.make_executor(jd.spec, 8, x, CHUNK, static_plan=True,
                                   mem_width_tuples=jd.mem_width_tuples)
    merged, stats = run(d.chunk(tuples), plan)
    jmerged, jstats = jrun(jd.chunk(tuples), jplan)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    np.testing.assert_array_equal(merged.numpy(), oracle(tuples[:, 0], 8))
    _stats_eq(stats, jstats)


def test_histo_reschedules_on_evolving_skew():
    """threshold > 0: the monitor fires re-schedules when the hot key set
    moves; merges mid-stream keep the histogram exact."""
    d, jd, oracle = _pair("histo", threshold=0.9)
    tuples = evolving_zipf_tuples(CHUNK * 24, 1 << 16, 1.5, CHUNK * 6, seed=2)
    impl, jimpl = d.generate([5])[0], jd.generate([5])[0]
    merged, stats = impl.run(d.chunk(tuples))
    jmerged, jstats = jimpl.run(jd.chunk(tuples))
    assert int(np.asarray(jstats.rescheduled).sum()) > 0
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    np.testing.assert_array_equal(merged.numpy(), oracle(tuples[:, 0], 8))
    _stats_eq(stats, jstats)


@pytest.mark.parametrize("app", ["histo", "hll"])
def test_mid_stream_state_carried_across(app):
    """A JAX state after k chunks, moved into the port, continues exactly
    as the JAX executor continues it."""
    d, jd, _ = _pair(app, threshold=0.9 if app == "histo" else 0.0)
    tuples = evolving_zipf_tuples(CHUNK * 16, 1 << 16, 2.0, CHUNK * 4, seed=9)
    jres = jexecutor.make_resumable_executor(jd.spec, 8, 4, CHUNK, threshold=jd.threshold,
                                             mem_width_tuples=jd.mem_width_tuples)
    res = executor.make_resumable_executor(d.spec, 8, 4, CHUNK, threshold=d.threshold,
                                           mem_width_tuples=d.mem_width_tuples,
                                           device="cpu")
    jchunks = jd.chunk(tuples)
    mid, _ = jres.run_chunks(jres.init_state(), jchunks[:7])
    jend, jstats = jres.run_chunks(mid, jchunks[7:])
    state = interop.state_from_numpy(
        jax.tree.map(np.asarray, dataclasses.asdict(mid)), device="cpu")
    end, stats = res.run_chunks(state, d.chunk(tuples)[7:])
    _stats_eq(stats, jstats)
    got = interop.state_to_numpy(end)
    want = jax.tree.map(np.asarray, dataclasses.asdict(jend))
    for key in ("buffers", "rr_base", "mode", "profile_hist", "chunks_in_mode",
                "reschedules"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for sub in ("plan", "monitor"):
        for key, val in want[sub].items():
            np.testing.assert_array_equal(got[sub][key], val, err_msg=key)
    np.testing.assert_array_equal(res.merge_state(end).numpy(),
                                  np.asarray(jres.merge_state(jend)))


def test_zero_chunks_leave_the_state_as_it_was():
    """An empty stream (chunk_stream's zero-chunk contract) is a no-op."""
    d, _, _ = _pair("hll")
    res = executor.make_resumable_executor(d.spec, 8, 2, CHUNK, device="cpu")
    chunks, mask = d.chunk_masked(np.zeros((0, 2), np.int32))
    assert chunks.shape[0] == 0
    state, stats = res.run_chunks(res.init_state(), chunks, mask)
    assert stats.workload.shape == (0, 8) and stats.modeled_cycles.shape == (0,)
    assert int(state.mode) == 0 and int(state.buffers.abs().sum()) == 0


def test_run_chunks_leaves_caller_state_untouched():
    d, _, _ = _pair("histo")
    res = executor.make_resumable_executor(d.spec, 8, 3, CHUNK, device="cpu")
    state = res.init_state()
    before = interop.state_to_numpy(state)
    tuples = zipf_tuples(CHUNK * 3, 1 << 16, 1.0, seed=1)
    res.run_chunks(state, d.chunk(tuples))
    after = interop.state_to_numpy(state)
    np.testing.assert_array_equal(after["buffers"], before["buffers"])
    np.testing.assert_array_equal(after["rr_base"], before["rr_base"])


def test_fig2_headline_reproduced():
    """Paper Fig. 2b: HISTO with X = 0 at alpha = 3 runs at 0.0809 of its
    uniform throughput in the modeled cycles, the headline the JAX bench
    recorded in BENCH_results.json (``--fast``: 2^16 tuples, seed 3)."""
    spec, jspec = histo.make_spec(512, 1 << 20, 16), jhisto.make_spec(512, 1 << 20, 16)
    d = Ditto(spec, chunk_size=4096, device="cpu")
    jd = JDitto(jspec, chunk_size=4096)
    impl, jimpl = d.generate([0])[0], jd.generate([0])[0]
    cycles = {}
    for alpha in (0.0, 3.0):
        tuples = zipf_tuples(1 << 16, 1 << 20, alpha, seed=3)
        _, stats = impl.run(d.chunk(tuples))
        _, jstats = jimpl.run(jd.chunk(tuples))
        _stats_eq(stats, jstats)
        cycles[alpha] = float(stats.modeled_cycles.sum())
    assert round(cycles[0.0] / cycles[3.0], 4) == 0.0809


def test_entry_points_default_to_cuda():
    """Without a CUDA device every entry point raises instead of falling
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = histo.make_spec(64, 1 << 16, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.make_executor(spec, 8, 0, CHUNK)
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.make_resumable_executor(spec, 8, 0, CHUNK)
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.init_state(spec, 8, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.make_static_plan(8, 1, np.ones(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        Ditto(spec)
