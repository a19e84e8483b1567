"""Parity of the port's core runtime pieces (``repro_torch.core``) with the
JAX package: mapper (Fig. 4), scheduler (Fig. 5), profiler, merger,
perfmodel and the Eq. 2 analyzer.  Inputs are numpy arrays from a seed fed
to both packages; integer results match bit for bit, float32 results too
(the port keeps the reference's float32 arithmetic and operation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyzer as janalyzer
from repro.core import mapper as jmapper
from repro.core import merger as jmerger
from repro.core import perfmodel as jperf
from repro.core import profiler as jprofiler
from repro.core import scheduler as jscheduler
from repro.core.framework import tune_pe_counts as jtune_pe_counts
from repro_torch.core import (analyzer, mapper, merger, perfmodel, profiler,
                              scheduler)
from repro_torch.core.framework import tune_pe_counts

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _plan_eq(plan, jplan):
    for name in ("assignment", "table", "counter"):
        _eq(getattr(plan, name).numpy(), getattr(jplan, name))


# ---------------------------------------------------------------- Fig. 4
class TestMapper:
    def test_fig4_table_update(self):
        """Paper Fig. 4a/4b: 4 PriPEs, 3 SecPEs, {Sec4->Pri2, Sec5->Pri2,
        Sec6->Pri0}."""
        plan0 = mapper.init_plan(4, 3, CPU)
        assert plan0.counter.tolist() == [1, 1, 1, 1]
        assert plan0.table.tolist() == [[0] * 4, [1] * 4, [2] * 4, [3] * 4]
        plan = mapper.apply_schedule(plan0, torch.tensor([2, 2, 0], dtype=torch.int32))
        assert plan.counter.tolist() == [2, 1, 3, 1]
        assert plan.table.tolist() == [[0, 6, 0, 0], [1, 1, 1, 1],
                                       [2, 4, 5, 2], [3, 3, 3, 3]]
        _plan_eq(plan, jmapper.apply_schedule(jmapper.init_plan(4, 3),
                                              jnp.array([2, 2, 0], jnp.int32)))

    def test_fig4c_round_robin_sequence(self):
        """Fig. 4c: dst=0 alternates 0,6; dst=2 cycles 2,4,5."""
        plan = mapper.apply_schedule(mapper.init_plan(4, 3, CPU),
                                     torch.tensor([2, 2, 0], dtype=torch.int32))
        dst = torch.tensor([0, 0, 0, 0, 2, 2, 2, 2, 2, 2], dtype=torch.int32)
        rank, _ = mapper.occurrence_rank(dst, 4, torch.zeros(4, dtype=torch.int32))
        assert mapper.redirect(plan, dst, rank).tolist() == [0, 6, 0, 6, 2, 4, 5, 2, 4, 5]

    def test_round_robin_continues_across_chunks(self):
        plan = mapper.apply_schedule(mapper.init_plan(2, 1, CPU),
                                     torch.tensor([0], dtype=torch.int32))
        base = torch.zeros(2, dtype=torch.int32)
        seq = []
        for _ in range(3):
            dst = torch.tensor([0, 0, 0], dtype=torch.int32)
            rank, base = mapper.occurrence_rank(dst, 2, base)
            seq += mapper.redirect(plan, dst, rank).tolist()
        assert seq == [0, 2, 0, 2, 0, 2, 0, 2, 0]

    def test_unassigned_secs_ignored(self):
        plan = mapper.apply_schedule(mapper.init_plan(4, 3, CPU),
                                     torch.tensor([1, -1, -1], dtype=torch.int32))
        assert plan.counter.tolist() == [1, 2, 1, 1]
        assert plan.table[1].tolist() == [1, 4, 1, 1]

    @pytest.mark.parametrize("seed", range(6))
    def test_apply_schedule_vs_jax(self, seed):
        rng = np.random.default_rng(seed)
        m, x = int(rng.integers(1, 9)), int(rng.integers(0, 9))
        a = rng.integers(-1, m, x).astype(np.int32)
        _plan_eq(mapper.apply_schedule(mapper.init_plan(m, x, CPU), _t(a)),
                 jmapper.apply_schedule(jmapper.init_plan(m, x), jnp.asarray(a)))

    @pytest.mark.parametrize("seed", range(3))
    def test_rank_and_redirect_vs_jax(self, seed):
        rng = np.random.default_rng(seed)
        m, x, t = 8, 5, 300
        a = rng.integers(-1, m, x).astype(np.int32)
        dst = rng.integers(0, m, t).astype(np.int32)
        base = rng.integers(0, 1000, m).astype(np.int32)
        plan = mapper.apply_schedule(mapper.init_plan(m, x, CPU), _t(a))
        jplan = jmapper.apply_schedule(jmapper.init_plan(m, x), jnp.asarray(a))
        rank, nb = mapper.occurrence_rank(_t(dst), m, _t(base))
        jrank, jnb = jmapper.occurrence_rank(jnp.asarray(dst), m, jnp.asarray(base))
        _eq(rank.numpy(), jrank)
        _eq(nb.numpy(), jnb)
        _eq(mapper.redirect(plan, _t(dst), rank).numpy(),
            jmapper.redirect(jplan, jnp.asarray(dst), jrank))


# ---------------------------------------------------------------- Fig. 5
class TestScheduler:
    def test_fig5_greedy_max_splitting(self):
        """PriPE 2 is maximal for two iterations, then the next-hottest
        PriPE gets the third SecPE."""
        w = torch.tensor([150, 32, 400, 16], dtype=torch.float32)
        assert scheduler.schedule_secpes(w, 3).tolist() == [2, 2, 0]

    def test_oblivious_bound(self):
        """X = M-1 handles the worst case: all tuples to one PriPE."""
        w = torch.zeros(16)
        w[3] = 1e6
        a = scheduler.schedule_secpes(w, 15)
        assert (a == 3).all()
        assert float(scheduler.post_plan_max_load(w, a)) == pytest.approx(1e6 / 16)

    @pytest.mark.parametrize("seed", range(6))
    def test_schedule_and_post_load_vs_jax(self, seed):
        """Ties included (small integer workloads): the first maximum wins
        in both packages."""
        rng = np.random.default_rng(seed)
        m = int(rng.integers(1, 17))
        w = rng.integers(0, 6, m).astype(np.int32)
        x = int(rng.integers(0, m))
        a = scheduler.schedule_secpes(_t(w), x)
        ja = jscheduler.schedule_secpes(jnp.asarray(w), x)
        _eq(a.numpy(), ja)
        wf = (w / 3.0).astype(np.float32)
        _eq(scheduler.post_plan_max_load(_t(wf), a).numpy(),
            jscheduler.post_plan_max_load(jnp.asarray(wf), ja))
        _eq(scheduler.schedule_secpes(_t(w), x, min_load=3).numpy(),
            jscheduler.schedule_secpes(jnp.asarray(w), x, min_load=3))

    def test_plan_summary_matches(self):
        w, a = [10, 50, 5, 0], [1, 1, -1]
        assert scheduler.plan_summary(w, a) == jscheduler.plan_summary(w, a)


# ---------------------------------------------------------------- profiler
class TestProfiler:
    def test_workload_hist_drops_sentinel(self):
        dst = np.array([0, 3, 3, 4, 1, 4, 2], np.int32)     # 4 = sentinel M
        _eq(profiler.workload_hist(_t(dst), 4).numpy(),
            jprofiler.workload_hist(jnp.asarray(dst[dst < 4]), 4))

    def test_partial_hists_merge_to_global(self):
        dst = np.random.default_rng(2).integers(0, 8, 256).astype(np.int32)
        parts = profiler.partial_hists(_t(dst), 8, 4)
        _eq(parts.numpy(), jprofiler.partial_hists(jnp.asarray(dst), 8, 4))
        _eq(profiler.merge_partials(parts).numpy(),
            profiler.workload_hist(_t(dst), 8).numpy())

    @pytest.mark.parametrize("ref,ema,cycles,threshold", [
        (0.0, 0.0, 100.0, 0.5), (64.0, 0.0, 100.0, 0.5), (64.0, 90.0, 200.0, 0.5),
        (64.0, 90.0, 200.0, 0.0), (512.0, 600.0, 513.0, 0.9)])
    def test_monitor_vs_jax(self, ref, ema, cycles, threshold):
        st = profiler.MonitorState(torch.tensor(ref), torch.tensor(ema))
        jst = jprofiler.MonitorState(jnp.float32(ref), jnp.float32(ema))
        up = profiler.monitor_update(st, torch.tensor(cycles))
        jup = jprofiler.monitor_update(jst, jnp.float32(cycles))
        _eq(up.ema_cycles.numpy(), jup.ema_cycles)
        _eq(profiler.should_reschedule(up, threshold).numpy(),
            jprofiler.should_reschedule(jup, jnp.float32(threshold)))


# ---------------------------------------------------------------- merger
class TestMerger:
    @pytest.mark.parametrize("combine", ["add", "max"])
    @pytest.mark.parametrize("shape", [(6,), (2, 5)])
    def test_merge_and_reset_vs_jax(self, combine, shape):
        rng = np.random.default_rng(len(shape))
        m, x = 4, 5
        bufs = rng.integers(-50, 50, (m + x, *shape)).astype(np.int32)
        a = np.array([2, -1, 2, 0, -1], np.int32)    # PriPEs 1, 3 unshadowed
        got = merger.merge_buffers(_t(bufs), _t(a), m, combine)
        _eq(got.numpy(), jmerger.merge_buffers(jnp.asarray(bufs), jnp.asarray(a),
                                               m, combine))
        _eq(merger.reset_sec_buffers(_t(bufs), m, combine).numpy(),
            jmerger.reset_sec_buffers(jnp.asarray(bufs), m, combine))

    def test_merge_leaves_buffers_untouched(self):
        bufs = torch.arange(12, dtype=torch.int32).view(6, 2)
        before = bufs.clone()
        merger.merge_buffers(bufs, torch.tensor([0, 1], dtype=torch.int32), 4, "add")
        merger.reset_sec_buffers(bufs, 4, "max")
        assert torch.equal(bufs, before)


# ------------------------------------------------------- perfmodel / Eq. 1-2
@pytest.mark.parametrize("chunk,load,w,ii", [(4096, 256, 8, 2), (4096, 4096, 8, 2),
                                             (256, 7, 4, 2), (1000, 333, 3, 3)])
def test_chunk_cycles_vs_jax(chunk, load, w, ii):
    _eq(perfmodel.chunk_cycles(chunk, torch.tensor(load, dtype=torch.int32), w, ii).numpy(),
        jperf.chunk_cycles(chunk, jnp.int32(load), w, ii))
    _eq(perfmodel.chunk_cycles(chunk, torch.tensor(load / 3, dtype=torch.float32), w, ii).numpy(),
        jperf.chunk_cycles(chunk, jnp.float32(load / 3), w, ii))


def test_tune_pe_counts_eq1():
    assert tune_pe_counts(64, 8, 1, 2) == jtune_pe_counts(64, 8, 1, 2) == (8, 16, 8)


@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.0, 3.0])
@pytest.mark.parametrize("tolerance", [0.01, 0.1])
def test_analyzer_vs_jax(alpha, tolerance):
    from repro_torch.data.zipf import zipf_keys
    keys = zipf_keys(50_000, 1 << 12, alpha, seed=7)
    sample = analyzer.sample_dataset(keys, frac=0.1)
    np.testing.assert_array_equal(sample, janalyzer.sample_dataset(keys, frac=0.1))
    dst = (sample % 16).astype(np.int32)
    assert (analyzer.select_implementation(_t(dst), 16, tolerance)
            == janalyzer.select_implementation(jnp.asarray(dst), 16, tolerance))
    assert analyzer.select_implementation(_t(dst), 16, online=True) == 15
    assert analyzer.buffer_capacity_fraction(16, 15) == janalyzer.buffer_capacity_fraction(16, 15)
