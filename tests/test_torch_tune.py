"""Parity of the port's autotuner (``repro_torch.tune``) with the JAX
package's, on the CPU.

The model pass must pick exactly what JAX picks: the same (M, X, chunk
size, W), the same float cycles per tuple for the tuned and the default
configuration, and the same static route plan, on Fig. 2's alpha grid (the
benchmark's own stream and sample), with an M search through a factory,
from a workload carry and through ``Ditto.tune``.  The measured pass runs
here on the CPU and must return a winner among its candidates; the tuned
plan drives ``make_executor`` bit-exact against the oracle.
"""
import numpy as np
import pytest
import torch

from repro.apps import histo as jhisto
from repro.core import analyzer as janalyzer
from repro.core import executor as jexecutor
from repro.core.framework import Ditto as JDitto
from repro.tune import SearchSpace as JSearchSpace
from repro.tune import autotune as jautotune
from repro.tune import autotune_from_workload as jautotune_from_workload
from repro.tune import default_space as jdefault_space
from repro_torch.apps import histo
from repro_torch.core import Ditto, executor
from repro_torch.core.profiler import workload_hist
from repro_torch.data.zipf import zipf_tuples
from repro_torch.tune import (SearchSpace, TunedPlan, autotune,
                              autotune_from_workload, default_space)

ALPHAS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0)          # benchmarks/fig2_skew.py
N_TUPLES, BINS, DOMAIN, CHUNK = 1 << 18, 512, 1 << 20, 4096
SAMPLE_ABS = 25600


def _fig2_sample(alpha):
    tuples = zipf_tuples(N_TUPLES, DOMAIN, alpha, seed=3)
    return tuples, janalyzer.sample_dataset(tuples, frac=min(1.0, SAMPLE_ABS / N_TUPLES))


def _same_plan(plan: TunedPlan, jplan):
    assert (plan.num_pri, plan.num_sec, plan.chunk_size, plan.mem_width_tuples,
            plan.cycles_per_tuple, plan.default_cycles_per_tuple, plan.source) == \
        (jplan.num_pri, jplan.num_sec, jplan.chunk_size, jplan.mem_width_tuples,
         jplan.cycles_per_tuple, jplan.default_cycles_per_tuple, jplan.source)
    for name in ("assignment", "table", "counter"):
        np.testing.assert_array_equal(getattr(plan.route_plan, name).numpy(),
                                      np.asarray(getattr(jplan.route_plan, name)),
                                      err_msg=name)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_model_pass_equal_jax_on_fig2(alpha):
    _, sample = _fig2_sample(alpha)
    plan = autotune(histo.make_spec(BINS, DOMAIN, 16), sample, tolerance=0.1,
                    space=SearchSpace(m_candidates=(16,), chunk_sizes=(CHUNK,)),
                    device="cpu")
    jplan = jautotune(jhisto.make_spec(BINS, DOMAIN, 16), sample, tolerance=0.1,
                      space=JSearchSpace(m_candidates=(16,), chunk_sizes=(CHUNK,)))
    _same_plan(plan, jplan)
    assert plan.modeled_speedup_vs_default == jplan.modeled_speedup_vs_default
    if alpha >= 1.5:
        assert plan.num_sec > 0


@pytest.mark.parametrize("alpha", [0.0, 1.5, 3.0])
def test_model_pass_equal_jax_with_m_search(alpha):
    """A factory opens the M axis: M in {8, 16, 32} around Eq. 1's 16."""
    _, sample = _fig2_sample(alpha)
    plan = autotune(lambda m: histo.make_spec(64, 1 << 16, m), sample, device="cpu")
    jplan = jautotune(lambda m: jhisto.make_spec(64, 1 << 16, m), sample)
    _same_plan(plan, jplan)
    assert plan.spec.init_buffer(1, "cpu").shape[1] == -(-64 // plan.num_pri)


def test_tuned_plan_drives_the_executor():
    """make_executor(spec, tuned) on the whole alpha=1.5 stream, started in
    RUN mode on the tuned route plan: the oracle, and JAX's modeled cycles."""
    tuples, sample = _fig2_sample(1.5)
    spec, jspec = histo.make_spec(BINS, DOMAIN, 16), jhisto.make_spec(BINS, DOMAIN, 16)
    plan = autotune(spec, sample, device="cpu")
    jplan = jautotune(jspec, sample)
    merged, stats = executor.make_executor(spec, plan, device="cpu")(
        torch.from_numpy(tuples.reshape(-1, CHUNK, 2)), plan.route_plan)
    np.testing.assert_array_equal(merged.numpy(), histo.oracle(tuples[:, 0], BINS, DOMAIN, 16))
    _, jstats = jexecutor.make_executor(jspec, jplan)(tuples.reshape(-1, CHUNK, 2),
                                                      jplan.route_plan)
    np.testing.assert_array_equal(stats.modeled_cycles.numpy(),
                                  np.asarray(jstats.modeled_cycles))
    # an explicit argument wins over the plan's
    res = executor.make_resumable_executor(spec, plan, chunk_size=512, device="cpu")
    assert (res.num_pri, res.num_sec, res.chunk_size) == (16, plan.num_sec, 512)
    with pytest.raises(TypeError, match="TunedPlan"):
        executor.make_executor(spec, 16, device="cpu")


def test_workload_carry_equal_jax():
    _, sample = _fig2_sample(1.5)
    spec = histo.make_spec(BINS, DOMAIN, 16)
    hist = workload_hist(spec.pre(torch.from_numpy(sample), 16)[0], 16).numpy()
    plan = autotune_from_workload(spec, hist, tolerance=0.1, device="cpu")
    jplan = jautotune_from_workload(jhisto.make_spec(BINS, DOMAIN, 16), hist, tolerance=0.1)
    _same_plan(plan, jplan)
    with pytest.raises(ValueError, match="fixes M"):
        autotune_from_workload(spec, hist, space=SearchSpace(m_candidates=(8,)),
                               device="cpu")
    with pytest.raises(ValueError, match="sample or a workload"):
        autotune(spec, device="cpu")


def test_ditto_tune_equal_jax():
    tuples, _ = _fig2_sample(2.0)
    plan = Ditto(histo.make_spec(BINS, DOMAIN, 16), chunk_size=CHUNK,
                 device="cpu").tune(tuples[:, 0])
    jplan = JDitto(jhisto.make_spec(BINS, DOMAIN, 16), chunk_size=CHUNK).tune(tuples[:, 0])
    _same_plan(plan, jplan)
    assert plan.route_plan.table.device.type == "cpu"


def test_measured_pass_on_the_cpu():
    """measure=True times every (top-k (M, X)) x chunk size candidate on the
    tuner's device and returns the fastest, its plan still the model's."""
    tuples, _ = _fig2_sample(1.5)
    d = Ditto(histo.make_spec(BINS, DOMAIN, 16), chunk_size=CHUNK, device="cpu")
    plan = d.tune(tuples[:, 0], measure=True, chunk_sizes=(256, 512), measure_chunks=2)
    assert plan.source == "measured"
    cands = plan.measured_candidates
    assert 2 <= len(cands) <= 4 and {c["chunk_size"] for c in cands} == {256, 512}
    best = min(cands, key=lambda c: c["seconds"])
    assert plan.measured_s == best["seconds"] > 0
    assert (plan.num_sec, plan.chunk_size) == (best["num_sec"], best["chunk_size"])
    head = tuples[:plan.chunk_size * 8]
    merged, _ = executor.make_executor(d.spec, plan, device="cpu")(
        torch.from_numpy(head.reshape(8, plan.chunk_size, 2)), plan.route_plan)
    np.testing.assert_array_equal(merged.numpy(), histo.oracle(head[:, 0], BINS, DOMAIN, 16))
    rec = plan.to_record()
    assert rec["source"] == "measured" and len(rec["measured_candidates"]) == len(cands)


def test_search_space():
    for m in (1, 4, 16):
        for search_m in (True, False):
            got = default_space(m, search_m=search_m, chunk_sizes=(1024, 2048))
            want = jdefault_space(m, search_m=search_m, chunk_sizes=(1024, 2048))
            assert (got.m_candidates, got.chunk_sizes) == (want.m_candidates, want.chunk_sizes)
    for bad in (dict(m_candidates=()), dict(m_candidates=(0,)),
                dict(m_candidates=(4,), chunk_sizes=())):
        with pytest.raises(ValueError):
            SearchSpace(**bad)
