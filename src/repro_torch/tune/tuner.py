"""Perfmodel-guided autotuner.

The paper's workflow picks only X (the SecPE count, Eq. 2) offline and fixes
M and the chunk size by hand.  ``autotune`` searches the three axes in two
passes:

  1. **model pass**: for every (M, X) candidate, schedule the sampled
     workload (core.scheduler) and score the port-limited cycles per tuple
     with ``core.perfmodel.chunk_cycles``.  Candidates within ``tolerance``
     of the best prediction tie; ties go to the fewest SecPEs (buffer
     capacity M/(M+X), paper §V-C), then the fewest PriPEs.
  2. **measured pass** (optional): the top-k (M, X) points are crossed with
     the chunk sizes, which the cycle model cannot rank, and each is built
     into a real executor on the tuner's device and timed on the sample;
     the fastest wall clock wins.

The X candidates per M are {0, the Eq. 2 pick, M-1}: the analyzer is the
paper's X selector, and the tuner checks it against the two extremes.

The input is either a raw dataset sample (the paper's offline 0.1%) or a
live profiler carry: the per-PriPE workload histogram of PROFILE mode
(``ExecStats.workload`` summed, or the state's ``profile_hist``).

The result is a ``TunedPlan``, which ``make_executor`` and
``make_resumable_executor`` take in place of ``num_pri``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import analyzer, perfmodel, scheduler
from repro_torch.core import executor as core_executor
from repro_torch.core.profiler import workload_hist
from repro_torch.core.types import DittoSpec, RoutePlan, resolve_device
from repro_torch.tune.space import Candidate, SearchSpace, default_space

SpecOrFactory = Union[DittoSpec, Callable[[int], DittoSpec]]


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The tuner's output: a full executor configuration and a static plan.

    ``route_plan`` is the SecPE schedule made from the sampled workload (the
    offline path's pre-made plan), on the tuner's device: pass it to the
    executor to start in RUN mode, or leave it out and let the runtime
    profiler make a plan online.

    ``cycles_per_tuple`` / ``default_cycles_per_tuple`` are the
    port-limited model's predictions for the tuned configuration and for
    the paper's default (Eq. 1 M, X = 0) on the same workload.
    """

    num_pri: int
    num_sec: int
    chunk_size: int
    mem_width_tuples: int
    route_plan: Optional[RoutePlan]
    cycles_per_tuple: float
    default_cycles_per_tuple: float
    measured_s: Optional[float] = None
    measured_candidates: Optional[tuple] = None
    source: str = "model"            # 'model' | 'measured'
    spec: Optional[DittoSpec] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def modeled_throughput(self) -> float:
        """Predicted tuples per cycle of the tuned configuration."""
        return 1.0 / self.cycles_per_tuple

    @property
    def default_throughput(self) -> float:
        """Predicted tuples per cycle of the paper's default (Eq. 1 M, X=0)."""
        return 1.0 / self.default_cycles_per_tuple

    @property
    def modeled_speedup_vs_default(self) -> float:
        return self.default_cycles_per_tuple / self.cycles_per_tuple

    def executor_kwargs(self) -> dict:
        """The knobs the executors unpack when handed a TunedPlan."""
        return dict(num_pri=self.num_pri, num_sec=self.num_sec,
                    chunk_size=self.chunk_size,
                    mem_width_tuples=self.mem_width_tuples)

    def to_record(self) -> dict:
        """A JSON-able summary."""
        return {
            "num_pri": self.num_pri,
            "num_sec": self.num_sec,
            "chunk_size": self.chunk_size,
            "mem_width_tuples": self.mem_width_tuples,
            "cycles_per_tuple": self.cycles_per_tuple,
            "default_cycles_per_tuple": self.default_cycles_per_tuple,
            "modeled_speedup_vs_default": self.modeled_speedup_vs_default,
            "measured_s": self.measured_s,
            "measured_candidates": (list(self.measured_candidates)
                                    if self.measured_candidates else None),
            "source": self.source,
        }


def predict_cycles_per_tuple(hist, num_sec: int, mem_width_tuples: int,
                             ii_pe: int) -> float:
    """Model-pass score: port-limited cycles per tuple after scheduling
    ``num_sec`` SecPEs onto the workload histogram (lower is better; 1/W is
    the port-bound optimum)."""
    hist = torch.as_tensor(hist)
    assignment = scheduler.schedule_secpes(hist, num_sec)
    max_load = scheduler.post_plan_max_load(hist.to(torch.float32), assignment)
    total = float(max(int(hist.sum()), 1))
    cycles = float(perfmodel.chunk_cycles(total, max_load, mem_width_tuples, ii_pe))
    return cycles / total


def static_plan_from_hist(hist: torch.Tensor, num_pri: int, num_sec: int) -> RoutePlan:
    """Offline plan on the histogram's device: sampled workload -> greedy
    schedule -> mapping table."""
    return core_executor.make_static_plan(num_pri, num_sec, hist, device=hist.device)


def _as_tuple_rows(sample) -> np.ndarray:
    sample = np.asarray(sample)
    if sample.ndim == 1:              # bare keys -> single-column tuples
        sample = sample[:, None]
    return sample


def _hist_for(spec: DittoSpec, sample: np.ndarray, num_pri: int,
              device: torch.device) -> torch.Tensor:
    dst, _, _ = spec.pre(torch.as_tensor(sample, device=device), num_pri)
    return workload_hist(dst, num_pri)


def _measure_wallclock(spec: DittoSpec, cand: Candidate, plan: RoutePlan,
                       sample: np.ndarray, mem_width_tuples: int,
                       measure_chunks: int, iters: int,
                       device: torch.device) -> float:
    """Seconds per pass of a real executor over the sample, in steady RUN
    mode under the candidate's static plan.  One warm-up pass first (it also
    builds the kernels on the card); on the card the clock stops after a
    synchronize."""
    need = cand.chunk_size * measure_chunks
    reps = -(-need // len(sample))
    data = np.tile(sample, (reps, 1))[:need]
    stream = torch.as_tensor(
        data.reshape(measure_chunks, cand.chunk_size, *data.shape[1:]), device=device)
    run = core_executor.make_executor(
        spec, cand.num_pri, cand.num_sec, cand.chunk_size,
        mem_width_tuples=mem_width_tuples, static_plan=True, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run(stream, plan)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        run(stream, plan)
    sync()
    return (time.perf_counter() - t0) / iters


def autotune(
    spec_or_factory: SpecOrFactory,
    sample=None,
    *,
    workload=None,
    mem_width_bytes: int = 64,
    space: Optional[SearchSpace] = None,
    tolerance: float = 0.1,
    top_k: int = 2,
    measure: bool = False,
    measure_chunks: int = 4,
    measure_iters: int = 2,
    device="cuda",
) -> TunedPlan:
    """Search (M, X, chunk size) for one workload.

    Args:
      spec_or_factory: a DittoSpec (no M search: the app's state is sized
        for one M), or a factory ``m -> DittoSpec`` to search PriPE counts.
      sample: raw tuple sample ([n] keys or [n, cols] tuples), the paper's
        offline 0.1% sample.  Required unless ``workload`` is given.
      workload: live profiler carry, an [M] per-PriPE workload histogram.
        Fixes M to len(workload) and turns the measured pass off.
      mem_width_bytes: memory-interface width (Eq. 1 numerator).
      space: SearchSpace override; default the Eq. 1 neighbourhood of M*.
      tolerance: the Eq. 2 tolerance AND the model pass's tie band:
        candidates within ``(1 + tolerance)`` of the best prediction tie and
        go to the cheapest (fewest SecPEs, then fewest PriPEs).
      top_k: (M, X) points carried into the measured pass.
      measure: run the measured wall-clock pass (needs ``sample``).
      measure_chunks/measure_iters: the measured pass's stream size and
        timing repetitions.
      device: where the histograms, the plans and the measured executors
        live ("cuda" raises without a CUDA device).

    Returns a TunedPlan (see the class docstring).
    """
    device = resolve_device(device)
    if sample is None and workload is None:
        raise ValueError("autotune needs a dataset sample or a workload hist")
    if isinstance(spec_or_factory, DittoSpec):
        fixed = spec_or_factory
        factory = lambda m: fixed                          # noqa: E731
        search_m = False
        probe = fixed
    else:
        factory = spec_or_factory
        search_m = True
        probe = factory(1)
    w = max(1, mem_width_bytes // probe.tuple_bytes)
    m_star = w * probe.ii_pe

    if workload is not None:
        workload = torch.as_tensor(workload, device=device)
        space = space or SearchSpace(m_candidates=(len(workload),))
        if space.m_candidates != (len(workload),):
            raise ValueError(
                "a workload carry fixes M to its own length "
                f"{len(workload)}; got m_candidates={space.m_candidates}")
        measure = False
    else:
        sample = _as_tuple_rows(sample)
        space = space or default_space(m_star, search_m=search_m)

    def hist_at(m, spec_m):
        return workload if workload is not None else _hist_for(spec_m, sample, m, device)

    # ---- pass 1: the port-limited model over (M, X)
    scored = []   # (cpt, num_sec, num_pri, spec_m, hist)
    for m in space.m_candidates:
        spec_m = factory(m)
        hist = hist_at(m, spec_m)
        x_eq2 = analyzer.secpes_for_workload(hist, tolerance)
        for x in sorted({0, x_eq2, m - 1}):
            cpt = predict_cycles_per_tuple(hist, x, w, spec_m.ii_pe)
            scored.append((cpt, x, m, spec_m, hist))
    best_cpt = min(s[0] for s in scored)
    band = [s for s in scored if s[0] <= best_cpt * (1.0 + tolerance)]
    band.sort(key=lambda s: (s[1], s[2], s[0]))   # fewest X, then fewest M

    # the paper's default: Eq. 1 M, X = 0, on the same workload
    m_def = len(workload) if workload is not None else m_star
    spec_def = factory(m_def)
    default_cpt = predict_cycles_per_tuple(hist_at(m_def, spec_def), 0, w,
                                           spec_def.ii_pe)

    def finish(cpt, x, m, spec_m, hist, chunk, measured_s=None,
               measured_candidates=None, source="model"):
        return TunedPlan(
            num_pri=m, num_sec=x, chunk_size=chunk, mem_width_tuples=w,
            route_plan=static_plan_from_hist(hist, m, x),
            cycles_per_tuple=cpt, default_cycles_per_tuple=default_cpt,
            measured_s=measured_s, measured_candidates=measured_candidates,
            source=source, spec=spec_m)

    if not measure:
        cpt, x, m, spec_m, hist = band[0]
        return finish(cpt, x, m, spec_m, hist, space.chunk_sizes[0])

    # ---- pass 2: the wall clock of top-k x chunk sizes
    results = []
    for cpt, x, m, spec_m, hist in band[:top_k]:
        plan = static_plan_from_hist(hist, m, x)
        for chunk in space.chunk_sizes:
            s = _measure_wallclock(spec_m, Candidate(m, x, chunk), plan, sample,
                                   w, measure_chunks, measure_iters, device)
            results.append((s, cpt, x, m, spec_m, hist, chunk))
    results.sort(key=lambda r: r[0])
    s, cpt, x, m, spec_m, hist, chunk = results[0]
    measured = tuple({"num_pri": r[3], "num_sec": r[2], "chunk_size": r[6],
                      "seconds": r[0]} for r in results)
    return finish(cpt, x, m, spec_m, hist, chunk, measured_s=s,
                  measured_candidates=measured, source="measured")


def autotune_from_workload(spec: DittoSpec, workload, **kw) -> TunedPlan:
    """Tune from a live profiler carry (an [M] workload histogram)."""
    return autotune(spec, workload=workload, **kw)
