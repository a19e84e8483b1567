"""The streaming executor: chunks in, merged buffers out (paper Fig. 3).

  chunk -> PrePEs (spec.pre) -> data routing (mapper.redirect) ->
  PriPEs/SecPEs (pe_update on the partitioned buffers) -> merger

The PyTorch counterpart of ``repro/core/executor.py``.  ``lax.scan``
becomes a Python loop over chunks.  The runtime profiler, scheduler and the
PROFILE -> RUN -> re-schedule mode machine stay branch-free: every decision
is a ``torch.where`` on device tensors, so a chunk step never waits for the
device.

Three shapes share one chunk step (``_build_chunk_step``):

  * ``make_executor`` -- one-shot: init -> chunks -> merge;
  * ``make_resumable_executor`` -- the caller owns the ``ExecState`` between
    calls (``step``, ``run_chunks``, ``merge_state``, and ``scan_lanes``
    for a lanes-stacked state);
  * ``make_multistream_executor`` -- S streams as S lanes of one batched
    step.  Where JAX vmaps the scan, every ``ExecState`` leaf here gains a
    leading lanes axis [L] (``stack_states``, ``take_lanes``,
    ``put_lanes``); the PE update sees the lanes as L * (M+X) PEs, so it
    stays one kernel launch a chunk.  A spec with its own ``merge`` (DP)
    keeps per-lane regions: its ``pe_update`` takes the lanes axis itself.

All take an optional per-tuple validity mask beside the chunks: a masked
tuple goes to the sentinel PriPE M and effective PE M+X, which every
histogram and buffer update drops, so a padded chunk is bit-identical to a
shorter one.  All also take a ``TunedPlan`` (``repro_torch.tune``) in
place of ``num_pri``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import torch

from repro_torch.core import mapper, merger, perfmodel, profiler, scheduler
from repro_torch.core.types import (PROFILE_MODE, RUN_MODE, DittoSpec,
                                    ExecStats, RoutePlan, resolve_device)
from repro_torch.kernels import dispatch


def default_pe_update(buffers, eff, idx, value, combine: str):
    """PriPE/SecPE buffer update through ``dispatch.pe_buffer_update``: the
    plain version on the CPU, the ``route_accumulate`` kernel on CUDA.
    Folds into ``buffers`` in place."""
    return dispatch.pe_buffer_update(buffers, eff, idx, value, combine)


@dataclasses.dataclass(frozen=True)
class ExecState:
    buffers: Any            # [M+X, *local] tensor, or a dataclass of them (DP)
    plan: RoutePlan
    rr_base: torch.Tensor
    mode: torch.Tensor
    profile_hist: torch.Tensor
    chunks_in_mode: torch.Tensor
    monitor: profiler.MonitorState
    reschedules: torch.Tensor

    def clone(self) -> "ExecState":
        """A copy that shares no tensor with this state."""
        return _tree_map(torch.clone, self)


def _tree_map(fn, *objs):
    """Apply ``fn`` leaf-wise over dataclasses of tensors of one type."""
    first = objs[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: _tree_map(fn, *(getattr(o, f.name) for o in objs))
            for f in dataclasses.fields(first)})
    return fn(*objs)


def _lanewise(cond: torch.Tensor, dim: int) -> torch.Tensor:
    """``cond`` [L] (one flag a lane) viewed to broadcast against a tensor
    of ``dim`` dimensions whose leading axis is the lanes axis; a 0-dim
    ``cond`` broadcasts as it is."""
    return cond.view(*cond.shape, *([1] * (dim - 1))) if cond.dim() else cond


def _pick(cond: torch.Tensor, new, old):
    """Field-wise ``torch.where(cond, new, old)``, lane by lane."""
    return _tree_map(lambda a, b: torch.where(_lanewise(cond, b.dim()), a, b),
                     new, old)


def _tracer_of(obs):
    """``obs``'s span tracer, or for no bundle a disabled one (its spans
    and stages are the shared no-op)."""
    if obs is not None:
        return obs.tracer
    # a lazy import, as repro_torch.obs imports repro_torch.core
    from repro_torch.obs.trace import SpanTracer
    return SpanTracer(enabled=False)


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def init_state(spec: DittoSpec, num_pri: int, num_sec: int,
               device="cuda") -> ExecState:
    device = resolve_device(device)
    return ExecState(
        buffers=spec.init_buffer(num_pri + num_sec, device),
        plan=mapper.init_plan(num_pri, num_sec, device),
        rr_base=torch.zeros((num_pri,), dtype=torch.int32, device=device),
        mode=_scalar(PROFILE_MODE, torch.int32, device),
        profile_hist=torch.zeros((num_pri,), dtype=torch.int32, device=device),
        chunks_in_mode=_scalar(0, torch.int32, device),
        monitor=profiler.MonitorState.fresh(device),
        reschedules=_scalar(0, torch.int32, device))


def with_plan(state: ExecState, plan: RoutePlan) -> ExecState:
    """Seed a state with a pre-made plan and start it in RUN mode (a
    lanes-stacked state takes a lanes-stacked plan, ``stack_plans``)."""
    return dataclasses.replace(state, plan=plan,
                               mode=torch.full_like(state.mode, RUN_MODE))


def _resolve_config(num_pri, num_sec, chunk_size,
                    mem_width_tuples) -> tuple[int, int, int, int]:
    """(num_pri | TunedPlan, num_sec, chunk_size, mem_width_tuples) ->
    explicit executor knobs; an argument given explicitly wins over the
    plan's."""
    if hasattr(num_pri, "executor_kwargs"):
        tuned = num_pri.executor_kwargs()
        num_pri = tuned["num_pri"]
        if num_sec is None:
            num_sec = tuned["num_sec"]
        if chunk_size is None:
            chunk_size = tuned["chunk_size"]
        if mem_width_tuples is None:
            mem_width_tuples = tuned["mem_width_tuples"]
    if num_sec is None or chunk_size is None:
        raise TypeError("an executor needs (num_pri, num_sec, chunk_size) "
                        "or a TunedPlan in place of num_pri")
    if mem_width_tuples is None:
        mem_width_tuples = 8
    return num_pri, num_sec, chunk_size, mem_width_tuples


def _lane_pe_update(pe_update, buffers, eff, idx, value, num_pe: int):
    """The PE update of a lanes-stacked chunk: lanes are more PEs.  Lane
    l's PE p is row l * num_pe + p of the buffers viewed [L * num_pe, ...],
    so one call (one kernel launch on the card) folds every lane.  The
    masked sentinel eff = num_pe becomes -1 before the offset, or it would
    land in the next lane's PriPE 0."""
    lanes = eff.shape[0]
    base = torch.arange(lanes, dtype=eff.dtype, device=eff.device)[:, None] * num_pe
    flat_eff = torch.where(eff < num_pe, eff + base, -1).reshape(-1)
    flat = pe_update(buffers.reshape(lanes * num_pe, *buffers.shape[2:]), flat_eff,
                     idx.reshape(-1, *idx.shape[2:]).contiguous(),
                     value.reshape(-1, *value.shape[2:]).contiguous())
    return flat.view(buffers.shape)


def _build_chunk_step(spec: DittoSpec, num_pri: int, num_sec: int,
                      chunk_size: int, *, profile_chunks: int,
                      threshold: float, mem_width_tuples: int,
                      static_plan: bool, pe_update, obs=None) -> Callable:
    """The per-chunk body shared by every executor shape:
    ``(state, chunk, mask) -> (state, stats)``.  ``mask`` is None (dense
    chunk) or bool[chunk_size].  A lanes-stacked state (``stack_states``:
    every leaf with a leading [L] axis) takes chunk [L, chunk_size, ...]
    and mask bool[L, chunk_size], and each lane keeps its own plan, mode,
    monitor and re-schedule counter.  The step folds into
    ``state.buffers`` in place; every other field of the returned state
    is a new tensor, except that under ``threshold == 0`` it hands back
    the input's ``reschedules``, and a settled step the input's ``plan``
    and ``mode`` too.

    A settled step (the private keyword ``_settled``, which only the
    executor's own loops pass, from ``_settled_steps``) is one on which
    the caller has proven that no lane can take a plan: it skips the
    SecPE plan's generation, whose result would not be picked, and
    returns what the full step returns, bit for bit.  The step's
    ``settles_after`` attribute is the bound ``_settled_steps`` proves it
    with: the live steps after which a lane can take no plan and never
    fires (None under ``threshold > 0`` or a static plan: no step
    settles).

    With an ``obs`` bundle whose tracer is on, each step is an
    ``executor.step`` span holding its stages, one staged span
    (``SpanTracer.stages``: a clock read a stage): ``executor.route``
    (PrePE, mask, workload histogram, occurrence rank, redirect),
    ``executor.pe_update``, on a full step of the runtime profiler
    ``executor.plan`` (profiler, SecPE plan generation, reference cycles),
    and ``executor.schedule`` (cycle model, the mode machine's picks,
    monitor, re-schedule, stats; a settled step's profiler too).  With
    ``obs=None`` the step emits no span."""
    num_pe = num_pri + num_sec
    tracer = _tracer_of(obs)

    def route(state: ExecState, chunk: torch.Tensor, mask: Optional[torch.Tensor]):
        # `live` gates every carry update that counts chunks: a fully
        # masked chunk leaves the window, monitor and mode as they were.
        live = None if mask is None else mask.any(dim=-1)
        dst, idx, value = spec.pre(chunk, num_pri)
        if mask is not None:
            dst = torch.where(mask, dst, num_pri)
        workload = profiler.workload_hist(dst, num_pri)

        # data routing: designated PE -> effective PE (mapper, Fig. 4c)
        rank, rr_base = mapper.occurrence_rank(dst, num_pri, state.rr_base)
        eff = mapper.redirect(state.plan, dst, rank)
        if mask is not None:
            eff = torch.where(mask, eff, num_pe)
        return live, workload, rr_base, eff, idx, value

    def update(state: ExecState, eff, idx, value):
        if state.mode.dim() and spec.merge is None:
            return _lane_pe_update(pe_update, state.buffers, eff, idx, value, num_pe)
        # one stream, or a spec whose update takes the lanes axis
        return pe_update(state.buffers, eff, idx, value)

    def profile(state: ExecState, live, workload):
        # runtime profiler: PROFILE mode accumulates the workload hist
        in_profile = state.mode == PROFILE_MODE
        profile_hist = torch.where(_lanewise(in_profile, 2),
                                   state.profile_hist + workload, state.profile_hist)
        chunks_in_mode = state.chunks_in_mode + \
            (1 if live is None else live.to(torch.int32))
        return in_profile, profile_hist, chunks_in_mode

    def make_plan(state: ExecState, live, workload):
        # the SecPE plan of the profiled window (Fig. 5), which a lane
        # takes on its PROFILE -> RUN step, and its reference cycles
        in_profile, profile_hist, chunks_in_mode = profile(state, live, workload)
        assignment = scheduler.schedule_secpes(profile_hist, num_sec)
        new_plan = mapper.apply_schedule(state.plan, assignment)
        post_load = scheduler.post_plan_max_load(
            profile_hist.to(torch.float32)
            / _lanewise(chunks_in_mode.clamp(min=1), 2), assignment)
        ref_cycles = perfmodel.chunk_cycles(chunk_size, post_load,
                                            mem_width_tuples, spec.ii_pe)
        return in_profile, profile_hist, chunks_in_mode, new_plan, ref_cycles

    def schedule(state: ExecState, buffers, live, workload, rr_base, eff, planned):
        lanes = state.mode.dim()          # 0: one stream, 1: [L] lanes
        # port-limited cycle model for the monitor and the stats
        max_load = profiler.workload_hist(eff, num_pe).amax(dim=-1)
        cycles = perfmodel.chunk_cycles(chunk_size, max_load,
                                        mem_width_tuples, spec.ii_pe)

        if static_plan:
            stats = ExecStats(max_load=max_load, modeled_cycles=cycles,
                              mode=torch.full_like(state.mode, RUN_MODE),
                              rescheduled=torch.zeros_like(state.mode, dtype=torch.bool),
                              workload=workload)
            return dataclasses.replace(state, buffers=buffers, rr_base=rr_base), stats

        if planned is None:
            # a settled step: no lane is ready for a plan, so plan and
            # mode stay as they are and the monitor only takes its update
            _, profile_hist, chunks_in_mode = profile(state, live, workload)
            plan, monitor, mode = state.plan, state.monitor, state.mode
            steady = mode == RUN_MODE
        else:
            # PROFILE -> RUN: apply the SecPE plan (Fig. 5)
            in_profile, profile_hist, chunks_in_mode, new_plan, ref_cycles = planned
            plan_ready = in_profile & (chunks_in_mode >= profile_chunks)
            if live is not None:
                plan_ready = plan_ready & live
            plan = _pick(plan_ready, new_plan, state.plan)
            monitor = _pick(plan_ready,
                            profiler.MonitorState(ref_cycles=ref_cycles,
                                                  ema_cycles=torch.zeros_like(ref_cycles)),
                            state.monitor)
            mode = torch.where(plan_ready, RUN_MODE, state.mode)
            chunks_in_mode = torch.where(plan_ready, 0, chunks_in_mode)
            steady = (mode == RUN_MODE) & ~plan_ready

        # RUN mode: throughput monitoring -> re-schedule trigger (§IV-B)
        if live is not None:
            steady = steady & live
        monitor = _pick(steady, profiler.monitor_update(monitor, cycles), monitor)
        fire = torch.zeros_like(state.mode, dtype=torch.bool)
        reschedules = state.reschedules
        if threshold > 0.0:   # otherwise `fire` is always False
            fire = steady & profiler.should_reschedule(monitor, threshold)
            merged = merger.merge_buffers(buffers, plan.assignment, num_pri,
                                          spec.combine)
            resched = merger.reset_sec_buffers(buffers, num_pri, spec.combine,
                                               pe_axis=lanes)
            resched.narrow(lanes, 0, num_pri).copy_(merged)
            buffers = _pick(fire, resched, buffers)
            plan = _pick(fire, mapper.init_plan(num_pri, num_sec, mode.device), plan)
            mode = torch.where(fire, PROFILE_MODE, mode)
            profile_hist = torch.where(_lanewise(fire, 2), 0, profile_hist)
            chunks_in_mode = torch.where(fire, 0, chunks_in_mode)
            monitor = _pick(fire, profiler.MonitorState.fresh(mode.device), monitor)
            reschedules = reschedules + fire.to(torch.int32)

        stats = ExecStats(max_load=max_load, modeled_cycles=cycles,
                          mode=state.mode, rescheduled=fire, workload=workload)
        new_state = ExecState(buffers=buffers, plan=plan, rr_base=rr_base,
                              mode=mode, profile_hist=profile_hist,
                              chunks_in_mode=chunks_in_mode, monitor=monitor,
                              reschedules=reschedules)
        return new_state, stats

    def chunk_step(state: ExecState, chunk: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *, _settled: bool = False):
        with tracer.stages("executor.step", cat="executor") as stage:
            stage("executor.route")
            live, workload, rr_base, eff, idx, value = route(state, chunk, mask)
            stage("executor.pe_update")
            buffers = update(state, eff, idx, value)
            planned = None
            if not (static_plan or _settled):
                stage("executor.plan")
                planned = make_plan(state, live, workload)
            stage("executor.schedule")
            return schedule(state, buffers, live, workload, rr_base, eff, planned)

    chunk_step.settles_after = None if threshold > 0.0 or static_plan \
        else max(profile_chunks, 1)
    return chunk_step


def _settled_steps(settles_after: Optional[int], mask, lanes: int,
                   num_steps: int) -> list:
    """Which of a call's ``num_steps`` chunk steps are settled: every lane
    is either not live at the step (its chunk fully masked) or has had
    ``settles_after`` live steps earlier in the call.  A lane in PROFILE
    takes its plan on its ``profile_chunks``-th live step at the latest
    (``chunks_in_mode`` counts live steps, whatever the state the call
    started from), and without re-scheduling never leaves RUN, so on a
    settled step no lane is ready for a plan and none fires.

    ``settles_after`` is None where a step can always fire or is static
    (threshold > 0, a static plan): no step is settled.  ``mask`` is None
    (every lane live at every step), or the call's mask as the caller
    passed it, [num_steps, chunk] for one stream or [lanes, num_steps,
    chunk]; its liveness is read on the host, once.  A mask already on an
    accelerator gives no host facts and is never read back: no step is
    settled.  ``lanes`` is 0 for one stream."""
    if settles_after is None or num_steps == 0:
        return [False] * num_steps
    if mask is None:
        live = torch.ones((max(lanes, 1), num_steps), dtype=torch.bool)
    elif isinstance(mask, torch.Tensor) and mask.device.type != "cpu":
        return [False] * num_steps
    else:
        live = torch.as_tensor(mask).reshape(max(lanes, 1), num_steps, -1).any(dim=-1)
    before = live.to(torch.int32).cumsum(dim=1) - live.to(torch.int32)
    return ((~live) | (before >= settles_after)).all(dim=0).tolist()


def _stack_stats(stats: list[ExecStats], like: ExecState,
                 num_pri: int) -> ExecStats:
    """Per-chunk stats stacked on a chunk axis: [K, ...], or [L, K, ...]
    after the lanes axis of a lanes-stacked state."""
    lanes = like.mode.shape
    if not stats:
        empty = partial(torch.zeros, device=like.mode.device)
        return ExecStats(max_load=empty((*lanes, 0), dtype=torch.int32),
                         modeled_cycles=empty((*lanes, 0), dtype=torch.float32),
                         mode=empty((*lanes, 0), dtype=torch.int32),
                         rescheduled=empty((*lanes, 0), dtype=torch.bool),
                         workload=empty((*lanes, 0, num_pri), dtype=torch.int32))
    return ExecStats(**{f.name: torch.stack([getattr(s, f.name) for s in stats],
                                            dim=len(lanes))
                        for f in dataclasses.fields(ExecStats)})


@dataclasses.dataclass(frozen=True)
class ResumableExecutor:
    """A streaming executor whose state the caller owns.

    ``step(state, chunk, mask=None)`` is the raw chunk body; it folds into
    ``state.buffers`` in place, so the caller must not reuse that state.
    ``run_chunks(state, chunks, mask=None)`` clones the state once and then
    steps over the leading chunk axis, leaving the caller's state as it
    was; ``scan_lanes`` does the same for a lanes-stacked state
    (``stack_states``).  ``merge_state`` is a non-destructive snapshot, of
    every lane for a lanes-stacked state.  The loops run the steps on which
    no lane can take a plan or re-schedule as settled steps
    (``_settled_steps``), with the same results; ``step`` called directly
    is always the full step."""

    spec: DittoSpec
    num_pri: int
    num_sec: int
    chunk_size: int
    device: torch.device
    step: Callable = dataclasses.field(repr=False)

    def init_state(self) -> ExecState:
        return init_state(self.spec, self.num_pri, self.num_sec, self.device)

    def run_chunks(self, state: ExecState, chunks, mask=None):
        """-> (state, ExecStats stacked over the chunk axis)."""
        chunks = torch.as_tensor(chunks, device=self.device)
        if chunks.dim() < 2 or chunks.shape[1] != self.chunk_size:
            raise ValueError(f"chunks must be [num_chunks, {self.chunk_size}, ...], "
                             f"got {tuple(chunks.shape)}")
        settled = _settled_steps(self.step.settles_after, mask, 0, chunks.shape[0])
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        state = state.clone()
        stats = []
        for k in range(chunks.shape[0]):
            state, s = self.step(state, chunks[k], None if mask is None else mask[k],
                                 _settled=settled[k])
            stats.append(s)
        return state, _stack_stats(stats, state, self.num_pri)

    def scan_lanes(self, states: ExecState, chunks, mask=None):
        """Advance a lanes-stacked state (``stack_states``) by
        ``chunks[lane, k]`` in every lane at once: one batched chunk step
        per k, whose PE update is one kernel launch for all lanes.

        chunks: [L, num_chunks, chunk_size, ...]; mask: optional
        bool[L, num_chunks, chunk_size].  Returns (states, ExecStats with
        leaves [L, num_chunks, ...]), lane l equal to ``run_chunks`` of
        lane l alone; the caller's state stays as it was.  The chunks go to
        the device of ``states`` (a mesh shard's, ``core.distributed``)."""
        states, chunks, mask, settled = self._load_lanes(states, chunks, mask)
        states, stats = self._step_lanes(states, chunks, mask, settled)
        return states, _stack_stats(stats, states, self.num_pri)

    def _load_lanes(self, states: ExecState, chunks, mask):
        """``scan_lanes``' inputs on the device of ``states``, checked, a
        copy of ``states`` to step, and which steps are settled (read from
        the mask before it leaves the host)."""
        device = states.mode.device
        chunks = torch.as_tensor(chunks, device=device)
        lanes = states.mode.shape
        if len(lanes) != 1 or chunks.dim() < 3 or chunks.shape[0] != lanes[0] \
                or chunks.shape[2] != self.chunk_size:
            raise ValueError(f"chunks must be [{lanes[0] if lanes else 'L'}, num_chunks, "
                             f"{self.chunk_size}, ...] for a state of {tuple(lanes)} "
                             f"lanes, got {tuple(chunks.shape)}")
        settled = _settled_steps(self.step.settles_after, mask, lanes[0], chunks.shape[1])
        if mask is not None:
            mask = torch.as_tensor(mask, device=device)
        return states.clone(), chunks, mask, settled

    def _step_lanes(self, states: ExecState, chunks, mask, settled):
        """One batched chunk step per k of ``chunks[:, k]``: (states, the
        steps' ExecStats in a list)."""
        stats = []
        for k in range(chunks.shape[1]):
            states, s = self.step(states, chunks[:, k],
                                  None if mask is None else mask[:, k],
                                  _settled=settled[k])
            stats.append(s)
        return states, stats

    def merge_state(self, state: ExecState):
        """Merged [M, *local] buffers ([L, M, *local] for a lanes-stacked
        state); the SecPE shadows stay intact.  A spec with its own
        ``merge`` (DP) gets ``spec.merge(buffers, plan)`` instead, of each
        lane for a lanes-stacked state (stacked on a leading [L] axis)."""
        if self.spec.merge is not None:
            if not state.mode.dim():
                return self.spec.merge(state.buffers, state.plan)
            lanes = [self.spec.merge(*(_tree_map(lambda x: x[l], part)
                                       for part in (state.buffers, state.plan)))
                     for l in range(state.mode.shape[0])]
            return _tree_map(lambda *xs: torch.stack(xs), *lanes)
        return merger.merge_buffers(state.buffers, state.plan.assignment,
                                    self.num_pri, self.spec.combine)


def make_resumable_executor(spec: DittoSpec, num_pri: Any,
                            num_sec: Optional[int] = None,
                            chunk_size: Optional[int] = None, *,
                            profile_chunks: int = 1, threshold: float = 0.0,
                            mem_width_tuples: Optional[int] = None,
                            static_plan: bool = False,
                            device="cuda", obs=None,
                            _who: str = "make_resumable_executor") -> ResumableExecutor:
    """The suspend/resume shape of ``make_executor`` (same knobs)::

        res = make_resumable_executor(spec, 16, 4, 4096)
        state = res.init_state()                    # or with_plan(state, p)
        state, stats = res.run_chunks(state, chunks_a)
        snapshot = res.merge_state(state)
        state, stats = res.run_chunks(state, chunks_b, mask)

    A spec with its own ``merge`` keeps per-PE output regions that cannot
    be re-merged mid-stream, so it takes ``threshold=0.0`` only.  ``obs``
    (an ``Observability`` bundle) gets each step's spans
    (``_build_chunk_step``); None, the default, emits none.
    """
    num_pri, num_sec, chunk_size, mem_width_tuples = _resolve_config(
        num_pri, num_sec, chunk_size, mem_width_tuples)
    if spec.merge is not None and threshold > 0.0:
        raise ValueError(
            f"{spec.name}: non-decomposable applications keep per-PE output "
            "regions and cannot re-merge mid-stream; use threshold=0.0")
    device = resolve_device(device)
    # the build counter on the funnel every executor build goes through; a
    # lazy import, as repro_torch.obs imports repro_torch.core
    from repro_torch import obs as obs_lib
    obs_lib.get_default().registry.counter(
        "executor_builds_total", "executor factory calls, by entry point",
        labels=("kind",)).inc(kind=_who)
    pe_update = spec.pe_update or partial(default_pe_update, combine=spec.combine)
    step = _build_chunk_step(
        spec, num_pri, num_sec, chunk_size, profile_chunks=profile_chunks,
        threshold=threshold, mem_width_tuples=mem_width_tuples,
        static_plan=static_plan, pe_update=pe_update, obs=obs)
    return ResumableExecutor(spec=spec, num_pri=num_pri, num_sec=num_sec,
                             chunk_size=chunk_size, device=device, step=step)


def make_executor(spec: DittoSpec, num_pri: Any, num_sec: Optional[int] = None,
                  chunk_size: Optional[int] = None, *, profile_chunks: int = 1,
                  threshold: float = 0.0, mem_width_tuples: Optional[int] = None,
                  static_plan: bool = False,
                  device="cuda", obs=None) -> Callable[..., tuple[Any, ExecStats]]:
    """Build the streaming executor.

    spec: the application; num_pri/num_sec: M PriPEs and X SecPEs, or a
    ``TunedPlan`` in place of num_pri (it supplies num_sec, chunk_size and
    mem_width_tuples unless given here);
    chunk_size: tuples per chunk (the profiling window granularity);
    profile_chunks: chunks of profiling before a plan is generated;
    threshold: throughput-drop fraction that triggers a re-schedule (0.0
    disables it); mem_width_tuples: W of Eq. 1 (8 by default);
    static_plan: skip runtime profiling (the caller passes a plan);
    device: where the state lives and the kernels run ("cuda" raises
    without a CUDA device); obs: the ``Observability`` bundle that gets
    each chunk step's spans, or None (no spans).

    Returns fn(tuples, plan=None, mask=None) -> (merged buffers, ExecStats);
    ``tuples`` is [num_chunks, chunk_size, ...], ``mask`` an optional
    bool[num_chunks, chunk_size] validity mask.
    """
    res = make_resumable_executor(
        spec, num_pri, num_sec, chunk_size, profile_chunks=profile_chunks,
        threshold=threshold, mem_width_tuples=mem_width_tuples,
        static_plan=static_plan, device=device, obs=obs, _who="make_executor")

    def run(tuples, plan: Optional[RoutePlan] = None, mask=None):
        state = res.init_state()
        if plan is not None:
            state = with_plan(state, plan)
        state, stats = res.run_chunks(state, tuples, mask)
        return res.merge_state(state), stats

    return run


def make_static_plan(num_pri: int, num_sec: int, workload,
                     device="cuda") -> RoutePlan:
    """Offline path: a plan from a sampled workload distribution."""
    device = resolve_device(device)
    assignment = scheduler.schedule_secpes(torch.as_tensor(workload, device=device),
                                           num_sec)
    return mapper.apply_schedule(mapper.init_plan(num_pri, num_sec, device),
                                 assignment)


def stack_states(state: ExecState, num_lanes: int) -> ExecState:
    """One ``ExecState`` repeated into a lanes-stacked state: every leaf
    gains a leading [num_lanes] axis (copies, no shared storage)."""
    return _tree_map(lambda x: torch.stack([x] * num_lanes), state)


def _lane_index(idx, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=x.device)


def take_lanes(states: ExecState, idx) -> ExecState:
    """The lanes ``idx`` (a list of ints: a lanes-stacked state; an int:
    one lane's state) of a lanes-stacked state or plan: the suspend unit
    of a lane (a checkpoint of all lanes takes them all)."""
    return _tree_map(lambda x: x[_lane_index(idx, x)], states)


def put_lanes(states: ExecState, idx, sub: ExecState) -> ExecState:
    """A new lanes-stacked state with lanes ``idx`` replaced by ``sub``
    (the inverse of ``take_lanes``); ``states`` stays as it was."""
    return _tree_map(lambda x, s: x.index_put((_lane_index(idx, x),), s), states, sub)


def stack_plans(plans) -> RoutePlan:
    """Per-stream RoutePlans stacked into the lanes-stacked plan that the
    multi-stream executor takes (per-tenant plans).  All plans must share
    (num_pri, num_sec)."""
    plans = list(plans)
    if not plans:
        raise ValueError("stack_plans needs at least one plan")
    shapes = {(p.num_pri, p.num_sec) for p in plans}
    if len(shapes) != 1:
        raise ValueError(f"plans disagree on (num_pri, num_sec): {shapes}")
    return _tree_map(lambda *xs: torch.stack(xs), *plans)


def make_multistream_executor(spec: DittoSpec, num_pri: Any,
                              num_sec: Optional[int] = None,
                              chunk_size: Optional[int] = None, *,
                              device="cuda", obs=None,
                              **kw) -> Callable[..., tuple[Any, ExecStats]]:
    """S independent chunk streams through one lane-batched chunk step.

    Every stream is a lane with its own profiler and scheduler state
    (plan, mode, monitor, re-schedule counter), while the per-chunk work of
    all streams runs as one batched step: lanes are more PEs, so each PE
    update is one kernel launch for all S streams.  ``num_pri`` takes a
    TunedPlan as in ``make_executor``; ``kw`` are ``make_executor``'s knobs.

    Returns run_streams(tuples, plans=None, mask=None) -> (merged, ExecStats):
      tuples: [S, num_chunks, chunk_size, ...];
      plans: optional lanes-stacked RoutePlan (``stack_plans``); every
        stream then starts in RUN mode under its own plan;
      mask: optional bool[S, num_chunks, chunk_size] validity mask; ragged
        streams and all-masked pad lanes are exact no-ops.
    The outputs gain a leading [S] axis and equal, lane by lane, each stream
    run alone through ``make_executor``, bit for bit for integer apps.
    With an ``obs`` bundle a run is three spans around the steps' own:
    ``executor.load`` (the inputs to the device, the lanes' states),
    the ``executor.step`` spans, and ``executor.finish`` (the stats
    stacked, the merge).
    """
    res = make_resumable_executor(spec, num_pri, num_sec, chunk_size, device=device,
                                  obs=obs, _who="make_multistream_executor", **kw)
    tracer = _tracer_of(obs)

    def run_streams(tuples, plans: Optional[RoutePlan] = None, mask=None):
        with tracer.span("executor.load", cat="executor"):
            tuples = torch.as_tensor(tuples, device=res.device)
            states = stack_states(res.init_state(), tuples.shape[0])
            if plans is not None:
                states = with_plan(states, _tree_map(lambda t: t.to(res.device), plans))
            states, tuples, mask, settled = res._load_lanes(states, tuples, mask)
        states, stats = res._step_lanes(states, tuples, mask, settled)
        with tracer.span("executor.finish", cat="executor"):
            stats = _stack_stats(stats, states, res.num_pri)
            return res.merge_state(states), stats

    return run_streams
