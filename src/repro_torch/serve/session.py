"""Continuous-batching session serving over the lane-batched Ditto executor.

The PyTorch counterpart of ``repro/serve/session.py``, with its API,
semantics, error taxonomy, telemetry and metric names.  ``StreamEngine``
serves whole one-shot streams; ``SessionEngine`` is the datacenter shape on
top of the same executor: tenants ``open()`` a session, ``append()`` ragged
tuple batches as they arrive, ``query()`` a merged snapshot mid-stream and
``close()``.  One level up it replays the paper's skew-oblivious move:
sessions are the new tuples, stream slots are the new PEs.

Slot model
  The engine owns ``primary_slots + secondary_slots`` lanes of a
  lanes-stacked ``ExecState`` (``core.executor.stack_states``), advanced
  by ``ResumableExecutor.scan_lanes``: each batched chunk is one chunk
  step for every lane, whose PE update is one kernel launch for all lanes
  of a shard on the card.  Every lane operation goes through
  ``core.distributed.ShardedLaneExecutor``: ``mesh=`` splits the lanes
  over the mesh's ``lanes`` axis (P shards x ``lanes_per_device`` lanes,
  so one engine serves more tenants than one shard's lane budget), and
  ``mesh=None`` is the same path on a mesh of one shard on ``device``.
  Every admitted session owns one primary lane; secondary lanes are the
  serving layer's SecPEs.  At each engine-wide flush the
  paper's greedy scheduler (``core.scheduler.schedule_secpes``) runs over
  the per-session chunk backlog, on a small host tensor, and grants hot
  sessions extra lanes; a session's chunks then stripe round-robin over
  its lane group.  A secondary lane re-granted to another session first
  folds into its old owner's primary lane and resets (§IV-B's SecPE merge,
  lifted one level).

Ragged input, queries, per-session flush
  Appends buffer on the host; full chunks run at the next flush, and a
  query or close forces the ragged tail through as a masked chunk (an
  exact no-op for the executor).  ``query`` merges the primary and granted
  secondary lanes without resetting them, so answers are bit-exact against
  the one-shot executor on the same tuples, whatever the append chunking,
  tails or grants.  ``query``/``close`` flush only the session's own lane
  group (``flush_session``); ``flush()`` is the engine-wide path and the
  only place grants are re-scheduled.

Shape buckets
  With ``aot_buckets=W`` both flush tiers go through the JAX package's
  bucket table: scan widths are powers of two chopped into segments of at
  most W, and lane groups are padded to power-of-two buckets with lanes
  outside the group carrying all-masked chunks, written back unchanged.
  The port does not trace, so ``warmup()`` builds and loads the PE kernel
  and runs every (lane bucket, width) once on all-masked scratch lanes;
  afterwards the build monitor (``core.compilemon``: nvcc builds and
  library loads) records no event on any flush path, which is what
  ``n_retraces`` and ``compile_stall_ms`` count here.

Batched admission
  ``open_batch(tenants, first=...)`` opens a storm of sessions with their
  first appends and runs the admitted sessions' full chunks through one
  batched lane reset and one bucketed scan over their primary lanes;
  overflow queues strictly FIFO and admits into the lowest free slot.

Telemetry and observability
  Per-flush rows (schema v1, ``telemetry_record``, a ring of
  ``telemetry_cap`` rows) and the ``obs=`` bundle's metrics and spans
  (``flush_latency_ms{scope}``, ``lane_occupancy{lane}``,
  ``secondary_grants_total{tenant}``, ``backlog_depth{tenant}``;
  ``engine.flush``, ``scan.segment``, ``engine.admit_storm``,
  ``merge.snapshot``) carry the JAX engine's names, so a scrape of either
  engine over the same ops parses into the same series.

Durability: ``serve.durability`` wraps this engine in a per-tenant
write-ahead log and lane-state checkpoints; ``SessionEngine.recover``
resumes one, onto a mesh or not, whatever the mesh that wrote it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core import compilemon, scheduler
from repro_torch.core import distributed as core_distributed
from repro_torch.core import executor as core_executor
from repro_torch.data.pipeline import pad_tail_chunk
from repro_torch.serve.errors import (ClosedSessionError, QueuedSessionError,
                                      ShapeMismatchError, UnknownSessionError)

TELEMETRY_SCHEMA_VERSION = 1   # mirrors benchmarks.common.SCHEMA_VERSION


def _to_numpy(tree):
    """A merged result on the host: a tensor as numpy, a dataclass of
    tensors (DP's ``DPBuffers``) as the same dataclass of numpy arrays."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _to_numpy(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree.detach().cpu().numpy()


@dataclasses.dataclass
class SessionStats:
    """Host-side per-session aggregation of the executor's ExecStats."""

    tuples_appended: int = 0
    tuples_flushed: int = 0
    chunks_flushed: int = 0
    queries: int = 0
    modeled_cycles: float = 0.0
    max_load: int = 0
    exec_reschedules: int = 0
    sec_lane_flushes: int = 0     # chunks this session ran on secondary lanes

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Session:
    sid: int
    tenant: str
    slot: Optional[int]                 # primary lane id, None while queued
    backlog: Deque[np.ndarray]          # appended arrays, FIFO; never
    backlog_off: int = 0                # re-copied -- backlog_off marks the
    backlog_tuples: int = 0             # consumed prefix of backlog[0]
    stats: SessionStats = dataclasses.field(default_factory=SessionStats)
    closed: bool = False

    def pending_arrays(self) -> List[np.ndarray]:
        """The buffered remainder as a list of array views (first entry
        trimmed past ``backlog_off``); concatenates nothing."""
        if not self.backlog:
            return []
        first = self.backlog[0]
        head = first[self.backlog_off:] if self.backlog_off else first
        return [head, *list(self.backlog)[1:]]


class _EngineMetrics:
    """The engine's metric family handles, resolved once against one
    ``obs.MetricsRegistry`` (re-requesting a family is idempotent, so
    engines sharing a registry share series).  Names, help strings and
    labels are the JAX engine's."""

    # bounded label cardinality: past these, per-lane / per-tenant gauge
    # series collapse to the aggregate
    MAX_LANE_SERIES = 128
    MAX_TENANT_SERIES = 32

    def __init__(self, reg):
        c, g, h = reg.counter, reg.gauge, reg.histogram
        self.flush_ms = h("flush_latency_ms", "wall-clock per flush, by flush tier",
                          labels=("scope",))
        self.admit_ms = h("admit_latency_ms",
                          "wall-clock per open_batch admission storm")
        self.flushes = c("flushes_total", "flushes run, by tier", labels=("scope",))
        self.tuples = c("tuples_flushed_total", "real tuples through the lanes")
        self.chunks = c("chunks_flushed_total",
                        "chunks through the lanes (padding excluded)")
        self.retraces = c("retraces_total",
                          "jit compiles observed on the flush path "
                          "(compilemon delta per flush)")
        self.stall = c("compile_stall_ms_total",
                       "compile stall milliseconds on the flush path")
        self.opened = c("sessions_opened_total", "sessions opened")
        self.closed = c("sessions_closed_total", "sessions closed")
        self.appends = c("appends_total", "append() calls accepted")
        self.app_tuples = c("appended_tuples_total", "tuples accepted by append()")
        self.queries = c("queries_total", "query() calls, by flush tier",
                         labels=("scope",))
        self.storms = c("storms_total", "open_batch admission storms")
        self.admitted = c("storm_admitted_total", "sessions admitted via open_batch")
        self.grants = c("secondary_grants_total",
                        "secondary-lane grants, by receiving tenant",
                        labels=("tenant",))
        self.active = g("active_sessions", "sessions holding a slot")
        self.queued = g("queued_sessions", "sessions waiting for a slot")
        self.slot_occ = g("slot_occupancy", "active / primary_slots fraction")
        self.lanes_busy = g("lanes_busy", "lanes owned by some session")
        self.occupancy = g("lane_occupancy",
                           "1 when the lane is owned by a session "
                           "(omitted past MAX_LANE_SERIES lanes)",
                           labels=("lane",))
        self.backlog_tot = g("backlog_tuples",
                             "host-buffered tuples across open sessions")
        self.backlog = g("backlog_depth",
                         "host-buffered tuples by tenant (top "
                         "MAX_TENANT_SERIES by depth)",
                         labels=("tenant",))
        self.sec_granted = g("secondary_lanes_granted",
                             "secondary lanes currently granted")
        self.sched_granted = g("sched_n_granted", "grants in the last scheduling plan")
        self.sched_load = g("sched_post_plan_max_load",
                            "max per-slot load after the last plan "
                            "(the paper's post-plan balance metric)")
        self.tele_dropped = c("telemetry_dropped_rows_total",
                              "telemetry rows lost to the ring cap")


class SessionEngine:
    """Slot-managed multi-tenant sessions over one lanes-stacked executor.

    Args:
      spec: the DittoSpec every session runs (one engine = one app).
      num_pri/num_sec/chunk_size: executor shape per lane, or ``tuned=`` a
        ``repro_torch.tune.TunedPlan`` supplying them (an explicit num_pri
        that conflicts with the plan's raises).
      primary_slots: most sessions admitted at once; further ``open`` calls
        queue strictly FIFO and admit into the lowest free slot as slots
        free.  A queued session accepts ``append``; ``query`` raises
        ``QueuedSessionError`` until it is admitted, and ``close`` raises
        while it holds buffered data.
      secondary_slots: extra lanes the backlog scheduler grants to hot
        sessions (0 disables it).  Needs a decomposable spec
        (``spec.merge is None``).
      min_grant_chunks: backlog chunks below which a session gets no
        secondary lane.
      mesh / lanes_axis: a ``core.distributed.Mesh`` with a ``lanes_axis``
        axis splits the lanes over its shards (``lanes_per_device`` each;
        ``primary_slots + secondary_slots`` must divide evenly).  Its
        devices must be of ``device``'s type.  ``None`` keeps every lane
        on ``device``.
      aot_buckets: the bucket table's largest scan width (an int, or an
        iterable of widths whose max counts), rounded up to a power of two;
        None keeps one power-of-two segment a flush.
      device: where the lanes' state lives and every chunk step runs;
        ``"cuda"`` (the default) raises without a CUDA device.
      obs: ``None`` -> a fresh enabled ``Observability``; ``False`` -> a
        disabled one; an ``Observability`` is shared as it is.
      telemetry_cap: ring size of the per-flush telemetry rows (None:
        unbounded).
      **executor_kw: forwarded to ``core.make_resumable_executor``
        (profile_chunks, threshold, mem_width_tuples, static_plan).
    """

    def __init__(self, spec, *, num_pri: Optional[int] = None,
                 num_sec: Optional[int] = None,
                 chunk_size: Optional[int] = None, tuned=None,
                 primary_slots: int = 4, secondary_slots: int = 2,
                 min_grant_chunks: int = 2, mesh=None,
                 lanes_axis: str = "lanes", aot_buckets=None,
                 device="cuda", obs=None,
                 telemetry_cap: Optional[int] = 4096, **executor_kw):
        if tuned is not None:
            if num_pri is not None and num_pri != tuned.num_pri:
                raise ValueError(f"num_pri={num_pri} conflicts with the "
                                 f"tuned plan's num_pri={tuned.num_pri}")
            num_pri = tuned          # TunedPlan resolution lives in core
        if num_pri is None:
            raise TypeError("SessionEngine needs num_pri/num_sec/chunk_size "
                            "or tuned=TunedPlan")
        if primary_slots < 1:
            raise ValueError("SessionEngine needs at least one primary slot")
        if secondary_slots > 0 and spec.merge is not None:
            raise ValueError(
                f"{spec.name}: non-decomposable buffers cannot be combined "
                "across lanes; use secondary_slots=0")
        if mesh is not None and lanes_axis not in dict(mesh.shape):
            raise ValueError(
                f"mesh has no '{lanes_axis}' axis; mesh axes: "
                f"{tuple(dict(mesh.shape))}")
        self.spec = spec
        self.primary_slots = primary_slots
        self.secondary_slots = secondary_slots
        self.min_grant_chunks = min_grant_chunks
        self.num_lanes = primary_slots + secondary_slots
        self.mesh = mesh

        # every lane operation goes through the sharded lane executor:
        # without a mesh, on a mesh of one shard on ``device``
        lane_mesh = core_distributed.make_mesh(1, lanes_axis, device=device)
        if mesh is not None:
            if any(d.type != lane_mesh.devices[0].type for d in mesh.devices):
                raise ValueError(f"mesh devices {[str(d) for d in mesh.devices]} are "
                                 f"not of device={str(device)!r}'s type")
            lane_mesh = mesh
        self._res = core_executor.make_resumable_executor(
            spec, num_pri, num_sec, chunk_size, device=lane_mesh.devices[0],
            **executor_kw)
        self.device = self._res.device
        self.num_pri, self.num_sec = self._res.num_pri, self._res.num_sec
        self.chunk_size = self._res.chunk_size
        self._fresh = self._res.init_state()
        self._lanes = core_distributed.make_lane_sharded_executor(
            self._res, lane_mesh, self.num_lanes, axis=lanes_axis)
        self.lanes_per_device = self._lanes.lanes_per_device
        self._states = self._lanes.init_states()

        # --- the bucket table: widths 1, 2, ..., W and the power-of-two
        # lane-group sizes a per-session flush or a storm can present
        self._aot: set = set()                # the bucket keys warmup() ran
        self._aot_info: Optional[Dict[str, Any]] = None
        if aot_buckets is None:
            self._aot_widths = None
            self._group_buckets: Tuple[int, ...] = ()
            self._admit_buckets: Tuple[int, ...] = ()
        else:
            if isinstance(aot_buckets, (int, np.integer)):
                max_w = int(aot_buckets)
            else:
                widths = [int(w) for w in aot_buckets]
                max_w = max(widths) if widths else 0
            if max_w < 1:
                raise ValueError(f"aot_buckets={aot_buckets!r}: need a "
                                 "max scan width >= 1")
            max_w = 1 << (max_w - 1).bit_length()        # pow2 ceiling
            self._aot_widths = tuple(1 << k for k in range(max_w.bit_length()))
            self._group_buckets = tuple(sorted(
                {self._group_bucket(g) for g in range(1, 2 + self.secondary_slots)}))
            self._admit_buckets = tuple(sorted(
                {self._admit_bucket(k) for k in range(1, 1 + self.primary_slots)}))

        compilemon.install()
        self.obs = obs_lib.resolve(obs)
        self._mx = _EngineMetrics(self.obs.registry)
        self._n_retraces = 0
        self._compile_stall_ms = 0.0
        self._storms = 0                   # open_batch calls
        self._n_admitted_batch = 0         # sessions admitted via storms
        self._admit_stall_ms = 0.0         # wall-clock inside open_batch
        self._n_retraces_admit = 0         # build events during storms

        self.sessions: Dict[int, _Session] = {}
        self._queue: Deque[int] = deque()                # sids awaiting a slot
        self._slot_sid: List[Optional[int]] = [None] * primary_slots
        self._free_slots: List[int] = list(range(primary_slots))  # min-heap
        self._sec_assign = np.full(secondary_slots, -1, np.int64)
        self._next_sid = 0
        self._feat_shape: Optional[tuple] = None
        self._dtype = None
        self._flush_no = 0
        self._slot_reschedules = 0
        self._gauge_scan_last = 0.0     # last lane/tenant gauge rescan
        if telemetry_cap is not None and int(telemetry_cap) < 1:
            raise ValueError(f"telemetry_cap={telemetry_cap}: need >= 1 "
                             "rows, or None for unbounded")
        self.telemetry_cap = None if telemetry_cap is None else int(telemetry_cap)
        self._telemetry: Deque[Dict[str, Any]] = deque(maxlen=self.telemetry_cap)
        self._telemetry_total = 0      # rows ever recorded (ring-proof)
        self._telemetry_dropped = 0    # rows lost to the ring cap
        self._rows_validated = 0       # high-water mark for incremental
                                       # telemetry_record(validate=True)

    # ------------------------------------------------------- lane operations

    def _merge_lane(self, states, lane: int):
        """Merged buffers of one lane (a non-destructive snapshot)."""
        return self._lanes.merge_lane(states, lane)

    def _reset_lanes(self, states, idx):
        """``states`` with lanes ``idx`` reset to fresh state, one scatter a
        shard.  Duplicate indices are legal (the same fresh value lands
        twice), so fixed-shape callers may pad ``idx`` by repeating a lane."""
        return self._lanes.reset_lanes(states, idx)

    def _fold_lane(self, states, src: int, dst: int):
        """Fold secondary lane ``src`` into primary lane ``dst`` (add/max of
        its merged buffers into dst's PriPE rows, across shards), then
        reset ``src``."""
        return self._lanes.fold_lane(states, src, dst)

    # ------------------------------------------------------------- lifecycle

    def open(self, tenant: str = "default") -> int:
        """Open a session; admitted to a primary slot at once when one is
        free, else queued until a ``close`` frees one."""
        sid = self._next_sid
        self._next_sid += 1
        self.sessions[sid] = _Session(sid, tenant, slot=None, backlog=deque())
        self._queue.append(sid)
        self._admit()
        self._mx.opened.inc()
        return sid

    def open_batch(self, tenants: Iterable[str],
                   first: Optional[Iterable[Optional[np.ndarray]]] = None
                   ) -> List[int]:
        """Admit a storm of new sessions in one batched admission step.

        The same as ``open(t)`` (and ``append(sid, f)`` when ``first`` is
        given) per tenant, in order -- same sids, same FIFO queueing past
        ``primary_slots``, bit-exact answers -- but the admitted sessions'
        full first chunks run now through one batched lane reset and one
        bucketed scan over their primary lanes (``_flush_admission``).
        Ragged sub-chunk tails stay buffered.

        Returns the new sids, aligned with ``tenants``, and appends one
        ``scope="admit"`` telemetry row carrying ``n_admitted``,
        ``n_queued_batch``, ``n_scan_dispatches`` and ``admit_ms``."""
        tenants = list(tenants)
        if first is not None:
            first = list(first)
            if len(first) != len(tenants):
                raise ValueError(
                    f"open_batch: {len(tenants)} tenants but {len(first)} "
                    "first-append entries (pass one per tenant, or None)")
        snap = compilemon.snapshot()
        t0 = time.perf_counter()
        with self.obs.span("engine.admit_storm", cat="admit",
                           n_tenants=len(tenants)) as sp:
            sids: List[int] = []
            for i, tenant in enumerate(tenants):
                sid = self.open(tenant)     # virtual dispatch: the durable
                sids.append(sid)            # engine logs each open/append
                if first is not None and first[i] is not None:
                    self.append(sid, first[i])
            self._admit_storm(sids, sp, snap, t0)
        return sids

    def _admit_storm(self, sids: List[int], sp, snap, t0: float) -> None:
        """The admission flush of a storm whose sessions ``sids`` are open
        and hold their first appends, and its accounting: the admitted
        sessions' full chunks run, one ``admit`` telemetry row, one flush
        number.  The durable engine logs it and replays it."""
        admitted = [sid for sid in sids if self.sessions[sid].slot is not None]
        group_chunks, width, flushed, n_disp = self._flush_admission(admitted)
        sp.set(n_admitted=len(admitted), n_scan_dispatches=int(n_disp))
        ms = (time.perf_counter() - t0) * 1e3
        delta = compilemon.since(snap)
        self._storms += 1
        self._n_admitted_batch += len(admitted)
        self._admit_stall_ms += ms
        self._n_retraces_admit += delta.n_compiles
        self._mx.storms.inc()
        self._mx.admitted.inc(len(admitted))
        self._mx.admit_ms.observe(ms)
        self._record_flush(flushed, group_chunks, width, scope="admit",
                           snap=snap, ms=ms,
                           extra={"n_admitted": len(admitted),
                                  "n_queued_batch": len(sids) - len(admitted),
                                  "n_scan_dispatches": int(n_disp),
                                  "admit_ms": round(ms, 3)})
        self._flush_no += 1

    def append(self, sid: int, data: np.ndarray) -> None:
        """Append a tuple batch of any length (ragged welcome) to an open
        session.  Buffers on the host; full chunks run at the next flush."""
        s = self._session(sid)
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if self._feat_shape is None:
            self._feat_shape, self._dtype = data.shape[1:], data.dtype
            if self._aot_widths and not self._aot:
                self.warmup()        # deferred warmup: the tuple shape is known
        elif data.shape[1:] != self._feat_shape:
            raise ShapeMismatchError(
                f"append shape {data.shape[1:]} != engine tuple "
                f"shape {self._feat_shape}")
        if len(data):
            with self.obs.span("engine.append", cat="session", sid=sid, n=len(data)):
                s.backlog.append(data)
                s.backlog_tuples += len(data)
                s.stats.tuples_appended += len(data)
            self._mx.appends.inc()
            self._mx.app_tuples.inc(len(data))

    def query(self, sid: int, *, scope: str = "session"):
        """Merged-buffer snapshot (numpy) of everything appended so far.

        Forces this session's backlog, ragged tail included, through the
        lanes, then combines its primary lane with any granted secondary
        lanes without resetting them.  ``scope="session"`` (default) runs
        ``flush_session``; ``"engine"`` runs a full ``flush``.  Both give
        identical answers."""
        s = self._session(sid)
        if s.slot is None:
            raise QueuedSessionError(
                f"session {sid} is queued (all {self.primary_slots} primary "
                "slots busy); nothing has run yet -- close another session "
                "to admit it before querying")
        if scope == "session":
            self.flush_session(sid)
        elif scope == "engine":
            self.flush(force=(sid,))
        else:
            raise ValueError(f"query scope {scope!r} not in ('session', 'engine')")
        s.stats.queries += 1
        self._mx.queries.inc(scope=scope)
        return self._snapshot(s)

    def close(self, sid: int):
        """Final flush and snapshot; frees the session's lanes for queued
        tenants.  Returns (merged buffers as numpy, stats dict).  A queued
        session closes only while it is empty."""
        s = self._session(sid)
        if s.slot is None and s.backlog_tuples:
            raise QueuedSessionError(
                f"session {sid} is queued with {s.backlog_tuples} buffered "
                "tuples; close another session to admit it first (refusing "
                "to discard data)")
        if s.slot is not None:
            self.flush_session(sid)
        merged = self._snapshot(s)
        if s.slot is not None:
            lanes = self._lane_group(s.slot)
            for j in range(self.secondary_slots):
                if self._sec_assign[j] == s.slot:
                    self._sec_assign[j] = -1
            # one batched reset of the whole lane group
            self._states = self._reset_lanes(self._states, lanes)
            self._slot_sid[s.slot] = None
            heapq.heappush(self._free_slots, s.slot)
            s.slot = None
        else:
            self._queue.remove(sid)
        s.closed = True
        self._admit()
        self._mx.closed.inc()
        return merged, s.stats.as_dict()

    # ----------------------------------------------------------------- flush

    def flush(self, force: Iterable[int] = ()) -> None:
        """Advance every admitted session's stream by its backlogged chunks
        in one batched scan: admit queued sessions into free slots,
        re-grant secondary lanes from the backlog (a re-granted lane folds
        into its old session first), stripe each session's full chunks over
        its lane group (``force`` sessions also flush their ragged tail as a
        masked chunk; idle lanes carry all-masked padding), and advance all
        lanes together, segment by segment."""
        snap = compilemon.snapshot()
        t0 = time.perf_counter()
        with self.obs.span("engine.flush", scope="engine") as sp:
            force = set(force)
            self._admit()
            with self.obs.span("sched.regrant", cat="sched"):
                self._reschedule_secondary()

            lane_chunks: List[List[np.ndarray]] = [[] for _ in range(self.num_lanes)]
            lane_masks: List[List[np.ndarray]] = [[] for _ in range(self.num_lanes)]
            lane_sid: List[Optional[int]] = [None] * self.num_lanes
            flushed_tuples = 0
            for slot, sid in enumerate(self._slot_sid):
                if sid is None:
                    continue
                s = self.sessions[sid]
                lanes = self._lane_group(slot)
                for ln in lanes:
                    lane_sid[ln] = sid
                gc, gm, n_real = self._take_striped(s, lanes, flush_tail=sid in force)
                for g, ln in enumerate(lanes):
                    lane_chunks[ln].extend(gc[g])
                    lane_masks[ln].extend(gm[g])
                flushed_tuples += n_real

            row_sessions = [None if sid is None else self.sessions[sid]
                            for sid in lane_sid]
            width = 0
            segs = list(self._segments(lane_chunks))
            with self._segment_loop_span(segs, "engine") as seg_span:
                for off, w in segs:
                    with seg_span(off, w):
                        chunks, mask = self._pack_chunks(lane_chunks, lane_masks, w,
                                                         offset=off)
                        self._states, stats = self._lanes.run_lanes(self._states, chunks,
                                                                    mask)
                        self._apply_exec_stats(
                            stats, row_sessions,
                            [min(max(len(c) - off, 0), w) for c in lane_chunks])
                    width += w
            sp.set(tuples=flushed_tuples, width=width)
        self._record_flush(flushed_tuples, lane_chunks, width, snap=snap,
                           ms=(time.perf_counter() - t0) * 1e3)
        self._flush_no += 1

    def flush_session(self, sid: int) -> None:
        """Advance only this session's stream: its backlog, ragged tail
        included, stripes over its current lane group and one scan over
        <= 1 + granted lanes runs it (the fast path behind ``query``).  No
        admission and no re-scheduling happen here.  With ``aot_buckets=``
        the group is padded to its bucket with lanes outside it carrying
        all-masked chunks, which leave their state bit-identical."""
        snap = compilemon.snapshot()
        t0 = time.perf_counter()
        s = self._session(sid)
        if s.slot is None:
            raise QueuedSessionError(
                f"session {sid} is queued (all {self.primary_slots} primary "
                "slots busy); nothing has run yet -- close another session "
                "to admit it first")
        with self.obs.span("engine.flush_session", scope="session",
                           sid=sid, tenant=s.tenant) as sp:
            lanes = self._lane_group(s.slot)
            group_chunks, group_masks, n_real = self._take_striped(s, lanes,
                                                                   flush_tail=True)
            width = 0
            if any(group_chunks):
                n_real_lanes = len(lanes)
                if self._aot_widths:
                    bucket = self._group_bucket(n_real_lanes)
                    if bucket > n_real_lanes:
                        in_group = set(lanes)
                        pads = [ln for ln in range(self.num_lanes)
                                if ln not in in_group][:bucket - n_real_lanes]
                        lanes = lanes + pads
                        group_chunks = group_chunks + [[] for _ in pads]
                        group_masks = group_masks + [[] for _ in pads]
                row_sessions = [s] * n_real_lanes + [None] * (len(lanes) - n_real_lanes)
                sub = self._lanes.take_lanes(self._states, lanes)
                segs = list(self._segments(group_chunks))
                with self._segment_loop_span(segs, "session") as seg_span:
                    for off, w in segs:
                        with seg_span(off, w):
                            arr, msk = self._pack_chunks(group_chunks, group_masks, w,
                                                         offset=off)
                            sub, stats = self._res.scan_lanes(sub, arr, msk)
                            self._apply_exec_stats(
                                stats, row_sessions,
                                [min(max(len(c) - off, 0), w) for c in group_chunks])
                        width += w
                self._states = self._lanes.put_lanes(self._states, lanes, sub)
            sp.set(tuples=n_real, width=width)
        self._record_flush(n_real, group_chunks, width, scope="session",
                           snap=snap, ms=(time.perf_counter() - t0) * 1e3)
        self._flush_no += 1

    def _flush_admission(self, sids: List[int]):
        """The storm flush behind ``open_batch``: the newly admitted
        sessions' full backlog chunks (``flush_tail=False``) run as one
        batched lane reset plus one bucketed scan over their primary lanes.
        The scan group pads up to the admission bucket with other lanes
        carrying all-masked chunks; the reset pads its index with duplicate
        admitted lanes instead (resetting a fresh lane twice is a no-op,
        resetting another session's lane would destroy it).

        Returns ``(group_chunks, width, flushed_tuples, n_scan_dispatches)``."""
        live = [self.sessions[sid] for sid in sids
                if self.sessions[sid].backlog_tuples >= self.chunk_size]
        if not live:
            return [], 0, 0, 0
        lanes = [s.slot for s in live]
        n_real_lanes = len(lanes)
        bucket = (self._admit_bucket(n_real_lanes) if self._aot_widths
                  else n_real_lanes)
        init_idx = lanes + [lanes[0]] * (bucket - n_real_lanes)
        with self.obs.span("admit.lane_init", cat="admit",
                           n_lanes=n_real_lanes, bucket=bucket):
            self._states = self._reset_lanes(self._states, init_idx)
        group_chunks: List[List[np.ndarray]] = []
        group_masks: List[List[np.ndarray]] = []
        flushed = 0
        for s in live:
            gc, gm, n_real = self._take_striped(s, [s.slot], flush_tail=False)
            group_chunks.append(gc[0])
            group_masks.append(gm[0])
            flushed += n_real
        if bucket > n_real_lanes:
            in_group = set(lanes)
            pads = [ln for ln in range(self.num_lanes)
                    if ln not in in_group][:bucket - n_real_lanes]
            lanes = lanes + pads
            group_chunks += [[] for _ in pads]
            group_masks += [[] for _ in pads]
        row_sessions = live + [None] * (len(lanes) - n_real_lanes)
        sub = self._lanes.take_lanes(self._states, lanes)
        width = n_disp = 0
        for off, w in self._segments(group_chunks):
            with self.obs.span("scan.segment", cat="scan", scope="admit",
                               offset=off, width=w):
                arr, msk = self._pack_chunks(group_chunks, group_masks, w, offset=off)
                sub, stats = self._res.scan_lanes(sub, arr, msk)
                self._apply_exec_stats(
                    stats, row_sessions,
                    [min(max(len(c) - off, 0), w) for c in group_chunks])
            width += w
            n_disp += 1
        self._states = self._lanes.put_lanes(self._states, lanes, sub)
        return group_chunks, width, flushed, n_disp

    # -------------------------------------------------------- bucket table

    def _admit_bucket(self, k: int) -> int:
        """Admission lane bucket: the power-of-two ceiling of ``k``, capped
        at ``primary_slots``."""
        return min(1 << (k - 1).bit_length(), self.primary_slots)

    def _group_bucket(self, g: int) -> int:
        """Lane-group bucket: the power-of-two ceiling of ``g``, capped at
        the largest group a session can own (its primary lane and every
        secondary lane)."""
        gmax = min(1 + self.secondary_slots, self.num_lanes)
        return min(1 << (g - 1).bit_length(), gmax)

    # per-flush ceiling on individual scan.segment spans; past it the loop
    # gets one aggregate ``scan.segments`` span
    _SEGMENT_SPAN_CAP = 16

    @contextlib.contextmanager
    def _segment_loop_span(self, segs, scope: str):
        """The span factory of a flush's segment loop: a ``scan.segment``
        span each up to ``_SEGMENT_SPAN_CAP`` segments, else one
        ``scan.segments`` span over the loop."""
        if len(segs) <= self._SEGMENT_SPAN_CAP:
            yield lambda off, w: self.obs.span(
                "scan.segment", cat="scan", scope=scope, offset=off, width=w)
            return
        null = contextlib.nullcontext()
        with self.obs.span("scan.segments", cat="scan", scope=scope,
                           n_segments=len(segs), width=sum(w for _, w in segs)):
            yield lambda off, w: null

    def _segments(self, lane_chunks):
        """The ``(offset, width)`` scan segments covering the widest lane:
        one power-of-two segment without buckets, else bucket widths
        ``<= W`` (a scan is sequential, so segments carrying the state
        between them equal one wide scan)."""
        wmax = max((len(c) for c in lane_chunks), default=0)
        if not wmax:
            return
        if not self._aot_widths:
            yield 0, self._batch_width(lane_chunks)
            return
        cap = self._aot_widths[-1]
        off = 0
        while off < wmax:
            rem = wmax - off
            w = cap if rem >= cap else 1 << (rem - 1).bit_length()
            yield off, w
            off += w

    def warmup(self, *, dtype=None, feat_shape=None) -> Dict[str, Any]:
        """Build and load everything the flush paths run, so that steady
        traffic records no build event (requires ``aot_buckets=``).

        Runs every engine-wide scan width and every (lane bucket, width) of
        the per-session and storm tiers once on all-masked scratch lanes
        (which builds and loads the PE kernel on the card), and the lane
        gather/scatter, reset, merge and fold once.  Needs the tuple dtype
        and shape: call after the first ``append`` (which calls this), or
        pass ``dtype=`` and ``feat_shape=``.  Returns the info dict also
        under ``telemetry_record()['extra']['aot']``."""
        if not self._aot_widths:
            raise RuntimeError("warmup() needs SessionEngine(aot_buckets=...)")
        if dtype is not None:
            dtype = np.dtype(dtype)
            if self._dtype is not None and dtype != self._dtype:
                raise ValueError(f"warmup dtype {dtype} != engine tuple "
                                 f"dtype {self._dtype}")
            self._dtype = dtype
        if feat_shape is not None:
            feat_shape = tuple(int(d) for d in feat_shape)
            if self._feat_shape is not None and feat_shape != self._feat_shape:
                raise ValueError(f"warmup feat_shape {feat_shape} != engine "
                                 f"tuple shape {self._feat_shape}")
            self._feat_shape = feat_shape
        if self._dtype is None or self._feat_shape is None:
            raise RuntimeError(
                "warmup() before the tuple shape is known: pass dtype= and "
                "feat_shape=, or append data first")
        t0 = time.perf_counter()
        before = compilemon.snapshot()
        c, feat = self.chunk_size, self._feat_shape
        scratch = self._lanes.init_states()

        def zeros(lanes, w):
            return (np.zeros((lanes, w, c, *feat), self._dtype),
                    np.zeros((lanes, w, c), bool))

        for w in self._aot_widths:
            self._lanes.run_lanes(scratch, *zeros(self.num_lanes, w))
            self._aot.add(("eng", w))
        # one entry per (lane-group bucket, width) serves both the
        # per-session tier and the storm path; a group is gathered onto the
        # device of its first lane, so each shard's device starts one
        starts: Dict[Any, int] = {}
        for p, dev in enumerate(self._lanes.devices):
            starts.setdefault(dev, p * self.lanes_per_device)
        for b in sorted({*self._group_buckets, *self._admit_buckets}):
            for first in starts.values():
                idx = [(first + k) % self.num_lanes for k in range(b)]
                sub = self._lanes.take_lanes(scratch, idx)
                for w in self._aot_widths:
                    self._res.scan_lanes(sub, *zeros(b, w))
                self._lanes.put_lanes(scratch, idx, sub)
            for w in self._aot_widths:
                self._aot.add(("grp", b, w))
        for n in sorted({*range(1, 2 + self.secondary_slots), *self._admit_buckets}):
            self._reset_lanes(scratch, range(n))
        self._merge_lane(scratch, 0)
        if self.secondary_slots and self.spec.merge is None:
            self._fold_lane(scratch, self.primary_slots, 0)
        self._res.merge_state(self._fresh)
        self.plan_secondary(np.zeros(self.primary_slots, np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        d = compilemon.since(before)
        self._aot_info = {
            "widths": [int(w) for w in self._aot_widths],
            "group_buckets": [int(b) for b in self._group_buckets],
            "admit_buckets": [int(b) for b in self._admit_buckets],
            "n_executables": len(self._aot),
            "warmup_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "warmup_compiles": int(d.n_compiles),
            "warmup_compile_ms": float(d.stall_ms),
        }
        return self._aot_info

    def _lane_group(self, slot: int) -> List[int]:
        """The lanes a primary slot owns: its primary lane and every
        secondary lane granted to it."""
        return [slot] + [self.primary_slots + j for j in range(self.secondary_slots)
                         if self._sec_assign[j] == slot]

    def _take_striped(self, s: _Session, lanes: List[int], flush_tail: bool):
        """Pop the session's pending chunks and stripe them round-robin over
        its lane group, with the flush accounting -- the one striping rule
        every flush tier uses."""
        chunks, masks = self._take_chunks(s, flush_tail=flush_tail)
        gc: List[List[np.ndarray]] = [[] for _ in lanes]
        gm: List[List[np.ndarray]] = [[] for _ in lanes]
        for k, (c, m) in enumerate(zip(chunks, masks)):
            g = k % len(lanes)
            gc[g].append(c)
            gm[g].append(m)
            if lanes[g] != s.slot:
                s.stats.sec_lane_flushes += 1
        n_real = int(sum(m.sum() for m in masks))
        s.stats.tuples_flushed += n_real
        s.stats.chunks_flushed += len(chunks)
        return gc, gm, n_real

    @staticmethod
    def _batch_width(lane_chunks) -> int:
        """Scan width of a flush batch without buckets: the widest lane's
        chunk count rounded up to a power of two; 0 when nothing is
        pending."""
        w = max((len(c) for c in lane_chunks), default=0)
        return 1 << (w - 1).bit_length() if w else 0

    def _pack_chunks(self, lane_chunks, lane_masks, width, offset=0):
        """Per-lane chunk/mask lists packed into the dense
        [lanes, width, chunk, feat] host batch that ``scan_lanes`` takes,
        window ``[offset, offset + width)`` of each lane; unfilled rows stay
        all-masked zero padding (exact no-ops)."""
        c = self.chunk_size
        feat = self._feat_shape or (1,)
        chunks = np.zeros((len(lane_chunks), width, c, *feat), self._dtype or np.int32)
        mask = np.zeros((len(lane_chunks), width, c), bool)
        for ln in range(len(lane_chunks)):
            row_c = lane_chunks[ln][offset:offset + width]
            row_m = lane_masks[ln][offset:offset + width]
            for k, (ch, m) in enumerate(zip(row_c, row_m)):
                chunks[ln, k] = ch
                mask[ln, k] = m
        return chunks, mask

    def _apply_exec_stats(self, stats, row_sessions, row_counts):
        """Fold the scan's per-(lane, chunk) ExecStats into each row's
        owning session (the first ``row_counts[row]`` entries are real).
        An all-padding batch never copies the stats to the host."""
        live = [(row, s, k) for row, (s, k) in enumerate(zip(row_sessions, row_counts))
                if s is not None and k > 0]
        if not live:
            return
        cycles = stats.modeled_cycles.cpu().numpy()       # [rows, width]
        loads = stats.max_load.cpu().numpy()
        resched = stats.rescheduled.cpu().numpy()
        for row, s, k in live:
            s.stats.modeled_cycles += float(cycles[row, :k].sum())
            s.stats.max_load = max(s.stats.max_load, int(loads[row, :k].max()))
            s.stats.exec_reschedules += int(resched[row, :k].sum())

    def _take_chunks(self, s: _Session, flush_tail: bool):
        """Pop full chunks (and, when forced, the masked ragged tail) off a
        session's backlog; the sub-chunk remainder stays buffered."""
        c = self.chunk_size
        avail = s.backlog_tuples
        take = avail if flush_tail else (avail // c) * c
        if not take:
            return [], []
        data = self._pop_backlog(s, take)
        nfull = len(data) // c
        chunks = [data[k * c:(k + 1) * c] for k in range(nfull)]
        masks = [np.ones(c, bool)] * nfull
        if nfull * c < len(data):
            padded, m = pad_tail_chunk(data[nfull * c:], c)
            chunks.append(padded)
            masks.append(m)
        return chunks, masks

    @staticmethod
    def _pop_backlog(s: _Session, n: int) -> np.ndarray:
        """Consume exactly ``n`` tuples off the backlog front; a partially
        consumed head only advances ``backlog_off`` (never re-copied)."""
        parts: List[np.ndarray] = []
        need = n
        while need:
            head = s.backlog[0]
            rest = len(head) - s.backlog_off
            if rest <= need:
                parts.append(head[s.backlog_off:])
                s.backlog.popleft()
                s.backlog_off = 0
                need -= rest
            else:
                parts.append(head[s.backlog_off:s.backlog_off + need])
                s.backlog_off += need
                need = 0
        s.backlog_tuples -= n
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    # ------------------------------------------------------- slot scheduling

    def _admit(self) -> List[int]:
        """Admit queued sids into free primary slots: strictly FIFO, each
        into the lowest-numbered free slot (a min-heap).  Returns the
        admitted sids."""
        admitted: List[int] = []
        while self._queue and self._free_slots:
            sid = self._queue.popleft()
            slot = heapq.heappop(self._free_slots)
            self._slot_sid[slot] = sid
            self.sessions[sid].slot = slot
            admitted.append(sid)
        return admitted

    def _backlog_chunks(self) -> np.ndarray:
        """Per-primary-slot pending chunk counts: the serving layer's
        workload histogram (sessions are the tuples, slots the PEs)."""
        out = np.zeros(self.primary_slots, np.float32)
        for slot, sid in enumerate(self._slot_sid):
            if sid is not None:
                out[slot] = self.sessions[sid].backlog_tuples // self.chunk_size
        return out

    def plan_secondary(self, backlog_chunks: np.ndarray) -> np.ndarray:
        """Greedy max-backlog splitting: ``scheduler.schedule_secpes`` over
        the per-slot chunk backlog (a host tensor: slot bookkeeping), with
        grants to sessions below ``min_grant_chunks`` suppressed."""
        if self.secondary_slots == 0:
            return np.zeros(0, np.int64)
        plan = scheduler.schedule_secpes(
            torch.as_tensor(np.asarray(backlog_chunks, np.float32)),
            self.secondary_slots, min_load=float(self.min_grant_chunks))
        return plan.numpy().astype(np.int64)

    def _reschedule_secondary(self) -> None:
        backlog = self._backlog_chunks()
        new = self.plan_secondary(backlog)
        for j in range(self.secondary_slots):
            old = int(self._sec_assign[j])
            if old == int(new[j]):
                continue
            if old >= 0:
                # the lifted §IV-B merge: the shadow lane folds into its old
                # session's primary lane before re-assignment
                self._states = self._fold_lane(self._states, self.primary_slots + j, old)
                self._slot_reschedules += 1
            self._sec_assign[j] = new[j]
            if self.obs.enabled and int(new[j]) >= 0:
                sid = self._slot_sid[int(new[j])]
                if sid is not None:
                    self._mx.grants.inc(tenant=self.sessions[sid].tenant)
        if self.obs.enabled and self.secondary_slots:
            summary = scheduler.plan_summary(backlog, new)
            self._mx.sched_granted.set(summary["n_granted"])
            self._mx.sched_load.set(summary["max_load_after"])

    # ------------------------------------------------------------- snapshots

    def _snapshot(self, s: _Session):
        if s.slot is None:
            # only reachable closing an empty queued session: nothing ran
            return _to_numpy(self._res.merge_state(self._fresh))
        with self.obs.span("merge.snapshot", cat="merge", sid=s.sid, tenant=s.tenant):
            merged = _to_numpy(self._merge_lane(self._states, s.slot))
            combine = np.add if self.spec.combine == "add" else np.maximum
            for j in range(self.secondary_slots):
                if self._sec_assign[j] == s.slot:
                    contrib = _to_numpy(self._merge_lane(self._states,
                                                         self.primary_slots + j))
                    merged = combine(merged, contrib)
        return merged

    # ------------------------------------------------------------- telemetry

    def _record_flush(self, tuples: int, lane_chunks, width: int,
                      scope: str = "engine", snap=None,
                      extra: Optional[Dict[str, Any]] = None,
                      ms: Optional[float] = None) -> None:
        delta = compilemon.since(snap) if snap is not None else None
        if delta is not None:
            self._n_retraces += delta.n_compiles
            self._compile_stall_ms += delta.stall_ms
        active = sum(sid is not None for sid in self._slot_sid)
        backlog = sum(s.backlog_tuples for s in self.sessions.values() if not s.closed)
        row = {
            "flush": self._flush_no,
            "scope": scope,
            "active_sessions": active,
            "queued_sessions": len(self._queue),
            "tuples": int(tuples),
            "chunks": int(sum(len(c) for c in lane_chunks)),
            "lane_width": int(width),
            "sec_granted": int((self._sec_assign >= 0).sum()),
            "slot_reschedules": int(self._slot_reschedules),
            "backlog_tuples": int(backlog),
            "slot_occupancy": round(active / self.primary_slots, 4),
            "n_retraces": 0 if delta is None else int(delta.n_compiles),
            "compile_stall_ms": 0.0 if delta is None else float(delta.stall_ms),
            "flush_ms": None if ms is None else round(ms, 3),
        }
        if extra:
            row.update(extra)
        if (self._telemetry.maxlen is not None
                and len(self._telemetry) == self._telemetry.maxlen):
            self._telemetry_dropped += 1
            self._mx.tele_dropped.inc()
        self._telemetry.append(row)
        self._telemetry_total += 1
        if self.obs.enabled:
            self._emit_flush_metrics(row, ms)

    # floor between two lane/tenant gauge rescans in _emit_flush_metrics
    # (a class attribute, so a test can zero it to rescan every flush)
    _GAUGE_SCAN_S = 0.05

    def _emit_flush_metrics(self, row: Dict[str, Any], ms: Optional[float]) -> None:
        """Mirror one telemetry row into the metrics registry (counters add
        the per-flush deltas, gauges track the latest state); per-lane and
        per-tenant series are capped."""
        m, scope = self._mx, row["scope"]
        m.flushes.inc(scope=scope)
        m.tuples.inc(row["tuples"])
        m.chunks.inc(row["chunks"])
        m.retraces.inc(row["n_retraces"])
        m.stall.inc(row["compile_stall_ms"])
        if ms is not None:
            m.flush_ms.observe(ms, scope=scope)
        m.active.set(row["active_sessions"])
        m.queued.set(row["queued_sessions"])
        m.slot_occ.set(row["slot_occupancy"])
        m.backlog_tot.set(row["backlog_tuples"])
        m.sec_granted.set(row["sec_granted"])
        if row["n_retraces"]:
            self.obs.tracer.instant("compile.retrace", cat="compile", scope=scope,
                                    n=row["n_retraces"],
                                    stall_ms=row["compile_stall_ms"])
        if scope == "session":
            return      # lane/tenant gauges reflect engine-wide state
        now = time.monotonic()
        if now - self._gauge_scan_last < self._GAUGE_SCAN_S:
            return
        self._gauge_scan_last = now
        busy = {slot for slot, sid in enumerate(self._slot_sid) if sid is not None}
        busy |= {self.primary_slots + j for j in range(self.secondary_slots)
                 if self._sec_assign[j] >= 0}
        m.lanes_busy.set(len(busy))
        if self.num_lanes <= m.MAX_LANE_SERIES:
            for ln in range(self.num_lanes):
                m.occupancy.set(1.0 if ln in busy else 0.0, lane=str(ln))
        depth: Dict[str, int] = {}
        for sid in self._slot_sid:
            if sid is not None:
                s = self.sessions[sid]
                depth[s.tenant] = depth.get(s.tenant, 0) + s.backlog_tuples
        tenants = sorted(depth, key=lambda t: (-depth[t], t))
        for tenant in tenants[:m.MAX_TENANT_SERIES]:
            m.backlog.set(depth[tenant], tenant=tenant)

    # ------------------------------------------------------- live load views

    def lane_loads(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(loads, occupied)``: per-primary-slot backlog in chunks and a
        boolean occupancy mask (what ``obs.skew`` reads)."""
        occupied = np.array([sid is not None for sid in self._slot_sid], dtype=bool)
        return self._backlog_chunks().astype(np.float64), occupied

    def tenant_loads(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """``(occupancy, backlog_tuples)`` per tenant over open sessions,
        slot-held and queued alike (the Eq. 2 admission score's heat)."""
        occ: Dict[str, int] = {}
        bl: Dict[str, int] = {}
        for s in self.sessions.values():
            if s.closed:
                continue
            occ[s.tenant] = occ.get(s.tenant, 0) + 1
            bl[s.tenant] = bl.get(s.tenant, 0) + int(s.backlog_tuples)
        return occ, bl

    @property
    def slot_reschedules(self) -> int:
        """Lifetime secondary-lane re-assignments (the lifted §IV-B merges)."""
        return self._slot_reschedules

    def stats_dict(self) -> Dict[str, Any]:
        """Occupancy, queue depths and lifetime totals as one JSON-able dict."""
        return {
            "open_sessions": sum(not s.closed for s in self.sessions.values()),
            "free_slots": len(self._free_slots),
            "engine_queue": len(self._queue),
            "primary_slots": self.primary_slots,
            "secondary_slots": self.secondary_slots,
            "totals": self.telemetry_record(validate=False)["extra"]["totals"],
        }

    def telemetry_record(self, validate: bool = True) -> Dict[str, Any]:
        """Per-flush telemetry as a schema-v1 benchmark record (the shape
        ``benchmarks.common.validate_record`` accepts): rows = the ring's
        per-flush dicts, extra = engine config, lifetime totals and ring
        accounting.  ``validate=True`` checks only the rows appended since
        the last validated call."""
        totals = {
            "sessions_opened": self._next_sid,
            "flushes": self._flush_no,
            "slot_reschedules": self._slot_reschedules,
            "tuples_flushed": int(sum(s.stats.tuples_flushed
                                      for s in self.sessions.values())),
            "n_retraces": int(self._n_retraces),
            "compile_stall_ms": round(self._compile_stall_ms, 3),
            "storms": int(self._storms),
            "batch_admitted": int(self._n_admitted_batch),
            "n_retraces_admit": int(self._n_retraces_admit),
            "admit_stall_ms": round(self._admit_stall_ms, 3),
        }
        rows = list(self._telemetry)
        rec = {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "bench": "session_engine",
            "title": (f"SessionEngine telemetry ({self.spec.name}, "
                      f"{self.primary_slots}P+{self.secondary_slots}S slots)"),
            "status": "ok",
            "rows": rows,
            "extra": {
                "config": {
                    "app": self.spec.name,
                    "num_pri": self.num_pri, "num_sec": self.num_sec,
                    "chunk_size": self.chunk_size,
                    "primary_slots": self.primary_slots,
                    "secondary_slots": self.secondary_slots,
                    "mesh_devices": None if self.mesh is None else self.mesh.size,
                    "lanes_per_device": self.lanes_per_device,
                    "aot_buckets": (None if self._aot_widths is None
                                    else int(self._aot_widths[-1])),
                },
                "aot": self._aot_info,
                "totals": totals,
                "telemetry": {
                    "cap": self.telemetry_cap,
                    "rows_total": int(self._telemetry_total),
                    "dropped_rows": int(self._telemetry_dropped),
                },
            },
        }
        if validate:
            try:
                from benchmarks.common import validate_record
            except ImportError:          # src-only install: no validator
                pass
            else:
                # the unvalidated suffix of the retained window starts at
                # the validated count minus the rows the ring dropped
                new_from = max(self._rows_validated
                               - (self._telemetry_total - len(rows)), 0)
                validate_record({**rec, "rows": rows[new_from:]})
                self._rows_validated = self._telemetry_total
        return rec

    # ------------------------------------------------------------ durability

    @classmethod
    def recover(cls, spec, directory, *, mesh=None, device="cuda", guard=None,
                **overrides):
        """Resume a crashed or preempted durable engine from ``directory``
        (``serve.durability.recover``): restore the newest lane-state
        checkpoint, replay the WAL tail past its watermark, and return a
        ``DurableSessionEngine`` whose open sessions answer as an
        uninterrupted run would."""
        from repro_torch.serve import durability
        return durability.recover(spec, directory, mesh=mesh, device=device,
                                  guard=guard, **overrides)

    # --------------------------------------------------------------- helpers

    def session_stats(self, sid: int) -> Dict[str, Any]:
        return self._session(sid, allow_closed=True).stats.as_dict()

    def _session(self, sid: int, allow_closed: bool = False) -> _Session:
        s = self.sessions.get(sid)
        if s is None:
            n_open = sum(not x.closed for x in self.sessions.values())
            raise UnknownSessionError(
                f"unknown session id {sid}: this engine has issued "
                f"{self._next_sid} sid(s), {n_open} open "
                f"({len(self._queue)} of them queued) -- append/query/"
                "close need a sid returned by open()/open_batch()")
        if s.closed and not allow_closed:
            raise ClosedSessionError(
                f"session {sid} (tenant {s.tenant!r}) is closed; a "
                "closed sid cannot be reused -- open() a new session")
        return s
