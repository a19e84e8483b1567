"""Span tracer: nested timing spans exported as Chrome/Perfetto
``trace_event`` JSON.

A copy of ``repro/obs/trace.py``; the same API and output as the JAX
package's, plus the profiler ranges below.

A flush is a small pipeline -- admit, re-grant, pack, N scan segments,
merge -- and a slow query is almost always one stage of it (a WAL
fsync, a compile stall, one wide segment).  Counters say *that* it was
slow; spans say *where*.  ``SpanTracer`` records complete ("ph": "X")
events with microsecond timestamps; nesting falls out of time
containment on one thread track, which is exactly how the Perfetto /
``chrome://tracing`` UI renders call stacks::

    tracer = SpanTracer()
    with tracer.span("engine.flush", scope="engine"):
        with tracer.span("scan.segment", width=4):
            ...
    tracer.write("flush_timeline.json")     # load in ui.perfetto.dev

Every span carries its attributes in ``args`` (visible in the viewer's
detail pane).  The event buffer is a ring (``cap`` events, oldest
dropped first, ``dropped`` counted) so a long-running engine holds a
bounded trace tail; ``enabled=False`` makes ``span()`` return a shared
no-op context (one attribute check per call on the disabled path).

One clock with the device: a span entered while ``torch.profiler`` records
also opens a profiler range of its name (``record_function``) for its life,
so the range sits among the profiler's host events beside the kernels it
launched.  The check is one flag read; with no profiler running, no range
is entered.  Spans emitted after the fact (``complete``,
``complete_batch``, ``defer``) and ``instant`` markers are not mirrored.

A body run too often for a span object a stage (the executor's chunk
step) takes ``stages()``: one span cut into consecutive stage spans at a
clock read a stage, recorded on exit under one ring lock.  A live span's
ring entry is its raw record ``(name, cat, t0_ns, t1_ns, tid, args)``,
built into its event dict only on export.
"""
from __future__ import annotations

import json
import os
import random
import re
import secrets
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from torch.autograd import profiler as _torch_profiler


# ---------------------------------------------------------------------------
# Wire trace context (docs/observability.md, docs/serving.md)
# ---------------------------------------------------------------------------
#
# A trace context is the part of a span that crosses process boundaries:
# {"trace_id": <hex>, "span_id": <hex>}.  Clients mint one per request
# and ship it in the protocol-v1 JSON header's optional ``trace`` field;
# the server adopts the ids so its request-root span (and every engine
# span it covers) can be correlated with the client side of the same
# request on one Perfetto timeline.  Adoption is TOTAL: any malformed
# context (wrong type, bad hex, oversized) falls back to a freshly
# minted trace id -- a garbage trace field must never surface as a wire
# error, only as a new trace.

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{1,32}$")

# ids are minted on the request hot path (client AND server side, per
# request), so crypto-strength randomness is wasted cycles: a process-
# seeded Mersenne generator is ~4x cheaper than secrets.token_hex and
# collision-safe for correlation ids (getrandbits is a C method, so
# concurrent minting from the loop + engine threads stays safe)
_mint_rng = random.Random(secrets.randbits(64))


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (64 random bits)."""
    return f"{_mint_rng.getrandbits(64):016x}"


def mint_span_id() -> str:
    """A fresh 8-hex-char span id (32 random bits)."""
    return f"{_mint_rng.getrandbits(32):08x}"


def new_trace_context() -> Dict[str, str]:
    """The wire-shaped context a client attaches to one request."""
    return {"trace_id": mint_trace_id(), "span_id": mint_span_id()}


def adopt_trace(raw: Any) -> Dict[str, Optional[str]]:
    """Adopt a wire ``trace`` field, however malformed.

    Returns ``{"trace_id": <valid hex id>, "parent_id": <hex id or
    None>}``.  A well-formed incoming context keeps its ids (lowercased);
    anything else -- missing field, non-dict, non-string ids, non-hex or
    oversized ids -- degrades to a freshly minted ``trace_id`` with no
    parent.  Never raises: old clients and fuzzed garbage take this
    path, and neither may produce a protocol error."""
    tid = pid = None
    if isinstance(raw, dict):
        t, p = raw.get("trace_id"), raw.get("span_id")
        if isinstance(t, str) and _TRACE_ID_RE.match(t.lower()):
            tid = t.lower()
        if isinstance(p, str) and _TRACE_ID_RE.match(p.lower()):
            pid = p.lower()
    return {"trace_id": tid if tid is not None else mint_trace_id(),
            "parent_id": pid}


class _NullSpan:
    """Reusable no-op context for the disabled fast path (of ``span()``
    and of ``stages()``, whose stage calls it ignores too)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, stage: str) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_range")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. tuple counts only
        known after the work ran)."""
        self.args.update(attrs)

    def __enter__(self):
        self._range = None
        if _torch_profiler._is_profiler_enabled:
            self._range = _torch_profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        now = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._tracer._emit((self.name, self.cat, self._t0, now,
                            threading.get_ident(), self.args))
        return False


class _Stages:
    """One live span cut into consecutive stages, each a span of its own
    (``SpanTracer.stages``)."""

    __slots__ = ("_tracer", "name", "cat", "_marks", "_ranges")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str):
        self._tracer = tracer
        self.name = name
        self.cat = cat

    def __enter__(self):
        self._ranges = None
        if _torch_profiler._is_profiler_enabled:
            outer = _torch_profiler.record_function(self.name)
            outer.__enter__()
            self._ranges = [outer]
        self._marks = [(self.name, time.perf_counter_ns())]
        return self

    def __call__(self, stage: str) -> None:
        """End the running stage, if any, and start ``stage``."""
        ranges = self._ranges
        if ranges is not None:
            if len(ranges) > 1:
                ranges.pop().__exit__(None, None, None)
            inner = _torch_profiler.record_function(stage)
            inner.__enter__()
            ranges.append(inner)
        self._marks.append((stage, time.perf_counter_ns()))

    def __exit__(self, *exc):
        now = time.perf_counter_ns()
        if self._ranges is not None:
            for r in reversed(self._ranges):
                r.__exit__(*exc)
        marks, tid, cat = self._marks, threading.get_ident(), self.cat
        ends = [t for _, t in marks[2:]] + [now]
        # the stages first, then the whole: the order of nested live spans
        self._tracer._append_events(
            [(stage, cat, t0, t1, tid, {}) for (stage, t0), t1 in zip(marks[1:], ends)]
            + [(self.name, cat, marks[0][1], now, tid, {})])
        return False


class SpanTracer:
    """Bounded in-memory trace_event recorder.

    Args:
      cap: max events retained (ring; oldest dropped, ``dropped``
        counts the loss so a truncated export is never silent).
      enabled: the global on/off switch -- when off, ``span()`` returns
        a shared no-op context.
    """

    def __init__(self, cap: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.cap = int(cap)
        self.dropped = 0
        self.dropped_deferred = 0
        self.pid = os.getpid()
        self._events: Deque[Any] = deque()   # event dicts and live spans' records
        self._lock = threading.Lock()
        # deferred span records: (make_events, payload) pairs materialized
        # lazily at export time (see defer())
        self._deferred: Deque[Any] = deque()
        # a stable epoch keeps ts small + monotone across the process
        self._epoch_us = time.perf_counter_ns() // 1000

    def span(self, name: str, cat: str = "engine", **attrs):
        """Context manager timing one span; ``attrs`` become the event's
        ``args``.  Nest freely -- containment on the thread track is the
        nesting the trace viewer renders.  Under a recording
        ``torch.profiler`` the span is also a profiler range of ``name``."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, attrs)

    def stages(self, name: str, cat: str = "engine"):
        """Context manager timing one span ``name`` whose body is cut
        into consecutive stage spans: calling it with a stage's name ends
        the running stage and starts that one::

            with tracer.stages("executor.step") as stage:
                stage("executor.route")
                ...
                stage("executor.schedule")
                ...

        The events are those of nested ``span()`` calls, at a clock read
        a stage, for a body run too often for a span object each.  Under
        a recording ``torch.profiler`` the span and each stage are
        profiler ranges of their names."""
        if not self.enabled:
            return _NULL_SPAN
        return _Stages(self, name, cat)

    def complete(self, name: str, cat: str = "engine", *,
                 t0_ns: int, t1_ns: int, **attrs) -> None:
        """Emit one complete span from explicit ``perf_counter_ns``
        endpoints -- for intervals measured where a context manager
        cannot wrap them (e.g. a request's queue wait, whose start was
        stamped on the event loop and whose end is only known once the
        engine worker picks the request up).  Emitted after the fact, it
        is no profiler range."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "X", "cat": cat,
                    "ts": t0_ns // 1000 - self._epoch_us,
                    "dur": max((t1_ns - t0_ns) // 1000, 1),
                    "pid": self.pid, "tid": threading.get_ident(),
                    "args": attrs})

    def complete_batch(self, spans) -> None:
        """Emit several complete spans under ONE ring-lock acquisition.

        ``spans`` is an iterable of ``(name, cat, t0_ns, t1_ns, tid,
        args)`` tuples; ``tid`` may be ``None`` for "this thread".  The
        request path emits its whole span tree (root + queue + engine +
        reply) per request, so batching the lock matters there -- and an
        explicit ``tid`` lets the loop thread place the engine span on
        the engine thread's track, where the ``engine.*`` spans it
        covers actually nest."""
        if not self.enabled:
            return
        self._append_events(self._build_events(spans))

    def _build_events(self, spans) -> List[Dict[str, Any]]:
        here = threading.get_ident()
        return [self._complete_event(name, cat, t0_ns, t1_ns,
                                     tid if tid is not None else here, args)
                for name, cat, t0_ns, t1_ns, tid, args in spans]

    def _complete_event(self, name, cat, t0_ns, t1_ns, tid, args) -> Dict[str, Any]:
        return {"name": name, "ph": "X", "cat": cat,
                "ts": t0_ns // 1000 - self._epoch_us,
                "dur": max((t1_ns - t0_ns) // 1000, 1),
                "pid": self.pid, "tid": tid, "args": args}

    def _append_events(self, evs: list) -> None:
        with self._lock:
            over = len(self._events) + len(evs) - self.cap
            for _ in range(min(max(over, 0), len(self._events))):
                self._events.popleft()
                self.dropped += 1
            self._events.extend(evs)

    def defer(self, builder, payload) -> None:
        """Queue one span batch for LAZY materialization: the hot path
        pays a single tuple append; ``builder(payload)`` runs at export
        time (``events()``/``write()``) and must return the
        ``complete_batch`` span-tuple list.  This is how the service
        emits per-request span trees at sub-microsecond request cost.

        Constraint: appends from one producer thread at a time (the
        service defers only from its event loop).  The record ring is
        capped at ``cap`` records; overflow drops the OLDEST record and
        counts it in ``dropped_deferred``."""
        if not self.enabled:
            return
        d = self._deferred
        if len(d) >= self.cap:
            try:
                d.popleft()
                self.dropped_deferred += 1
            except IndexError:
                pass
        d.append((builder, payload))

    def _materialize(self) -> None:
        """Drain the deferred ring into real events (idempotent; safe
        against concurrent defer() appends -- late arrivals just wait
        for the next export)."""
        d = self._deferred
        while True:
            try:
                make_events, payload = d.popleft()
            except IndexError:
                break
            # bypasses the enabled check: records deferred while the
            # tracer was on must materialize even if it is off by the
            # time someone exports
            self._append_events(self._build_events(make_events(payload)))

    def instant(self, name: str, cat: str = "engine", **attrs) -> None:
        """A zero-duration marker (rendered as an arrow/tick)."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "i", "cat": cat,
                    "ts": time.perf_counter_ns() // 1000 - self._epoch_us,
                    "pid": self.pid, "tid": threading.get_ident(),
                    "s": "t", "args": attrs})

    def _emit(self, ev) -> None:
        """Ring one event: its dict, or a live span's raw record
        ``(name, cat, t0_ns, t1_ns, tid, args)``."""
        with self._lock:
            if len(self._events) >= self.cap:
                self._events.popleft()
                self.dropped += 1
            self._events.append(ev)

    # ------------------------------------------------------------- exports

    def events(self) -> List[Dict[str, Any]]:
        self._materialize()
        with self._lock:
            ring = list(self._events)
        return [e if isinstance(e, dict) else self._complete_event(*e) for e in ring]

    def span_names(self) -> set:
        return {e["name"] for e in self.events()}

    def to_trace_events(self, process_name: str = "repro-engine"
                        ) -> Dict[str, Any]:
        """The Chrome/Perfetto ``trace_event`` JSON object format:
        ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` -- loadable
        as-is in ui.perfetto.dev or chrome://tracing."""
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "args": {"name": process_name}}]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def write(self, path: os.PathLike,
              process_name: str = "repro-engine") -> None:
        """Serialize the trace to ``path`` (JSON object format)."""
        with open(path, "w") as f:
            json.dump(self.to_trace_events(process_name), f,
                      default=_scrub)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._deferred.clear()
            self.dropped = 0
            self.dropped_deferred = 0


def _scrub(v):
    """JSON fallback for numpy scalars riding in span args."""
    try:
        return v.item()
    except AttributeError:
        return str(v)
