"""The port's observability layer: one registry, one tracer, one switch.

The counterpart of ``repro/obs/__init__.py``, with its API:

  * ``obs.metrics``  -- counters / gauges / fixed-bucket histograms with
    label sets, exported as Prometheus text (byte for byte the JAX
    package's) and as a schema-v1 record (``MetricsRegistry``);
  * ``obs.trace``    -- nested timing spans exported as Chrome/Perfetto
    ``trace_event`` JSON (``SpanTracer``), and the wire trace context;
  * ``obs.scrape``   -- ``ScrapeServer``: ``/metrics``, ``/healthz`` and
    ``/statusz`` over stdlib HTTP;
  * ``obs.skew``     -- ``SkewMonitor``'s imbalance, Eq. 2 score spread,
    grant churn and SLO-burn gauges;
  * ``obs.report``   -- ``python -m repro_torch.obs.report`` renders a
    health report from a snapshot or a scrape endpoint.

``Observability`` is the bundle the serving layers take as ``obs=``;
``enabled=False`` turns every metric op and span into an early return.
``get_default()`` is the process bundle that layers without an ``obs=``
write to (the ``executor_builds_total`` counter of
``make_resumable_executor``).

``region()`` is the composable build-attribution scope over the port's
``core.compilemon`` (nvcc builds and library loads): nested regions report
an ``exclusive`` delta (children subtracted) beside the raw ``inclusive``
one::

    with obs.region("warmup") as outer:
        ...                      # builds here -> outer.exclusive
        with obs.region("inner") as r:
            first_kernel_call()  # -> r.exclusive, outer.inclusive only
    outer.inclusive.n_compiles   # == outer.exclusive + inner.inclusive
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

from repro_torch.core import compilemon
from repro_torch.core.compilemon import CompileDelta
from repro_torch.obs.metrics import (DEFAULT_MS_BUCKETS, Counter, Gauge, Histogram,
                               MetricsRegistry, parse_prometheus)
from repro_torch.obs.trace import (SpanTracer, adopt_trace, mint_span_id,
                             mint_trace_id, new_trace_context)

__all__ = ["Counter", "DEFAULT_MS_BUCKETS", "Gauge", "Histogram",
           "MetricsRegistry", "Observability", "Region", "SpanTracer",
           "adopt_trace", "get_default", "mint_span_id", "mint_trace_id",
           "new_trace_context", "parse_prometheus", "region"]


class Observability:
    """One registry + one tracer + one switch, shared by every layer of
    an engine (and across engines, when the caller passes the same
    bundle to several).

    Args:
      enabled: master switch; setting it flips the registry and tracer
        together (the bench toggles this to measure obs overhead).
      registry / tracer: share existing instances (e.g. one process-wide
        registry scraped by a single exporter); fresh ones by default.
      trace_cap: ring size for the tracer when one is created here.
    """

    def __init__(self, *, enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 trace_cap: int = 65536):
        self.registry = registry if registry is not None \
            else MetricsRegistry(enabled=enabled)
        self.tracer = tracer if tracer is not None \
            else SpanTracer(cap=trace_cap, enabled=enabled)
        self.enabled = enabled

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on: bool) -> None:
        self._enabled = bool(on)
        self.registry.enabled = self._enabled
        self.tracer.enabled = self._enabled

    def span(self, name: str, cat: str = "engine", **attrs):
        return self.tracer.span(name, cat, **attrs)


_default: Optional[Observability] = None
_default_lock = threading.Lock()


def get_default() -> Observability:
    """The lazily created process-default bundle -- what layers without
    an explicit ``obs=`` wiring point (e.g. executor builds) write to."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Observability()
        return _default


def resolve(obs) -> Observability:
    """Normalize an ``obs=`` argument: ``None`` -> a fresh enabled
    bundle, ``True``/``False`` -> a fresh bundle switched accordingly,
    an ``Observability`` passes through (shared)."""
    if isinstance(obs, Observability):
        return obs
    if obs is None:
        return Observability()
    return Observability(enabled=bool(obs))


# ---------------------------------------------------------------------------
# Composable compile-attribution regions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Region:
    """Result of one ``region()`` scope.

    ``inclusive`` is the plain ``compilemon`` delta over the region
    (children included -- identical to a raw snapshot/since pair);
    ``exclusive`` subtracts every directly nested ``region()``'s
    inclusive delta, so a compile is attributed to exactly one region
    at each nesting level.  Both are ``None`` until the scope exits.
    """

    name: str
    inclusive: Optional[CompileDelta] = None
    exclusive: Optional[CompileDelta] = None
    _child_compiles: int = 0
    _child_stall_ms: float = 0.0


_tls = threading.local()


@contextlib.contextmanager
def region(name: str = "region"):
    """Scoped compile attribution that COMPOSES under nesting (unlike
    raw ``compilemon.snapshot()``/``since()`` pairs, which double-count
    any overlap -- the contract in ``core/compilemon.py``)."""
    compilemon.install()
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    r = Region(name)
    snap = compilemon.snapshot()
    stack.append(r)
    try:
        yield r
    finally:
        stack.pop()
        d = compilemon.since(snap)
        r.inclusive = d
        r.exclusive = CompileDelta(
            n_compiles=d.n_compiles - r._child_compiles,
            stall_ms=round(d.stall_ms - r._child_stall_ms, 3))
        if stack:
            parent = stack[-1]
            parent._child_compiles += d.n_compiles
            parent._child_stall_ms += d.stall_ms
