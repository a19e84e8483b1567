"""Skew-aware SLO monitoring.

A copy of ``repro/obs/skew.py`` (pure Python); the same API and output as the
JAX package's.

The paper's diagnosis is that workload imbalance among PEs silently
destroys throughput on skewed data.  The serving stack replays that
failure mode one level up -- sessions are the tuples, slot lanes the
PEs -- so an operator needs a *continuous* imbalance signal, not a
post-run bench artifact: by the time p99 blows up, the skew that caused
it has been visible in the lane-load distribution for a while.

``SkewMonitor`` turns one engine's live state into that signal, as
plain gauges/histograms on the shared metrics registry (scrapeable via
``obs.scrape``, rendered by ``python -m repro_torch.obs.report``):

* **imbalance factor** -- max/mean backlog chunks over occupied
  primary slots, the serving analogue of the paper's PE load-balance
  ratio (1.0 = perfectly balanced, >> 1 = one hot lane drags the
  flush);
* **Eq. 2 score spread** -- max - min of
  ``core.scheduler.admission_score`` over open tenants (occupancy +
  backlog / (1 + occupancy)): the admission controller's own view of
  tenant heat, so a spread widening toward ``primary_slots`` means the
  coldest-tenant-wins policy is actively fighting a hog;
* **grant churn** -- secondary-lane re-assignments (the §IV-B
  shadow-buffer merges) per observation window: a rising churn rate
  means the SecPE scheduler is thrashing between hot tenants;
* **per-tenant e2e latency** -- request latency histograms plus
  SLO-burn counters (requests over ``slo_ms``), per tenant (top-N
  capped, overflow into ``_other`` so the series sum is still every
  request), with a rolling burn-rate gauge.

All computation is pure host-side numpy over state the engine already
holds -- no device sync, no trace -- and the request path is O(1) per
request (the burn window keeps a running violation count; the engine
rescan is rate-limited by ``min_interval_s``), because its cost is part
of the ``obs_overhead_pct`` bound the serving bench asserts.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import scheduler

# per-tenant series cap, same discipline as the engine's metric bundle
# (serve/session.py _EngineMetrics): past this many tenants, only the
# aggregate series and the hottest tenants keep their own labels
MAX_TENANT_SERIES = 32

# latency-shaped buckets for the e2e histograms (wire RTT through
# multi-second stalls); importing the registry default keeps one shape
from repro_torch.obs.metrics import DEFAULT_MS_BUCKETS  # noqa: E402


class SkewMonitor:
    """Rolling skew / SLO metric computer over one ``SessionEngine``.

    Args:
      registry: the ``obs.MetricsRegistry`` the gauges register on
        (share the engine's registry so one scrape shows both).
      slo_ms: the per-request latency SLO; a request slower than this
        burns the error budget (``slo_violations_total``).
      window: rolling window length, in requests for the burn-rate
        gauge and in engine observations for the churn rate.
      min_interval_s: floor between two engine rescans --
        ``update_from_engine`` called more often than this returns the
        cached values without touching the engine (the service calls it
        after every worker batch; gauges only need freshness, not
        per-batch precision).  0 disables the throttle (tests).
    """

    def __init__(self, registry, *, slo_ms: float = 100.0,
                 window: int = 512, min_interval_s: float = 0.05):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms={slo_ms}: the SLO must be positive")
        if window < 1:
            raise ValueError(f"window={window}: need >= 1")
        self.slo_ms = float(slo_ms)
        self.window = int(window)
        self.min_interval_s = float(min_interval_s)
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.imbalance = g(
            "skew_imbalance_factor",
            "max/mean backlog chunks over occupied primary slots "
            "(1.0 = balanced; the paper's PE load ratio, lifted)")
        self.lane_max = g("skew_lane_max_load",
                          "hottest occupied slot's backlog chunks")
        self.lane_mean = g("skew_lane_mean_load",
                           "mean backlog chunks over occupied slots")
        self.score_spread = g(
            "skew_score_spread",
            "max - min Eq. 2 admission_score over open tenants")
        self.churn_total = c(
            "skew_grant_churn_total",
            "secondary-lane re-assignments observed (lifetime)")
        self.churn_rate = g(
            "skew_grant_churn_rate",
            "re-assignments per engine observation, rolling window")
        self.e2e = h("e2e_latency_ms",
                     "end-to-end request latency by tenant (top "
                     "tenants; overflow in '_other', so the sum over "
                     "series is the fleet aggregate)",
                     labels=("tenant",), buckets=DEFAULT_MS_BUCKETS)
        self.slo_requests = c("slo_requests_total",
                              "requests counted against the SLO",
                              labels=("tenant",))
        self.slo_violations = c("slo_violations_total",
                                "requests slower than the SLO",
                                labels=("tenant",))
        self.burn = g("skew_slo_burn_rate",
                      "violations / requests over the rolling window")
        self._burn_window: Deque[bool] = deque(maxlen=self.window)
        self._burn_viol = 0             # running sum over _burn_window
        self._churn_window: Deque[int] = deque(maxlen=self.window)
        self._churn_sum = 0             # running sum over _churn_window
        self._last_resched: Optional[int] = None
        self._last_scan_s: Optional[float] = None
        self._last_values: Dict[str, float] = {}
        self._tenant_series: Dict[str, None] = {}

    # ------------------------------------------------------ request path

    def _tenant_label(self, tenant: Optional[str]) -> str:
        """A bounded label: known tenants keep their name until the cap,
        later ones collapse into ``_other`` (one scrape cannot mint an
        unbounded series set)."""
        if tenant is None:
            return "_unknown"
        if tenant in self._tenant_series:
            return tenant
        if len(self._tenant_series) < MAX_TENANT_SERIES:
            self._tenant_series[tenant] = None
            return tenant
        return "_other"

    def observe_request(self, tenant: Optional[str], ms: float) -> None:
        """Record one finished request's end-to-end latency against the
        tenant's histogram and the SLO budget.  O(1): the burn window
        carries a running violation count (this runs once per wire
        request, on the event loop)."""
        label = self._tenant_label(tenant)
        ms = float(ms)
        self.e2e.observe(ms, tenant=label)
        violated = ms > self.slo_ms
        self.slo_requests.inc(tenant=label)
        if violated:
            self.slo_violations.inc(tenant=label)
        w = self._burn_window
        if len(w) == w.maxlen:
            self._burn_viol -= w[0]
        w.append(violated)
        self._burn_viol += violated
        self.burn.set(self._burn_viol / len(w))

    # ------------------------------------------------------- engine path

    def update_from_engine(self, engine, *,
                           force: bool = False) -> Dict[str, float]:
        """Recompute the imbalance gauges from one engine observation.

        Reads ``engine.lane_loads()`` / ``engine.tenant_loads()`` /
        ``engine.telemetry totals`` (all host-side state) and sets the
        gauges; returns the computed values so callers (tests, the
        health report) can see the same numbers the scrape would.
        Rescans at most once per ``min_interval_s`` unless ``force`` --
        a throttled call returns the previous observation."""
        if not force and self.min_interval_s > 0:
            now = time.monotonic()
            if (self._last_scan_s is not None
                    and now - self._last_scan_s < self.min_interval_s):
                return self._last_values
            self._last_scan_s = now
        loads, occupied = engine.lane_loads()
        busy = loads[occupied]
        if busy.size:
            mean = float(busy.mean())
            mx = float(busy.max())
            imb = mx / mean if mean > 0 else 1.0
        else:
            mean = mx = 0.0
            imb = 1.0
        occ_map, bl_map = engine.tenant_loads()
        if len(occ_map) >= 2:
            tenants = sorted(occ_map)
            scores = scheduler.admission_score(
                [bl_map.get(t, 0) for t in tenants],
                [occ_map[t] for t in tenants])
            spread = float(scores.max() - scores.min())
        else:
            spread = 0.0
        resched = int(engine.slot_reschedules)
        if self._last_resched is None:
            delta = 0
        else:
            delta = max(resched - self._last_resched, 0)
        self._last_resched = resched
        w = self._churn_window
        if len(w) == w.maxlen:
            self._churn_sum -= w[0]
        w.append(delta)
        self._churn_sum += delta
        churn_rate = self._churn_sum / len(w)
        self.imbalance.set(imb)
        self.lane_max.set(mx)
        self.lane_mean.set(mean)
        self.score_spread.set(spread)
        if delta:
            self.churn_total.inc(delta)
        self.churn_rate.set(churn_rate)
        self._last_values = {
            "imbalance_factor": imb, "lane_max_load": mx,
            "lane_mean_load": mean, "score_spread": spread,
            "grant_churn": float(delta),
            "grant_churn_rate": churn_rate}
        return self._last_values

    def summary(self) -> Dict[str, Any]:
        """The latest gauge values as one JSON-able dict (what the
        ``/statusz`` endpoint and the health report embed)."""
        n = len(self._burn_window)
        return {
            "slo_ms": self.slo_ms,
            "window": self.window,
            "imbalance_factor": self.imbalance.value(),
            "lane_max_load": self.lane_max.value(),
            "lane_mean_load": self.lane_mean.value(),
            "score_spread": self.score_spread.value(),
            "grant_churn_rate": self.churn_rate.value(),
            "slo_burn_rate": self.burn.value(),
            "requests_in_window": n,
        }


def imbalance_oracle(backlog_tuples, chunk_size: int
                     ) -> Tuple[float, float, float]:
    """Reference imbalance computation for tests: given per-occupied-
    slot backlog tuple counts, return (imbalance_factor, max, mean) of
    the per-slot CHUNK backlog -- the numbers ``update_from_engine``
    must reproduce from live engine state."""
    chunks = np.asarray([int(b) // int(chunk_size)
                         for b in backlog_tuples], np.float64)
    if not chunks.size:
        return 1.0, 0.0, 0.0
    mean = float(chunks.mean())
    mx = float(chunks.max())
    return (mx / mean if mean > 0 else 1.0), mx, mean
