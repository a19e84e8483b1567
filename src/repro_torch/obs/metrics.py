"""Engine-wide metrics registry: counters, gauges, fixed-bucket
histograms with label sets.

A copy of ``repro/obs/metrics.py`` (pure Python); the Prometheus text it
exposes is byte for byte the JAX package's for the same operations.

The paper's core claim is *runtime* workload balance -- secondary PEs
granted when the dispatcher observes overload -- so the serving layers
need a uniform way to expose that runtime behavior: how deep is each
tenant's backlog, which lanes are occupied, how often did the scheduler
re-grant, how much wall-clock went to WAL fsyncs or compile stalls.
This module is the one sink every layer writes into:

    from repro_torch.obs import metrics
    reg = metrics.MetricsRegistry()
    flush_ms = reg.histogram("flush_latency_ms", "flush wall time",
                             labels=("scope",))
    flush_ms.observe(3.2, scope="engine")
    grants = reg.counter("secondary_grants_total", labels=("tenant",))
    grants.inc(tenant="zipf1.5")

Two exports:

  * ``MetricsRegistry.prometheus_text()`` -- the Prometheus text
    exposition format (``# HELP`` / ``# TYPE`` + samples; histograms as
    cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``), scrapeable
    by a fleet operator and round-trippable through
    ``parse_prometheus`` (the bench asserts the round trip);
  * ``MetricsRegistry.snapshot()`` -- a schema-v1-compatible benchmark
    record (the shape ``benchmarks.common.validate_record`` accepts):
    one flat row per sample, full histogram bucket detail under
    ``extra["histograms"]``.

Registries are plain host-side dicts: an increment is one dict write,
so instrumenting the flush path costs nanoseconds, and ``enabled=False``
turns every op into an early return (the bench measures the residue:
the ``obs_overhead_pct`` headline must stay under its bound).

Thread-safety: ops take a registry-wide lock only on family *creation*;
sample updates are plain dict writes (atomic enough under the GIL for
the single-writer engines here).  Cross-thread exactness is not a goal
-- Prometheus scrapes are eventually consistent by design.
"""
from __future__ import annotations

import bisect
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

# latency-shaped default buckets (milliseconds): sub-ms flushes through
# multi-second compile stalls all land in a real bucket
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


class _Family:
    """Shared machinery for one named metric family with a fixed label
    schema: samples keyed by the tuple of label VALUES."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labels: Tuple[str, ...]):
        self._reg = registry
        self.name = name
        self.help = help
        self.labels = labels
        self.samples: Dict[Tuple[str, ...], Any] = {}

    def _key(self, kw: Dict[str, Any]) -> Tuple[str, ...]:
        # hot path: the engine emits tens of ops per flush, so the
        # common cases (no labels; exactly the declared labels) must
        # not pay the sorted-tuple comparison every call
        if not kw:
            if not self.labels:
                return ()
        elif len(kw) == len(self.labels):
            try:
                return tuple(str(kw[k]) for k in self.labels)
            except KeyError:
                pass
        raise ValueError(
            f"{self.name}: got labels {tuple(sorted(kw))}, family "
            f"declares {tuple(sorted(self.labels))}")


class Counter(_Family):
    """Monotone counter.  ``inc(v)`` with v >= 0."""

    kind = "counter"

    def inc(self, v: float = 1.0, **labels) -> None:
        if not self._reg.enabled:
            return
        if v < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {v})")
        k = self._key(labels)
        self.samples[k] = self.samples.get(k, 0.0) + v

    def value(self, **labels) -> float:
        return float(self.samples.get(self._key(labels), 0.0))


class Gauge(_Family):
    """Point-in-time value.  ``set(v)`` / ``add(v)``."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not self._reg.enabled:
            return
        self.samples[self._key(labels)] = float(v)

    def add(self, v: float, **labels) -> None:
        if not self._reg.enabled:
            return
        k = self._key(labels)
        self.samples[k] = self.samples.get(k, 0.0) + v

    def value(self, **labels) -> float:
        return float(self.samples.get(self._key(labels), 0.0))


class Histogram(_Family):
    """Fixed-bucket histogram: per label set, cumulative bucket counts
    (+Inf implicit), sum and count -- the Prometheus histogram shape."""

    kind = "histogram"

    def __init__(self, registry, name, help, labels,
                 buckets: Iterable[float] = DEFAULT_MS_BUCKETS):
        super().__init__(registry, name, help, labels)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"{name}: a histogram needs >= 1 bucket bound")
        self.buckets = bs

    def observe(self, v: float, **labels) -> None:
        if not self._reg.enabled:
            return
        k = self._key(labels)
        st = self.samples.get(k)
        if st is None:
            st = self.samples[k] = {"counts": [0] * (len(self.buckets) + 1),
                                    "sum": 0.0, "count": 0}
        v = float(v)
        # first bucket with bound >= v (same containment as the
        # linear "v <= b" walk, at C speed)
        st["counts"][bisect.bisect_left(self.buckets, v)] += 1
        st["sum"] += v
        st["count"] += 1

    def count(self, **labels) -> int:
        st = self.samples.get(self._key(labels))
        return 0 if st is None else int(st["count"])

    def sum(self, **labels) -> float:
        st = self.samples.get(self._key(labels))
        return 0.0 if st is None else float(st["sum"])


class MetricsRegistry:
    """Process/engine-scoped family store.  Re-requesting a name returns
    the existing family (its type and label schema must match)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _make(self, cls, name: str, help: str, labels, **kw) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        labels = tuple(labels)
        for lb in labels:
            if not _LABEL_RE.match(lb):
                raise ValueError(f"{name}: bad label name {lb!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.labels != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labels}, not {cls.kind}{labels}")
                return fam
            fam = cls(self, name, help, labels, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_MS_BUCKETS
                  ) -> Histogram:
        return self._make(Histogram, name, help, labels, buckets=buckets)

    def families(self) -> List[_Family]:
        return [self._families[n] for n in sorted(self._families)]

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    # ------------------------------------------------------------- exports

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (v0.0.4): HELP/TYPE per
        family, one line per sample; histograms expand to cumulative
        ``_bucket{le=...}`` + ``_sum`` + ``_count``.  Round-trips through
        ``parse_prometheus``."""
        out: List[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key in sorted(fam.samples):
                if isinstance(fam, Histogram):
                    st = fam.samples[key]
                    cum = 0
                    for b, c in zip(fam.buckets, st["counts"]):
                        cum += c
                        lbl = _fmt_labels(fam.labels, key,
                                          (("le", repr(float(b))),))
                        out.append(f"{fam.name}_bucket{lbl} {cum}")
                    lbl = _fmt_labels(fam.labels, key, (("le", "+Inf"),))
                    out.append(f"{fam.name}_bucket{lbl} {st['count']}")
                    base = _fmt_labels(fam.labels, key)
                    out.append(f"{fam.name}_sum{base} {st['sum']!r}")
                    out.append(f"{fam.name}_count{base} {st['count']}")
                else:
                    lbl = _fmt_labels(fam.labels, key)
                    out.append(f"{fam.name}{lbl} {fam.samples[key]!r}")
        return "\n".join(out) + "\n"

    def snapshot(self, validate: bool = False) -> Dict[str, Any]:
        """Schema-v1-compatible metrics record: one flat scalar row per
        sample (histograms contribute their ``_sum``/``_count``), full
        bucket detail in ``extra["histograms"]``.  ``validate=True``
        checks it against ``benchmarks.common.validate_record`` when the
        benchmarks package is importable."""
        rows: List[Dict[str, Any]] = []
        hists: Dict[str, Any] = {}
        for fam in self.families():
            for key in sorted(fam.samples):
                lbl = ",".join(f"{k}={v}" for k, v in zip(fam.labels, key))
                if isinstance(fam, Histogram):
                    st = fam.samples[key]
                    rows.append({"metric": fam.name + "_sum", "type": fam.kind,
                                 "labels": lbl, "value": float(st["sum"])})
                    rows.append({"metric": fam.name + "_count",
                                 "type": fam.kind, "labels": lbl,
                                 "value": float(st["count"])})
                    hists.setdefault(fam.name, {
                        "buckets": list(fam.buckets), "series": {}})
                    hists[fam.name]["series"][lbl] = list(st["counts"])
                else:
                    rows.append({"metric": fam.name, "type": fam.kind,
                                 "labels": lbl,
                                 "value": float(fam.samples[key])})
        rec = {
            "schema_version": 1,
            "bench": "obs_metrics",
            "title": f"obs metrics snapshot ({len(self._families)} families,"
                     f" {len(rows)} samples)",
            "status": "ok",
            "rows": rows,
            "extra": {"histograms": hists,
                      "families": {f.name: f.kind for f in self.families()}},
        }
        if validate:
            try:
                from benchmarks.common import validate_record
            except ImportError:              # src-only install
                pass
            else:
                validate_record(rec)
        return rec


# ---------------------------------------------------------------------------
# Prometheus text parser (the round-trip check)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$")
_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse Prometheus text exposition into ``(name, labels, value)``
    samples.  Strict on sample lines (a malformed line raises
    ``ValueError``): this is the validator the bench round-trips the
    export through, so silently skipping garbage would defeat it."""
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: not a prometheus sample: {line!r}")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            consumed = 0
            for pm in _PAIR_RE.finditer(raw):
                labels[pm.group(1)] = (
                    pm.group(2).replace("\\n", "\n").replace('\\"', '"')
                    .replace("\\\\", "\\"))
                consumed += len(pm.group(0))
            if consumed < len(raw.replace(",", "")):
                raise ValueError(f"line {ln}: malformed labels: {raw!r}")
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(f"line {ln}: bad value "
                             f"{m.group('value')!r}") from e
        samples.append((m.group("name"), labels, value))
    return samples


_TYPE_RE = re.compile(r"^#\s*TYPE\s+([a-zA-Z_:][a-zA-Z0-9_:]*)\s+(\w+)")


def snapshot_from_prometheus(text: str) -> Dict[str, Any]:
    """Rebuild a ``MetricsRegistry.snapshot()``-shaped record from
    scraped Prometheus text -- the inverse direction the live-scrape
    report path needs (``python -m repro_torch.obs.report --url`` renders a
    remote registry it never held in-process).  Histogram families are
    re-assembled from their ``_bucket``/``_sum``/``_count`` expansion
    (cumulative bucket counts de-cumulated back to per-bucket counts);
    counters and gauges map straight to rows.  Strict: inherits
    ``parse_prometheus``'s ValueError on any malformed sample line."""
    kinds: Dict[str, str] = {}
    for line in text.splitlines():
        m = _TYPE_RE.match(line.strip())
        if m:
            kinds[m.group(1)] = m.group(2)
    hist_names = {n for n, k in kinds.items() if k == "histogram"}

    def _base(name: str) -> Optional[Tuple[str, str]]:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in hist_names:
                return name[:-len(suffix)], suffix
        return None

    rows: List[Dict[str, Any]] = []
    # {base: {"buckets": {le,...}, "series": {lbl: {le: cum}},
    #         "sum": {lbl: v}, "count": {lbl: v}}}
    hist: Dict[str, Dict[str, Any]] = {}
    for name, labels, value in parse_prometheus(text):
        split = _base(name)
        if split is None:
            lbl = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
            rows.append({"metric": name,
                         "type": kinds.get(name, "untyped"),
                         "labels": lbl, "value": float(value)})
            continue
        base, suffix = split
        h = hist.setdefault(base, {"buckets": set(), "series": {},
                                   "sum": {}, "count": {}})
        bare = {k: v for k, v in labels.items() if k != "le"}
        lbl = ",".join(f"{k}={bare[k]}" for k in sorted(bare))
        if suffix == "_bucket":
            le = labels.get("le", "+Inf")
            if le != "+Inf":
                h["buckets"].add(float(le))
            h["series"].setdefault(lbl, {})[le] = float(value)
        elif suffix == "_sum":
            h["sum"][lbl] = float(value)
        else:
            h["count"][lbl] = float(value)

    hists: Dict[str, Any] = {}
    for base in sorted(hist):
        h = hist[base]
        buckets = sorted(h["buckets"])
        series: Dict[str, List[int]] = {}
        for lbl, cums in sorted(h["series"].items()):
            counts, prev = [], 0.0
            for b in buckets:
                cum = cums.get(repr(b), cums.get(f"{b:g}", prev))
                counts.append(int(cum - prev))
                prev = cum
            total = cums.get("+Inf", h["count"].get(lbl, prev))
            counts.append(int(total - prev))        # the +Inf bucket
            series[lbl] = counts
            rows.append({"metric": base + "_sum", "type": "histogram",
                         "labels": lbl,
                         "value": float(h["sum"].get(lbl, 0.0))})
            rows.append({"metric": base + "_count", "type": "histogram",
                         "labels": lbl, "value": float(total)})
        hists[base] = {"buckets": buckets, "series": series}

    return {
        "schema_version": 1,
        "bench": "obs_metrics",
        "title": f"scraped metrics snapshot ({len(rows)} samples)",
        "status": "ok",
        "rows": rows,
        "extra": {"histograms": hists, "families": dict(kinds)},
    }
