"""Engine health report: render metrics + telemetry as an operator-
facing text dashboard.

A copy of ``repro/obs/report.py`` (pure Python); the same API and output as the
JAX package's.

Works from a LIVE engine, an exported snapshot file, or a running
service's scrape endpoints::

    # live (in-process)
    from repro_torch.obs import report
    print(report.render_engine(engine))

    # exported (what benchmarks/serving_session.py writes)
    python -m repro_torch.obs.report experiments/bench/serving_session_obs.json

    # live over HTTP (a SessionService with scrape_port set, or any
    # obs.scrape.ScrapeServer): /metrics + /statusz, re-rendered
    python -m repro_torch.obs.report --url http://127.0.0.1:9464

The snapshot file is either a bare ``MetricsRegistry.snapshot()`` record
or the combined ``{"metrics": <snapshot>, "telemetry":
<telemetry_record>}`` object ``export_engine`` produces.  Sections:

  * engine totals  -- flushes, retraces + compile stall, storms, drops;
  * latency        -- one ASCII histogram per latency family
    (``flush_latency_ms`` per scope, ``admit_latency_ms``,
    ``wal_fsync_ms``, ...);
  * lanes          -- the lane-occupancy / tenant-backlog skew heatmap
    (the serving layer's workload histogram: sessions are the tuples,
    slots the PEs);
  * grant history  -- per-flush secondary grants / re-schedules /
    retraces from the telemetry tail;
  * skew / SLO     -- the ``obs.skew.SkewMonitor`` gauges (imbalance
    factor, Eq. 2 score spread, grant churn, SLO burn) plus per-tenant
    violation counts, when the registry carries them.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

_BLOCKS = " ▁▂▃▄▅▆▇█"
_BAR_W = 30


def _bar(frac: float, width: int = _BAR_W) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "█" * n + "·" * (width - n)


def _heat(v: float, vmax: float) -> str:
    if vmax <= 0:
        return _BLOCKS[0]
    return _BLOCKS[min(int(v / vmax * (len(_BLOCKS) - 1)), len(_BLOCKS) - 1)]


def _labels_dict(lbl: str) -> Dict[str, str]:
    return dict(p.split("=", 1) for p in lbl.split(",") if "=" in p)


def export_engine(engine) -> Dict[str, Any]:
    """The combined snapshot object for an engine wired with ``obs=``:
    metrics registry snapshot + the engine's own telemetry record."""
    return {
        "metrics": engine.obs.registry.snapshot(),
        "telemetry": engine.telemetry_record(validate=False),
    }


def render_engine(engine) -> str:
    """Render the health report straight from a live engine."""
    return render(export_engine(engine))


def fetch_url(base: str, timeout: float = 10.0) -> Dict[str, Any]:
    """Scrape a live ``obs.scrape.ScrapeServer`` into the combined
    snapshot object ``render`` accepts: ``/metrics`` re-assembled
    through ``metrics.snapshot_from_prometheus`` (strict parse), plus
    the ``/statusz`` body under ``"status"`` (best-effort -- a sidecar
    without a status_fn still renders its metrics)."""
    import urllib.request

    from repro_torch.obs import metrics as metrics_lib
    base = base.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    with urllib.request.urlopen(base + "/metrics", timeout=timeout) as r:
        snap = metrics_lib.snapshot_from_prometheus(
            r.read().decode("utf-8"))
    status = None
    try:
        with urllib.request.urlopen(base + "/statusz",
                                    timeout=timeout) as r:
            status = json.loads(r.read().decode("utf-8"))
    except Exception:           # noqa: BLE001 - status page is optional
        pass
    out: Dict[str, Any] = {"metrics": snap}
    if status is not None:
        out["status"] = status
    return out


def render(snapshot: Dict[str, Any]) -> str:
    """Render a report from an exported snapshot (combined object or a
    bare metrics record)."""
    if "metrics" in snapshot and "rows" not in snapshot:
        metrics = snapshot["metrics"]
        telemetry = snapshot.get("telemetry")
        status = snapshot.get("status")
    else:
        metrics, telemetry, status = snapshot, None, None
    rows = metrics.get("rows", [])
    hists = metrics.get("extra", {}).get("histograms", {})
    out: List[str] = ["== engine health report =="]

    # ------------------------------------------------------------- totals
    totals: Dict[str, Any] = {}
    if telemetry:
        totals = telemetry.get("extra", {}).get("totals", {})
        cfg = telemetry.get("extra", {}).get("config", {})
        if cfg:
            out.append("engine: " + ", ".join(
                f"{k}={v}" for k, v in cfg.items() if v is not None))
    elif status:
        totals = (status.get("engine") or {}).get("totals", {}) or {}
        svc = status.get("service") or {}
        if svc:
            out.append("service: " + ", ".join(
                f"{k}={v}" for k, v in sorted(svc.items())
                if v is not None))
    counters = {(r["metric"], r["labels"]): r["value"] for r in rows
                if r.get("type") == "counter"}
    if totals or counters:
        out.append("-- totals --")
        for k in ("flushes", "tuples_flushed", "slot_reschedules",
                  "n_retraces", "compile_stall_ms", "storms",
                  "batch_admitted", "n_retraces_admit"):
            if k in totals:
                out.append(f"  {k:<24} {totals[k]}")
        tele = (telemetry or {}).get("extra", {}).get("telemetry", {})
        if tele:
            out.append(f"  {'telemetry_dropped_rows':<24} "
                       f"{tele.get('dropped_rows', 0)} "
                       f"(cap {tele.get('cap')})")
        for (name, lbl), v in sorted(counters.items()):
            if name.endswith("_total"):
                tag = f"{name}{{{lbl}}}" if lbl else name
                out.append(f"  {tag:<44} {v:g}")

    # ------------------------------------------------------------ latency
    if hists:
        out.append("-- latency histograms --")
        for name in sorted(hists):
            spec = hists[name]
            buckets = spec["buckets"]
            for lbl, counts in sorted(spec["series"].items()):
                total = sum(counts)
                if not total:
                    continue
                tag = f"{name}{{{lbl}}}" if lbl else name
                out.append(f"  {tag}  (n={total})")
                edges = [f"<={b:g}ms" for b in buckets] + ["+Inf"]
                for edge, c in zip(edges, counts):
                    if c:
                        out.append(f"    {edge:>10} {_bar(c / total)} {c}")

    # -------------------------------------------------------------- lanes
    occ = {int(_labels_dict(r["labels"]).get("lane", -1)): r["value"]
           for r in rows if r["metric"] == "lane_occupancy"}
    if occ:
        lanes = sorted(occ)
        vmax = max(occ.values()) or 1.0
        strip = "".join(_heat(occ[ln], vmax) for ln in lanes)
        out.append("-- lane occupancy --")
        out.append(f"  lanes {lanes[0]}..{lanes[-1]}: [{strip}]  "
                   f"({sum(1 for v in occ.values() if v > 0)} busy)")
    depth = {_labels_dict(r["labels"]).get("tenant", "?"): r["value"]
             for r in rows if r["metric"] == "backlog_depth"}
    if depth:
        vmax = max(depth.values()) or 1.0
        out.append("-- tenant backlog skew --")
        for tenant in sorted(depth, key=lambda t: -depth[t])[:16]:
            out.append(f"  {tenant:<24} {_bar(depth[tenant] / vmax, 20)} "
                       f"{depth[tenant]:g}")

    # ---------------------------------------------------------- skew / SLO
    gauges = {(r["metric"], r["labels"]): r["value"] for r in rows
              if r.get("type") == "gauge"}
    skew_keys = [
        ("skew_imbalance_factor", "imbalance (max/mean lane load)"),
        ("skew_lane_max_load", "hottest lane backlog (chunks)"),
        ("skew_lane_mean_load", "mean lane backlog (chunks)"),
        ("skew_score_spread", "Eq. 2 score spread"),
        ("skew_grant_churn_rate", "grant churn (reassign/obs)"),
        ("skew_slo_burn_rate", "SLO burn rate (window)"),
    ]
    if any((k, "") in gauges for k, _ in skew_keys) or status:
        out.append("-- skew / SLO --")
        if status and status.get("skew"):
            sk = status["skew"]
            out.append(f"  slo_ms={sk.get('slo_ms')} "
                       f"window={sk.get('window')} "
                       f"requests_in_window={sk.get('requests_in_window')}")
        for key, label in skew_keys:
            if (key, "") in gauges:
                v = gauges[(key, "")]
                warn = ""
                if key == "skew_imbalance_factor" and v > 2.0:
                    warn = "  <-- one hot lane is dragging the flush"
                if key == "skew_slo_burn_rate" and v > 0.1:
                    warn = "  <-- burning error budget"
                out.append(f"  {label:<32} {v:g}{warn}")
        viol = {_labels_dict(r["labels"]).get("tenant", "?"): r["value"]
                for r in rows if r["metric"] == "slo_violations_total"}
        reqs = {_labels_dict(r["labels"]).get("tenant", "?"): r["value"]
                for r in rows if r["metric"] == "slo_requests_total"}
        if viol:
            out.append("  slo violations by tenant:")
            for tenant in sorted(viol, key=lambda t: -viol[t])[:16]:
                n, d = viol[tenant], reqs.get(tenant, 0)
                pct = f" ({n / d * 100:.1f}%)" if d else ""
                out.append(f"    {tenant:<22} {n:g}/{d:g}{pct}")

    # ------------------------------------------------------ grant history
    if telemetry and telemetry.get("rows"):
        tail = telemetry["rows"][-12:]
        out.append("-- flush tail (grant history) --")
        out.append(f"  {'flush':>5} {'scope':<8} {'tuples':>8} "
                   f"{'sec':>4} {'resched':>7} {'retrace':>7} "
                   f"{'backlog':>8}")
        for r in tail:
            out.append(
                f"  {r.get('flush', '?'):>5} {r.get('scope', '?'):<8} "
                f"{r.get('tuples', 0):>8} {r.get('sec_granted', 0):>4} "
                f"{r.get('slot_reschedules', 0):>7} "
                f"{r.get('n_retraces', 0):>7} "
                f"{r.get('backlog_tuples', 0):>8}")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render an engine health report from an exported "
                    "observability snapshot or a live scrape endpoint "
                    "(see docs/observability.md).")
    ap.add_argument("snapshot", nargs="?", help="path to the snapshot "
                    "JSON (combined {metrics, telemetry} or a bare "
                    "metrics record)")
    ap.add_argument("--url", help="scrape a live service instead: base "
                    "URL of its obs.scrape sidecar, e.g. "
                    "http://127.0.0.1:9464 (reads /metrics + /statusz)")
    args = ap.parse_args(argv)
    if (args.snapshot is None) == (args.url is None):
        ap.error("exactly one of the snapshot path or --url is required")
    if args.url:
        print(render(fetch_url(args.url)))
        return 0
    with open(args.snapshot) as f:
        print(render(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
