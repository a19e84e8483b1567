"""One run of one cell: find its files by name, check the device, run the
traffic's driver, read the per-layer metrics of a traced run, hold the
process to its import rules, and print the result line.

The driver of a traffic mix (``drivers/<name>.py``) has one entry,
``run(cell) -> Outcome``: it makes its inputs from ``cell.seed``, warms up
(set-up), measures for ``cell.seconds``, and compares what the timed path
produced with the plain reference once the window has closed.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    t0: float                      # perf_counter at the process's start


@dataclasses.dataclass
class Check:
    """One number compared: the run is correct only if value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    metrics: dict                  # end-to-end metric name -> value
    attempted: int
    failed: int
    checks: list                   # [Check]
    memory_peak_bytes: int
    trace: Optional[object] = None  # trace.Trace of a traced run

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


def log_setup(cell: Cell, **phases: float) -> None:
    """One line on standard error: how the set-up's seconds split."""
    parts = " ".join(f"{k} {v:.3f}" for k, v in phases.items())
    print(f"perfbench: {cell.name} seed {cell.seed} set-up: {parts}", file=sys.stderr,
          flush=True)


def log_times(cell: Cell, what: str, seconds: list) -> None:
    """One line on standard error: the spread of the window's flushes or
    steps, which says whether a slow run is slow throughout or in bursts."""
    if len(seconds) < 2:
        return
    import statistics
    q = statistics.quantiles(seconds, n=4)
    print(f"perfbench: {cell.name} seed {cell.seed} {len(seconds)} {what}: min "
          f"{min(seconds):.4f} q1 {q[0]:.4f} median {q[1]:.4f} q3 {q[2]:.4f} max "
          f"{max(seconds):.4f} s; in order, ms: "
          + " ".join(f"{1e3 * x:.0f}" for x in seconds[:60]), file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(root: Path, workload: str) -> dict:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its entry, its
    configuration's entry and the contents of its files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    pb = root / "perfbench"
    return {"bench": bench, "entry": entry, "config_entry": cfg_entry,
            "config": load_json(root / cfg_entry["file"]),
            "traffic": load_json(pb / "traffic" / f"{entry['traffic']}.json"),
            "limits": load_json(pb / "limits" / f"{workload}.json")}


def end_to_end_of(bench: dict, workload: str) -> list:
    """The end-to-end metric entries the cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_of(bench: dict, workload: str) -> list:
    """The per-layer metric entries a traced run of the cell reads: those
    that list it, and those without a list that move one of its
    end-to-end metrics."""
    moved = {m["name"] for m in end_to_end_of(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def driver(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def reader(root: Path, metric: str) -> Callable:
    """``read(trace) -> value | None`` of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(names=None) -> list:
    """The top-level names among ``names`` (the loaded modules by default)
    that are one of FORBIDDEN, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names if n.split(".")[0] in FORBIDDEN})


def device_record(outcome: Outcome, kind: str, chips: int) -> dict:
    rec = {"platform": "gpu", "kind": kind, "count": chips,
           "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if outcome.trace is not None:
        rec["busy_s"] = outcome.trace.busy_s()
        rec["window_s"] = outcome.trace.window_s
    return rec


def result(root: Path, bench: dict, workload: str, outcome: Outcome, kind: str,
           chips: int) -> dict:
    """The result line's object (``checks`` last)."""
    if outcome.trace is None:
        metrics = {}
        for m in end_to_end_of(bench, workload):
            if m["name"] not in outcome.metrics:
                raise RuntimeError(f"the driver reported no {m['name']}")
            metrics[m["name"]] = {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
    else:
        metrics = {}
        for m in per_layer_of(bench, workload):
            value = reader(root, m["name"])(outcome.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics,
           "device": device_record(outcome, kind, chips)}
    if outcome.trace is not None:
        out["breakdown"] = {"device_ops": outcome.trace.top_device_ops(10),
                            "idle_gaps": outcome.trace.idle_gaps(10)}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return out


def main(args, t0: float) -> int:
    import torch

    import repro_torch  # noqa: F401  the program under test: no program, no run
    found = resolve(ROOT, args.workload)
    entry = found["entry"]
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one process with few threads: the host-paced chunk steps share the
    # machine's cores with nothing of the benchmark's own
    torch.set_num_threads(4)
    cell = Cell(name=args.workload, config=found["config"], traffic=found["traffic"],
                limits=found["limits"], seed=args.seed, seconds=float(args.seconds),
                trace=bool(args.trace), device="cuda", chips=chips, t0=t0)
    outcome = driver(found["traffic"]).run(cell)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the process loaded {bad}, which the benchmark may not",
              file=sys.stderr)
        return 3
    line = result(ROOT, found["bench"], args.workload, outcome,
                  torch.cuda.get_device_name(0), chips)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
