"""Cells at sizes a CPU test run holds, for the tests of the harness."""
from __future__ import annotations

import json
import time
from pathlib import Path

from perfbench.harness import Cell

ROOT = Path(__file__).resolve().parents[2]


def load(kind: str, name: str) -> dict:
    with open(ROOT / "perfbench" / kind / f"{name}.json") as f:
        return json.load(f)


def histo_config() -> dict:
    return dict(load("configs", "ditto-histo"), dataset_tuples=3 * 256, chunk_size=256)


def stream_traffic(alphas=(0.0, 1.0, 2.0, 3.0)) -> dict:
    return dict(load("traffic", "zipf-sweep"), alphas=list(alphas), warm_chunks=1,
                trace_chunks=2, trace_seconds=0.3)


def cell(config: dict, traffic: dict, limits: dict, *, seed: int = 2**31 + 17,
         seconds: float = 0.3, trace: bool = False, name: str = "tiny") -> Cell:
    return Cell(name=name, config=config, traffic=traffic, limits=limits, seed=seed,
                seconds=seconds, trace=trace, device="cpu", chips=1,
                t0=time.perf_counter())
