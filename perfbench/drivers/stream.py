"""Tuple streams through the port's ``StreamEngine``, one lane a stream.

Traffic parameters (``traffic/<name>.json``):
  * ``alphas``: one Zipf exponent a stream (their number is the lanes');
  * ``warm_chunks``: chunks of each stream in set-up's warm flush;
  * ``trace_chunks``: a traced run serves each stream's first this many
    chunks a flush, so that its window holds several whole flushes;
  * ``trace_seconds``: the length of a traced run's window.

The configuration gives the application, the engine's shape and
``dataset_tuples``, the length of every stream.  The streams are drawn on
the device from the seed in set-up.  The loop is closed: every stream is
submitted again as soon as its result returns, so each flush is one batch
of all streams as lanes.  A flush that its predecessor's length says
cannot end inside the window is not started.  ``tuples_per_s`` counts the
tuples of every result returned in the window, over the time from the
window's start to the last such result.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from perfbench import zipf
from perfbench.harness import Check, Outcome, log_setup, log_times
from perfbench.reference import histo as ref
from perfbench.trace import Window


def make_streams(cell) -> list:
    """One int32 [dataset_tuples, 2] stream an alpha, made on the cell's
    device from the seed and handed over as NumPy."""
    cfg = cell.config
    out = []
    for t, alpha in enumerate(cell.traffic["alphas"]):
        data = zipf.zipf_tuples(cfg["dataset_tuples"], cfg["key_domain"], alpha,
                                zipf.derive(cell.seed, t), cell.device)
        out.append(data.cpu().numpy())
        del data
    return out


def flat_histogram(merged: np.ndarray, num_bins: int) -> np.ndarray:
    """The program's partitioned buffers [M, bins / M] -> [num_bins]: bin b
    lives in PriPE b % M at local index b // M."""
    m = merged.shape[0]
    b = np.arange(num_bins)
    return merged[b % m, b // m]


def run(cell, engine_factory=None) -> Outcome:
    import torch
    from torch.profiler import record_function

    from repro_torch import obs as obs_lib
    from repro_torch.apps import histo
    from repro_torch.serve.engine import StreamEngine

    cfg, tr = cell.config, cell.traffic
    if cfg["app"] != "histo":
        raise ValueError(f"the stream driver runs histo, not {cfg['app']}")
    bins, domain, chunk = cfg["num_bins"], cfg["key_domain"], cfg["chunk_size"]
    lanes = len(tr["alphas"])
    on_card = cell.device.startswith("cuda")
    t_start = time.perf_counter()
    full = make_streams(cell)
    streams = [s[:tr["trace_chunks"] * chunk] for s in full] if cell.trace else full
    t_made = time.perf_counter()
    obs = obs_lib.Observability()
    spec = histo.make_spec(bins, domain, cfg["num_pri"])
    make = engine_factory or StreamEngine
    engine = make(spec, num_pri=cfg["num_pri"], num_sec=cfg["num_sec"],
                  chunk_size=chunk, max_streams=lanes, device=cell.device, obs=obs)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # set-up: one flush of every stream's first chunks warms the step's shape
    t_engine = time.perf_counter()
    for s in streams:
        engine.submit(s[:tr["warm_chunks"] * chunk])
    engine.flush()
    sync()
    setup_s = time.perf_counter() - cell.t0
    log_setup(cell, import_s=t_start - cell.t0, streams_s=t_made - t_start,
              engine_s=t_engine - t_made, warm_flush_s=time.perf_counter() - t_engine)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    seconds = min(cell.seconds, tr["trace_seconds"]) if cell.trace else cell.seconds
    owner = {}                      # rid -> stream

    def submit(t):
        with record_function("stream.submit"):
            owner[engine.submit(streams[t])] = t

    for t in range(lanes):
        submit(t)
    results = []                    # (stream, merged)
    counted, flushes, last_done = 0, 0, None
    durations = []
    window = Window() if cell.trace else contextlib.nullcontext()
    with window:
        start = time.perf_counter()
        while True:
            t = time.perf_counter()
            if t - start >= seconds or (durations and t - start + durations[-1] > seconds):
                break
            with record_function("stream.flush"):
                out = engine.flush()
            done = time.perf_counter()
            durations.append(done - t)
            flushes += 1
            for rid, (merged, _stats) in out.items():
                s = owner.pop(rid)
                results.append((s, merged))
                if done - start <= seconds:
                    counted += len(streams[s])
                    last_done = done
                submit(s)
    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
    log_times(cell, "flushes", durations)
    batches = obs.registry.counter("stream_batches_total", "").value()
    if batches != flushes + 1:
        raise RuntimeError(f"{batches} batches in {flushes + 1} flushes: "
                           "the streams did not share one batch a flush")

    # correctness: every result against the reference of its stream
    want = {}
    wrong_bins, wrong_results = 0, 0
    for s, merged in results:
        if s not in want:
            want[s] = ref.histogram(streams[s][:, 0], bins, domain)
        w = ref.bins_wrong(flat_histogram(np.asarray(merged), bins), want[s])
        wrong_bins += w
        wrong_results += bool(w)
    checks = [Check("bins_wrong", wrong_bins, cell.limits["bins_wrong"]),
              Check("results_missing", lanes * flushes - len(results),
                    cell.limits["results_missing"])]
    metrics = {"setup_s": setup_s,
               "tuples_per_s": counted / (last_done - start) if last_done else 0.0}
    trace = None
    if cell.trace:
        trace = window.trace
        cells = [ref.cells_touched(s[:, 0], bins, domain, chunk) for s in streams]
        trace.work = {"chunk_steps": flushes * -(-len(streams[0]) // chunk),
                      "tuples": flushes * sum(len(s) for s in streams),
                      "cells": flushes * sum(cells),
                      "tuple_bytes": cfg["tuple_bytes"]}
    return Outcome(metrics=metrics, attempted=len(results), failed=wrong_results,
                   checks=checks, memory_peak_bytes=mem_peak, trace=trace)
