#!/usr/bin/env python3
"""Smoke test of the PyTorch port of Ditto on one NVIDIA Hopper GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. build both hand-written CUDA kernels (route_accumulate, cms_update)
     from src/repro_torch/kernels/csrc/ with nvcc for sm_90a, in parallel;
  2. hold each kernel against its plain PyTorch version on the same CUDA
     tensors, at the main path's shape and (route_accumulate) at a buffer
     of 2^20 bins: add/max x int32/float32, -1 padding, the
     masked sentinel eff = num_pe, negative values under max;
  3. drive the main path -- Ditto(spec, device="cuda") -> build (Eq. 2 on a
     0.1% sample) -> run -- over the paper's 26 * 2^20 8-byte Zipf tuples in
     chunks of 4096 with M = 16 PriPEs: HISTO at alpha 0 and 3, HLL at
     alpha 3 (a ragged stream, +1000 tuples through chunk_masked) and HHD at
     alpha 3.  Merged buffers must equal the app's numpy oracle bit for
     bit, and each kernel's launch count must grow by one per chunk;
  4. run the first 256 chunks of the alpha-3 HISTO stream on the card and on
     the CPU: identical merged buffers and every ExecStats field identical;
  5. time each kernel, its plain version and one library call at the main
     path's shape (CUDA events for the call, torch.profiler for the card's
     time of the kernel alone), beside its bound from the bytes and
     operations this chunk's data needs;
  6. profile 64 chunks of every configuration (torch.profiler): the card's
     time and the host's aten ops per chunk against the wall time per
     chunk; time the app's PrePE and the greedy scheduler alone.
Prints the throughput of each configuration, the card's name and power
limit, a {"kernels": [...]} line, and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N_TUPLES = 26 * 2**20          # the paper's 26 M tuples
CHUNK = 4096
RAGGED_EXTRA = 1000
PARITY_CHUNKS = 256
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
SEED = 3


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, calls: int = 200) -> float:
    """Mean card time of one launch of the kernel whose name holds
    ``kernel``, from torch.profiler's kernel rows over ``calls`` calls.

    The profiler's activity trace can miss a launch at the edge of its
    window (199 of 200 were seen on an H100), so the mean is taken over the
    launches it recorded; most of them must be there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    launched = sum(e.count for e in rows)
    assert calls // 2 <= launched <= calls, \
        f"profiler saw {launched} launches of {kernel} in {calls} calls"
    return 1e-3 * sum(e.self_device_time_total for e in rows) / launched


def host_ms(fn, calls: int = 64) -> float:
    """Wall time of one call of ``fn`` over ``calls`` calls and one sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time of a kernel: the larger of its bytes over the HBM rate
    and its operations over the float32 CUDA-core rate (the data sheet lists
    no int32 rate; int32 adds issue at the same rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernels(route_accumulate, cms_update, ref, dev) -> dict:
    """Phase 2: each kernel against its plain version on the same tensors.
    Integer results and float max must be bit-exact; float add may differ
    by the order of atomic adds: rtol = atol = 1e-5."""
    rng = np.random.default_rng(SEED)
    err = {"route_accumulate": 0.0, "cms_update": 0.0}

    def values(n, dtype, signed=True):
        if dtype == torch.int32:
            return torch.from_numpy(rng.integers(-100 if signed else 0, 100, n)
                                    .astype(np.int32)).to(dev)
        v = rng.standard_normal(n) if signed else rng.random(n)
        return torch.from_numpy(v.astype(np.float32)).to(dev)

    def compare(name, got, want, exact):
        torch.cuda.synchronize()
        diff = float((got.double() - want.double()).abs().max())
        err[name] = max(err[name], diff)
        if exact:
            assert torch.equal(got, want), f"{name}: max |err| {diff}"
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    t = CHUNK
    # (31, 256): HLL's 16 PriPEs + 15 SecPEs x 256 registers; (1, 2^20):
    # HISTO-style bins, far more than L1 holds
    for num_pe, local in ((31, 256), (1, 1 << 20)):
        for combine in ("add", "max"):
            for dtype in (torch.int32, torch.float32):
                buffers = values(num_pe * local, dtype).view(num_pe, local)
                eff = torch.from_numpy(rng.integers(-1, num_pe + 1, t).astype(np.int32)).to(dev)
                idx = torch.from_numpy(rng.integers(-1, local + 1, t).astype(np.int32)).to(dev)
                val = values(t, dtype)
                want = ref.pe_buffer_update(buffers.clone(), eff, idx, val, combine)
                got = route_accumulate(buffers.clone(), eff, idx, val, combine)
                compare("route_accumulate", got, want,
                        exact=dtype == torch.int32 or combine == "max")
    num_pe, depth, width = 31, 4, 1024           # HHD: 16 + 15 PEs, 4 x 1024
    for dtype in (torch.int32, torch.float32):
        sketch = values(num_pe * depth * width, dtype, signed=False).view(num_pe, depth, width)
        eff = torch.from_numpy(rng.integers(-1, num_pe + 1, t).astype(np.int32)).to(dev)
        cols = torch.from_numpy(rng.integers(0, width, (t, depth)).astype(np.int32)).to(dev)
        val = values(t, dtype, signed=False)
        want = ref.cms_update(sketch.clone(), eff, cols, val)
        got = cms_update(sketch.clone(), eff, cols, val)
        compare("cms_update", got, want, exact=dtype == torch.int32)
    return err


def profile_chunks(cfg, spec, tuples, num_sec, dev, warm: int = 16,
                   window: int = 64) -> dict:
    """The card's kernel time per chunk (torch.profiler, kernel rows only)
    against the wall time per chunk under the profiler, and the aten ops the
    host issues per chunk (nested ops included), over ``window`` chunks
    after ``warm`` chunks.  The profiler adds host time, so the busy share
    it gives is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import make_resumable_executor
    res = make_resumable_executor(spec, 16, num_sec, CHUNK, device=dev)
    chunks = torch.as_tensor(tuples[:(warm + window) * CHUNK], device=dev).view(-1, CHUNK, 2)
    state, _ = res.run_chunks(res.init_state(), chunks[:warm])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res.run_chunks(state, chunks[warm:])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    host_ops = sum(e.count for e in events if e.device_type == DeviceType.CPU
                   and e.key.startswith("aten::"))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"config": cfg, "chunks": window, "num_sec": num_sec,
            "host_aten_ops_per_chunk": host_ops / window,
            "device_us_per_chunk": device_us / window,
            "wall_ms_per_chunk_profiled": 1e3 * wall_s / window,
            "busy_share_profiled": device_us * 1e-6 / wall_s,
            "kernels_per_chunk": sum(e.count for e in kernels) / window,
            "top_kernels_us_per_chunk": {e.key[:80]: e.self_device_time_total / window
                                         for e in top}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from a checkout of "
              "the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.apps import hhd, histo, hll
    from repro_torch.core import Ditto, mapper
    from repro_torch.core.executor import make_static_plan
    from repro_torch.core.profiler import workload_hist
    from repro_torch.core.scheduler import schedule_secpes
    from repro_torch.core.types import ExecStats
    from repro_torch.data.zipf import zipf_tuples
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cms_update import cms_update
    from repro_torch.kernels.route_accumulate import route_accumulate

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # ---- 1. build
    t0 = time.perf_counter()
    logs = _build.build("route_accumulate", "cms_update")
    build_s = time.perf_counter() - t0
    for kernel, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"build {kernel}: {usage}")
    print(f"build_s {build_s:.3f}")

    # ---- 2. kernels against their plain versions
    max_err = check_kernels(route_accumulate, cms_update, ref, dev)
    print("kernel_check", json.dumps(max_err))

    # ---- 3. the main path at the paper's stream size
    t0 = time.perf_counter()
    stream_0 = zipf_tuples(N_TUPLES, 1 << 20, 0.0, seed=SEED)
    stream_3 = zipf_tuples(N_TUPLES, 1 << 20, 3.0, seed=SEED)
    stream_hll = zipf_tuples(N_TUPLES + RAGGED_EXTRA, 1 << 22, 3.0, seed=SEED)
    print(f"data_s {time.perf_counter() - t0:.3f}")
    configs = [
        # name, spec, stream, oracle, kernel the PE update launches, ragged
        ("histo_a0", histo.make_spec(512, 1 << 20, 16), stream_0,
         lambda k: histo.oracle(k, 512, 1 << 20, 16), route_accumulate, False),
        ("histo_a3", histo.make_spec(512, 1 << 20, 16), stream_3,
         lambda k: histo.oracle(k, 512, 1 << 20, 16), route_accumulate, False),
        ("hll_a3_ragged", hll.make_spec(12, 16), stream_hll,
         lambda k: hll.oracle(k, 12, 16), route_accumulate, True),
        ("hhd_a3", hhd.make_spec(4, 1024, 16), stream_3,
         lambda k: hhd.oracle(k, 4, 1024, 16), cms_update, False),
    ]
    launches = {"route_accumulate": 0, "cms_update": 0}
    results, picked = [], {}
    for cfg, spec, tuples, oracle, kernel, ragged in configs:
        d = Ditto(spec, chunk_size=CHUNK, device=dev)
        assert d.num_pri == 16
        impl = d.build(tuples[:, 0])
        picked[cfg] = impl.num_sec
        if ragged:
            chunks, mask = d.chunk_masked(tuples)
        else:
            chunks, mask = d.chunk(tuples), None
        n_chunks = chunks.shape[0]
        torch.cuda.synchronize()
        route_accumulate.launches = 0
        cms_update.launches = 0
        t0 = time.perf_counter()
        merged, stats = impl.run(chunks, mask=mask)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {"route_accumulate": route_accumulate.launches,
                  "cms_update": cms_update.launches}
        for k, c in counts.items():
            launches[k] += c
            want = n_chunks if k == kernel.__name__ else 0
            assert c == want, f"{cfg}: {k} launched {c} times, expected {want}"
        want = oracle(tuples[:, 0])
        got = merged.cpu().numpy()
        assert got.shape == want.shape and np.array_equal(got, want), \
            f"{cfg}: merged buffers differ from the numpy oracle"
        cycles = float(stats.modeled_cycles.double().sum())
        rec = {"config": cfg, "tuples": len(tuples), "chunks": n_chunks,
               "num_pri": d.num_pri, "num_sec": impl.num_sec,
               "run_s": run_s, "tuples_per_s": len(tuples) / run_s,
               "ms_per_chunk": 1e3 * run_s / n_chunks,
               "modeled_tuples_per_cycle": len(tuples) / cycles,
               "reschedules": int(stats.rescheduled.sum()),
               "launches": counts, "oracle_exact": True}
        results.append(rec)
        print("e2e", json.dumps(rec))
        del chunks, mask, merged, stats
    torch.cuda.empty_cache()

    # ---- 4. card against CPU on the first chunks of the alpha-3 HISTO run
    spec = histo.make_spec(512, 1 << 20, 16)
    x = picked["histo_a3"]
    head = stream_3[:PARITY_CHUNKS * CHUNK]
    outs = []
    for where in (dev, torch.device("cpu")):
        d = Ditto(spec, chunk_size=CHUNK, device=where)
        merged, stats = d.generate([x])[0].run(d.chunk(head))
        outs.append((merged.cpu(), {f: getattr(stats, f).cpu()
                                    for f in ExecStats.__dataclass_fields__}))
    (m_gpu, s_gpu), (m_cpu, s_cpu) = outs
    assert torch.equal(m_gpu, m_cpu), "card and CPU merged buffers differ"
    for f in s_gpu:
        assert s_gpu[f].dtype == s_cpu[f].dtype and torch.equal(s_gpu[f], s_cpu[f]), \
            f"card and CPU differ in ExecStats.{f}"
    print(f"cpu_parity ok: {PARITY_CHUNKS} chunks, X={x}, merged and every "
          "ExecStats field identical")

    # ---- 5. kernel times at the main path's shapes
    def main_path_inputs(spec, tuples, num_sec):
        """eff, idx, value of one chunk as the executor routes it under
        the plan its first chunk's profile gives."""
        chunk = torch.as_tensor(tuples[:CHUNK], device=dev)
        dst, idx, value = spec.pre(chunk, 16)
        plan = make_static_plan(16, num_sec, workload_hist(dst, 16), device=dev)
        rank, _ = mapper.occurrence_rank(dst, 16, torch.zeros(16, dtype=torch.int32, device=dev))
        return mapper.redirect(plan, dst, rank), idx.contiguous(), value

    def route_bound(buf, eff, idx):
        """Bytes: 12 per tuple, plus a read and a write of each cell this
        chunk's valid tuples touch.  Operations: one fold per valid tuple."""
        num_pe, local = buf.shape
        ok = (eff >= 0) & (eff < num_pe) & (idx >= 0) & (idx < local)
        cells = torch.unique((eff.long() * local + idx.long())[ok]).numel()
        return bound_ms(CHUNK * 12 + 2 * 4 * cells, int(ok.sum()))

    kernels = []
    hspec = hll.make_spec(12, 16)
    eff, idx, val = main_path_inputs(hspec, stream_hll, picked["hll_a3_ragged"])
    num_pe = 16 + picked["hll_a3_ragged"]
    buf = hspec.init_buffer(num_pe, dev)
    local = buf.shape[1]
    flat = (eff.long() * local + idx.long())
    lib_buf = buf.clone().view(-1)
    fn = lambda: route_accumulate(buf, eff, idx, val, "max")
    ms = cuda_ms(fn)
    dev_ms = device_ms(fn, "route_accumulate_")
    plain_ms = cuda_ms(lambda: ref.pe_buffer_update(buf, eff, idx, val, "max"))
    lib_ms = cuda_ms(lambda: lib_buf.scatter_reduce_(0, flat, val, "amax"))
    b_ms, b_by = route_bound(buf, eff, idx)
    kernels.append({
        "name": "route_accumulate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/route_accumulate.cu",
        "replaces": "src/repro/kernels/route_accumulate.py:58",
        "launches": launches["route_accumulate"],
        "max_abs_err": max_err["route_accumulate"],
        "ms": ms, "kernel_ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "shape": f"HLL alpha=3 chunk: T={CHUNK} max int32 into [{num_pe}, {local}]",
        "library_call": "scatter_reduce_(amax) on precomputed flat indices"})

    cspec = hhd.make_spec(4, 1024, 16)
    eff, cols, val = main_path_inputs(cspec, stream_3, picked["hhd_a3"])
    num_pe = 16 + picked["hhd_a3"]
    sketch = cspec.init_buffer(num_pe, dev)
    rows = torch.arange(4, device=dev)
    flat = ((eff.long()[:, None] * 4 + rows) * 1024 + cols.long()).reshape(-1)
    vals = val[:, None].expand(-1, 4).reshape(-1).contiguous()
    lib_sketch = sketch.clone().view(-1)
    fn = lambda: cms_update(sketch, eff, cols, val)
    ms = cuda_ms(fn)
    dev_ms = device_ms(fn, "cms_update_kernel")
    plain_ms = cuda_ms(lambda: ref.cms_update(sketch, eff, cols, val))
    lib_ms = cuda_ms(lambda: lib_sketch.index_add_(0, flat, vals))
    # bytes: eff, 4 columns and the value of each tuple, plus a read and a
    # write of each cell the valid tuples touch; one add per touched row
    ok = (eff >= 0) & (eff < num_pe)
    cells = torch.unique(flat.view(CHUNK, 4)[ok]).numel()
    b_ms, b_by = bound_ms(CHUNK * (4 + 4 * 4 + 4) + 2 * 4 * cells, 4 * int(ok.sum()))
    kernels.append({
        "name": "cms_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cms_update.cu",
        "replaces": "src/repro/kernels/cms_update.py:54",
        "launches": launches["cms_update"],
        "max_abs_err": max_err["cms_update"],
        "ms": ms, "kernel_ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "shape": f"HHD alpha=3 chunk: T={CHUNK} int32 into [{num_pe}, 4, 1024]",
        "library_call": "index_add_ on precomputed flat indices"})

    # ---- 6. where the time of a chunk goes: card time and host ops per
    # chunk from torch.profiler over a steady window of every configuration,
    # then the host time of the two per-chunk steps whose cost differs
    # between configurations (the app's PrePE and the greedy scheduler)
    for cfg, spec, tuples, *_ in configs:
        print("profile", json.dumps(profile_chunks(cfg, spec, tuples, picked[cfg], dev)))
    chunk = torch.as_tensor(stream_3[:CHUNK], device=dev)
    host = {f"pre_{app}": host_ms(lambda: spec.pre(chunk, 16))
            for app, spec in (("histo", histo.make_spec(512, 1 << 20, 16)),
                              ("hll", hll.make_spec(12, 16)),
                              ("hhd", hhd.make_spec(4, 1024, 16)))}
    hist = workload_hist(histo.make_spec(512, 1 << 20, 16).pre(chunk, 16)[0], 16)
    for x in sorted(set(picked.values())):
        host[f"schedule_secpes_x{x}"] = host_ms(lambda: schedule_secpes(hist, x))
    print("host_ms", json.dumps(host))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    assert smi.returncode == 0, smi.stderr
    print(f"total_s {time.perf_counter() - t_start:.3f}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
