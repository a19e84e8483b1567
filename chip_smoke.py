#!/usr/bin/env python3
"""Smoke test of the PyTorch port of Ditto on one NVIDIA Hopper GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. build every hand-written CUDA kernel (route_accumulate, cms_update,
     moe_onehot, flash_attention) from src/repro_torch/kernels/csrc/ with
     nvcc for sm_90a, one process a source, in parallel;
  2. hold each kernel against its plain PyTorch version on the same CUDA
     tensors, at the main path's shape and (route_accumulate) at a buffer
     of 2^20 bins: add/max x int32/float32, -1 padding, the
     masked sentinel eff = num_pe, negative values under max; and
     cms_update on a chunk whose tuples all carry one key (every tuple adds
     to the same 4 cells);
  3. drive the main path -- Ditto(spec, device="cuda") -> build (Eq. 2 on a
     0.1% sample) -> run -- over the paper's 26 * 2^20 8-byte Zipf tuples in
     chunks of 4096 with M = 16 PriPEs: HISTO at alpha 0 and 3, HLL at
     alpha 3 (a ragged stream, +1000 tuples through chunk_masked) and HHD at
     alpha 3.  Merged buffers must equal the app's numpy oracle bit for
     bit, and each kernel's launch count must grow by one per chunk;
  4. run the first 256 chunks of the alpha-3 HISTO stream on the card and on
     the CPU: identical merged buffers and every ExecStats field identical;
  5. time each kernel, its plain version and one library call at the main
     path's shape (CUDA events for the call, the kernel and the library call
     in turns; torch.profiler for the card's time of the kernel alone),
     beside its bound from the bytes and operations this chunk's data
     needs; cms_update's card time also at an alpha-0 chunk, and the host
     time of each piece of both PE updates' calls (the route_accumulate_host
     and cms_update_host lines);
  6. profile 64 chunks of every configuration (torch.profiler): the card's
     time and the host's aten ops per chunk against the wall time per
     chunk; time the app's PrePE and the greedy scheduler alone.
  7. PageRank (Fig. 8's R-MAT graph of degree 32, undirected, V = 2^14:
     2^20 edges, 256 chunks): 10 iterations of edge_contributions on the
     card, run with Ditto's X and apply_damping; every iteration's sums and
     the final ranks bit-exact against the fixed-point oracle, within 1e-3
     of the float reference, route_accumulate launched once per chunk;
     X = 0 on the first iteration's tuples (Fig. 8's modeled speedup); and
     its card time per chunk as in phase 6;
  8. DP (radix 8 bits, 256 partitions, 16 a PriPE, 2^22 slots a PE, ~1.5 GB
     of state) over the alpha-3 stream of phase 3 with Ditto's X: no cursor
     at the capacity, partitions equal to the oracle as multisets, the
     first 256 chunks identical on card and CPU slot for slot, no PE kernel
     launched; then its card time per chunk as in phase 6;
  9. the replicated static-dispatch baseline (16 full replicas) over the
     first 26 * 2^20 tuples of the alpha-3 HISTO, HLL and HHD streams: the
     aggregate equal to the flat oracle, the PE kernel once per chunk, and
     Table II's modeled ratios against phase 3's routed runs;
 10. Ditto.tune on the card for HISTO on a 2^22-tuple alpha-1.5 stream:
     the model pass's X equal to the CPU's, the measured pass over chunks
     of 2048, 4096 and 8192, and the tuned plan through make_executor
     bit-exact against the oracle;
 11. StreamEngine at serving size (M = 16, X = 14, chunks of 4096, 8 lanes,
     every engine on the default obs bundle): HISTO with an online batch of
     8 tenants at Zipf alpha 0-3, 2^20 - r_i tuples each (seven ragged
     tails; 256 batched chunks, ~8 M tuples in one flush) and a planned
     batch of 5 tenants under per-tenant static plans (3 pad lanes); HHD, 8
     tenants at alpha 3 (cms_update over lanes); HLL, 4 ragged tenants (4
     pad lanes); 2^20 tuples a tenant outside the online batch.  Every tenant equal to its oracle and, merged and every
     ExecStats field, to its stream alone through make_executor; 64 chunks
     of the online batch identical on card and CPU; pad lanes left as
     init_state made them; each PE kernel once per batched chunk; the
     Prometheus text through parse_prometheus and the trace's
     executor.build / stream.flush / stream.batch spans.  Prints flush
     seconds and tuples/s per engine, ms per batched chunk at L = 1, 2, 4
     and 8 lanes, a profile of 16 batched chunks at L = 8, the flattened PE
     launch against L per-lane launches (in turns), and the build monitor's
     delta over the phase.
 12. SessionEngine at the paper's scale and shape (M = 16, X = 14, chunks
     of 4096) on the default obs bundle, through a seeded op script of
     ragged appends (0-4 chunks plus a tail), queries in both scopes,
     engine and per-session flushes and closes: (a) HISTO (512 bins, domain
     2^20), 8 primary + 8 secondary slots, aot_buckets=8: 24 tenants at
     Zipf alpha 0-3 and ~2^23 tuples (~64 MB), 8 of them one open_batch
     storm, 16 by open, 8 of which queue; every answer bit-exact against
     the oracle, the slot table and queue against FIFO admission, no build
     event after warmup(), route_accumulate once per batched chunk step,
     and the first 64 batched chunks of the same ops identical on a CPU
     engine (answers, slot tables, integer telemetry); (b) the same ops on a
     DurableSessionEngine (checkpoint_every=4, keep=3), dropped without
     shutdown two thirds through and recovered on the card: a checkpoint
     restored, fewer records replayed than logged, backlogs and slot table
     and every answer as in (a), then the rest with (a)'s checks; (c) HHD, 8
     tenants at alpha 3 with secondary grants (cms_update over
     [16 * 30, 4, 1024]); (d) DP under lanes, 4 tenants of 2^21 tuples at
     alpha 0-3 with 2^19 slots a PE (~0.75 GB of lane state): partitions
     equal to the oracle as multisets, no cursor at the capacity, no PE
     kernel launched.  Prints the session, durability and session_dp lines
     (tuples/s of engine-wide flushes, query p50/p99 by scope, grants,
     re-schedules, batched chunks, busy lanes, a blocking checkpoint's ms,
     WAL bytes and MB/s, recovery seconds and replayed tuples, the build
     monitor's delta).
 13. SessionService, the TCP front door, in front of a DurableSessionEngine
     on the card (phase 12's HISTO shape and slots, checkpoint_every=4,
     keep=3, warmup() before start()), scored admission, a per-tenant rate
     limit and the scrape sidecar: 32 tenants at Zipf alpha 0-3, ~2^24
     tuples (~128 MB) over loopback in ragged appends of up to 2^19 tuples
     (4 MB frames), from 8 threads with a ServiceClient each and one
     AsyncServiceClient pipelining its 8 tenants' appends; rate-limited
     requests sleep their RETRY-AFTER and retry; more opens than the 8
     primary slots, so opens park.  Two thirds through, the clients pause,
     the service stops (a parked open gets ERR_BACKPRESSURE) and the engine
     is dropped without shutdown; recover() on the card, warmup(), a new
     service, and the clients reconnect and finish.  Every query and close
     bit-exact against the oracle of the tuples acknowledged by then; every
     acknowledged append in the recovered engine; no slot held twice;
     held opens drain to 0; the client-side (op, status) counts equal
     service_requests_total from /metrics; /healthz and /statusz; a traced
     request's echo and root span; no build event after either warmup();
     route_accumulate once per batched chunk step; and ~200 single-client
     requests with identical responses from a service over a CPU engine and
     one over a CUDA engine.  Prints the service line (requests/s and
     client p50/p99 by op, appended and flushed tuples/s, the mean
     coalesced batch, the worker's busy share, rate-limited and
     backpressured requests, recovery seconds and replayed tuples, the
     build monitor's delta).
 14. Multi-device Ditto on logical shards of the one card
     (core.distributed.make_mesh: P shards on one device; this measures
     the code path and the exchange, not multi-card scaling): (a)
     run_stream with one PE a shard, 6 + 2 shards at the widths of
     examples/distributed_ditto.py (384 bins over 2^20 keys, chunks of
     6144, capacity 256): its 16-chunk streams at alpha 0 and 2, X = 0 and
     2, with its claim (alpha 2: X = 0 drops over 1000 tuples after the
     plan, X = 2 none at a lower max receive load; alpha 0 oracle-exact),
     HLL (max) at alpha 2, X = 2 oracle-exact, each chunk identical on the
     card and a CPU mesh, then a 2^22-tuple alpha-2 stream at X = 2, timed;
     route_accumulate once a shard a chunk; (b) route_all_to_all on 8 card
     shards against its numpy oracle; (c) SessionEngine(mesh=4 shards) at
     phase 12a's shape and a local engine through one op script of ~2^21
     tuples: answers equal to the oracle and to each other, slot tables,
     folds and integer telemetry equal, folds across shards, no build
     event after warmup(), the PE kernel once a shard an engine-wide step
     and once a per-session step; HHD sessions on the mesh (cms_update
     likewise); (d) a durable meshed engine crashed two thirds through,
     recovered onto the mesh and onto mesh=None, both equal to (c)'s run.
     Prints the mesh_pe and mesh_session lines.
Then the MoE language model (moonshot-v1-16b-a3b at full width):
  A. hold onehot_dispatch, onehot_combine and flash_attention against their
     plain versions on CUDA tensors at the prefill and decode shapes:
     float32 and bfloat16, dropped tuples (eff = -1, eff = P, slot >= C),
     duplicate cells, gate given or None; flash at S = 1024 and 1000, H = KV
     and GQA (KV = 4), causal with and without a window of 256, and at dh 64
     and 256, S = 1 and q scaled by 8 (bf16 on the tensor cores, float32 on
     the CUDA cores);
  B. drive the LM path with 8 of its 48 layers and seeded random weights:
     prefill_fn on [4, 1024] tokens (finite logits; each kernel launches
     once per layer); a smoke of the serve CLI's DecodeEngine run (8
     requests, prompts of 4-16 tokens, 16 new tokens, 4 slots, max_len 128:
     every request returns 16 tokens); then decode at serving load, a
     DecodeEngine with 64 busy slots whose contexts of 1024-3967 tokens are
     already cached, timed over 32 steps.  Dispatch and combine launch once
     per layer per decode_fn call; prefill and a serving-load step are
     profiled;
  C. the card against the CPU at full width with 2 layers in float32 (TF32
     off): prefill logits within 1e-3 and identical greedy tokens of a
     2-request DecodeEngine, on the same weights;
  D. time each new kernel, its plain version and one library call on the
     first layer's inputs of a prefill run, beside its bound; flash also on
     float32 copies of those inputs (the CUDA-core kernel), and dispatch also
     on the first layer's inputs of a decode step at 64 slots.
Then the other configs, one model on the card at a time:
  E. (a) the soft-capped flash kernel against its plain version, bf16 and
     float32, one launch each: gemma2's [4, 1024] shape (H 8 / KV 4, dh 256,
     cap 50), one sequence of 5120 with the window of 4096, a window of 256,
     q x 8, and MLA's [4, 1024] shape (H = KV = 16, dh 192, no cap); the
     causal first row must be v's row 0;
     (b) deepseek-v2-lite-16b at full width, 4 of its 27 layers: prefill_fn
     on [4, 1024] (finite; flash, dispatch and combine once a layer) and
     the serve CLI's run (every request returns 16 tokens), then
     place_slot_weights at layer 0 with the plan the live path derives from
     a prefill batch: the placed moe_apply (80 slots) equal to the live one
     within 1e-3;
     (c) gemma2-2b at full width and depth (26 layers): prefill_fn on [4,
     1024] and on [1, 5120], where the local layers' window masks (flash 26
     times a forward), and the serve run;
     (d) llama3.2-3b (all 28 layers), yi-6b (8 of 32) and starcoder2-15b (8
     of 40): prefill_fn on [1, 1024] and the serve run, llama3.2-3b's
     through the serve CLI itself, repro_torch.launch.serve.main(["--full"])
     at its default arch;
     (e) deepseek's and gemma2's first 2 layers in float32 (TF32 off) on the
     card and the CPU: prefill logits on [1, 256] within 1e-3, identical
     greedy tokens of a 2-request DecodeEngine;
     (f) flash at gemma2's prefill shape with cap 50 and cap 0 and at MLA's,
     beside SDPA without a cap and the bound; prefill tokens/s of each
     config;
     (g) flash at Jamba's attention shape [1, 1024, 64/8, 128] and phi-3's
     [1, 2048, 32/32, 96] (dh 96 in the 128 template): held against its
     plain version in (a), bf16 and float32, and timed beside SDPA and the
     bound in (f);
     (h) mamba2-780m at full width and depth (48 layers, the SSD in plain
     PyTorch, no kernel): prefill_fn on [4, 1024] and [1, 8192], the serve
     run, decode at serving load (64 busy slots, 32 steps; no kernel
     launched) and a profile of one prefill and two serving-load steps;
     (i) jamba-1.5-large-398b at full width, one 8-layer period with 4 of
     its 16 experts in bfloat16 (top-2 and 4 secondary slots kept; the
     cuts printed as "reduced"): prefill_fn on [1, 1024] (flash once, the
     MoE pack and unpack once an MoE layer) and the serve run;
     (j) phi-3-vision-4.2b at full width and depth: prefill_fn on 1024
     seeded patches [1, 1024, 1024] + [1, 1024] tokens (logits over 2048
     positions) and the serve run, text only;
     (k) mamba2's and phi-3's (with patches) first 2 layers and Jamba's
     REDUCED config in float32 on the card and the CPU, as (e);
     (l) a 2-slot DecodeEngine on mamba2's first 2 layers serves 4 requests:
     each admission's logits equal a fresh-cache prefill's (the SSM state
     is zeroed at admission).  Prints an lm_config line a config and the
     lm_configs line.
  F. whisper-base, the encoder-decoder family, at full width and depth (6 +
     6 layers, d 512, 8 x 64 heads): (a) flash against its plain version,
     bf16 and float32, at the encoder's [4, 1500, 8/8, 64] non-causal shape
     (1500 keys: a ragged last key tile) and the cross-attention's [4, 448
     q, 1500 k]; (b) prefill_fn on seeded frames [4, 1500, 512] and tokens
     [4, 448] (finite; flash 18 times: once an encoder layer, twice a
     decoder layer) and a greedy decode of 2 requests whose cross K/V come
     from encode of seeded frames; (c) the serve CLI,
     repro_torch.launch.serve.main(["--full", "--arch", "whisper-base"]):
     every request returns 16 tokens; (d) the first 2 + 2 layers in float32
     (TF32 off) on the card and the CPU: logits within 1e-3, identical
     greedy tokens; (e) positions/s (frames + tokens) of the prefill, flash
     ms at both shapes beside SDPA and the bound.  Prints the whisper line.
  G. training: (a) the flash backward kernel through its autograd function
     against ref.flash_attention_bwd (autograd through the plain forward)
     on float32 copies, bf16 and float32, at llama3.2-3b's [1, 1024, 24/8,
     128] causal, gemma2's [4, 1024, 8/4, 256] with cap 50 and with window
     256, whisper's two shapes, q x 8, and q x 4 under cap 5 (where the
     cap's derivative matters); each of dQ, dK, dV within tol (1 + max
     |want|) element by element, tol 1e-4 (float32) or 3e-2 (bf16), and
     within 1e-5 (float32) or 1e-2 (bf16) of |want| in norm, each reading
     printed beside its bounds; (b) whisper-base at full width and
     depth, adamw and warmup_cosine, batch [8, 448] with 1500 frames, 20
     steps on one fixed batch; (c) llama3.2-3b at full width, 4 of its 28
     layers, [2, 1024], 8 steps; in both the loss falls, every parameter
     stays finite, and the forward and backward kernels launch once an
     attention a step; (d) one step of whisper-base's first 2 + 2 layers in
     float32 on the card and the CPU: the loss within 1e-3, gradients and
     params after the step within 1e-3 of each leaf's largest value; (e)
     repro_torch.launch.train.main at --arch whisper-base, 4 steps with a
     checkpoint under build/, then resumed to step 8; then the backward
     kernel's times at llama's and whisper's shapes beside its plain
     version, PyTorch's flash backward kernel (aten, called directly) and
     the bound.  Prints the training line:
     ms a step, tokens/s and the backward kernel's share of a step.
Prints the throughput of each configuration, the card's name and power
limit, a {"kernels": [...]} line of six entries (each PE kernel's launches
summed over the count windows of phases 3, 7, 9, 10, 11, 12, 13 and 14:
phase 11's windows are its four flushes, phase 12's its op script runs,
phase 13's the serving before the crash and after the recovery, phase 14's
its streams and op script runs; flash_attention_bwd's over phase G's main
paths), and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
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
BF16_OPS_PER_S = 989e12        # H100 SXM, dense bf16 on the tensor cores
SEED = 3
PR_VERTICES, PR_ITERS = 2**14, 10   # the Q16.16 budget's largest V
DP_CAPACITY = 2**22                 # slots a PE; 2.6x the busiest PE's 1.62 M (alpha 3)
TUNE_TUPLES, TUNE_CHUNKS = 2**22, (2048, 4096, 8192)
LM_LAYERS = 8                  # of 48: the float32 weights of 48 do not fit 80 GB
PREFILL_SHAPE = (4, 1024)
SMOKE_SLOTS, SMOKE_MAX_LEN = 4, 128           # repro.launch.serve's defaults
LOAD_SLOTS, LOAD_MAX_LEN, LOAD_STEPS = 64, 4096, 32   # decode at serving load
LOAD_CONTEXT = (1024, LOAD_MAX_LEN - 128)      # tokens already in each slot
STREAM_LANES, STREAM_X = 8, 14                # phase 11: max_streams, SecPEs
# phases 11-14's sizes were halved to keep the script under 600 s beside
# phases F and G (HHD's phase 12 (c) as it was); PERF.md §4 lists the cuts
STREAM_TUPLES, STREAM_SMALL = 2**20, 2**20    # a tenant of the online batch; of the others
STREAM_ALPHAS = (0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.0)
PARITY_LANE_CHUNKS = 64
LANE_SWEEP, LANE_SWEEP_CHUNKS = (1, 2, 4, 8), 64
SESSION_TENANTS, SESSION_SLOTS, SESSION_AOT = 24, (8, 8), 8   # phase 12 (a), (b)
SESSION_TUPLES = 2**23                       # appended over the op script, ~64 MB
SESSION_ALPHAS = (0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
SESSION_PARITY_CHUNKS = 64
HHD_SESSION_TUPLES = 2**20                   # phase 12 (c): 0.5-2x this a tenant
DP_SESSION_TUPLES, DP_SESSION_CAPACITY = 2**21, 2**19   # phase 12 (d)
SERVICE_TENANTS, SERVICE_ASYNC_TENANTS, SERVICE_THREADS = 32, 8, 8   # phase 13
SERVICE_TUPLES, SERVICE_MAX_APPEND = 2**24, 2**19   # through the socket; 4 MB frames
SERVICE_RATE = (20.0, 4.0)                   # per-tenant requests/s, burst
SERVICE_TWIN_OPS = 200                       # single-client requests, CPU vs card
MESH_PE_SHARDS, MESH_PRI, MESH_SEC = 8, 6, 2   # phase 14 (a): examples/distributed_ditto.py
MESH_BINS, MESH_DOMAIN, MESH_CHUNK, MESH_CHUNKS, MESH_CAP = 384, 1 << 20, 6144, 16, 256
MESH_LONG_TUPLES = 2**22                     # (a): the alpha-2 stream at X = 2
MESH_ROUTE = (8, 16, 4096, 600)              # (b): shards, PEs, tuples a shard, capacity
MESH_LANE_SHARDS, MESH_SESSION_TUPLES = 4, 2**21     # (c), (d)
MESH_HHD_TENANTS, MESH_HHD_TUPLES = 4, 2**18         # (c): HHD on the meshed engine


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


def cuda_ms_turns(fns: dict, iters: int = 200) -> dict:
    """``cuda_ms`` of each named call, timed in turns (A, B, B, A) and
    averaged: host-bound calls drift with the host between moments."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cuda_ms(fns[name], iters))
    return {name: sum(t) / len(t) for name, t in times.items()}


def device_ms(fn, kernel, calls: int = 200, per_call: int = 1,
              windows: int = 3) -> float | None:
    """Mean card time of one call of ``fn``, from torch.profiler's rows of
    the kernels whose names hold ``kernel`` (a string, or a tuple of
    strings; ``per_call`` rows each call) over ``calls`` calls.

    The profiler's activity trace can miss launches: on an H100 it once
    recorded 199 of 200, and once none of 50 in a window where the kernel
    ran.  So the mean is taken over the launches it recorded, a window that
    recorded fewer than half of them is profiled again, and after
    ``windows`` such windows the card's time is not measured (None): the
    call's time from CUDA events (``ms``) then stands alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(windows):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and any(n in e.key for n in names)]
        launched = sum(e.count for e in rows) / per_call
        assert launched <= calls, f"profiler saw {launched} launches of {kernel} in {calls} calls"
        if launched >= calls // 2:
            return 1e-3 * sum(e.self_device_time_total for e in rows) / launched
        print(f"device_ms: profiler saw {launched} launches of {kernel} in {calls} calls",
              file=sys.stderr)
    return None


def host_ms(fn, calls: int = 64) -> float:
    """Wall time of one call of ``fn`` over ``calls`` calls and one sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def bound_ms(nbytes: int, ops: int,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time of a kernel: the larger of its bytes over the HBM rate
    and its operations over the peak rate of their type (default the
    float32 CUDA-core rate: the data sheet lists no int32 rate; int32 adds
    issue at the same rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_pairs(b, h, sq, sk, causal, window) -> int:
    """The (q, k) pairs the masks keep: the work of an attention call."""
    i = np.arange(sq)
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum()) * b * h


def flash_bound(q, k, v, causal, window, cap) -> tuple[float, str]:
    """Bytes: q, k, v read and the output written once.  Operations: QK^T
    and PV, 4 dh a kept pair, on the tensor cores (bf16); with a cap, 3
    float32 operations a kept pair more (a scale, tanh, a product) at the
    CUDA cores' rate, added in time."""
    b, sq, h, dh = q.shape
    pairs = flash_pairs(b, h, sq, k.shape[1], causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * dh * pairs / BF16_OPS_PER_S + (3 * pairs / FP32_OPS_PER_S if cap else 0)
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
        # one key: every tuple adds to the same 4 cells of PE 7; integer
        # values, so float sums are exact in any order
        one = torch.full((t,), 7, dtype=torch.int32, device=dev)
        cols_one = cols[:1].expand(t, depth).contiguous()
        val = torch.from_numpy(rng.integers(0, 100, t)).to(dev, dtype)
        want = ref.cms_update(sketch.clone(), one, cols_one, val)
        got = cms_update(sketch.clone(), one, cols_one, val)
        compare("cms_update", got, want, exact=True)
    return err


def chunk_inputs(spec, tuples, num_sec: int, dev):
    """eff, idx, value of the first chunk of ``tuples`` as the executor
    routes it (M = 16 PriPEs, ``num_sec`` SecPEs) under the plan that
    chunk's profile gives."""
    from repro_torch.core import mapper
    from repro_torch.core.executor import make_static_plan
    from repro_torch.core.profiler import workload_hist
    chunk = torch.as_tensor(tuples[:CHUNK], device=dev)
    dst, idx, value = spec.pre(chunk, 16)
    plan = make_static_plan(16, num_sec, workload_hist(dst, 16), device=dev)
    rank, _ = mapper.occurrence_rank(dst, 16, torch.zeros(16, dtype=torch.int32, device=dev))
    return mapper.redirect(plan, dst, rank), idx.contiguous(), value


def pe_host_pieces(entry, wrapper, via_dispatch, tensors, extra=()) -> dict:
    """Host ms of the pieces of one PE-update call (route_accumulate or
    cms_update), each alone over many calls (host_ms): the extension
    module's call on an empty chunk (it reads and checks the four tensors,
    then stops), the module's call with the chunk (checks, stream, launch),
    the whole wrapper, and the dispatch entry point the executor calls.
    ``extra`` follows the tensors in the module's call."""
    empty = (tensors[0], *(t[:0] for t in tensors[1:]), *extra)
    calls = 2000
    return {
        "checks_ms": host_ms(lambda: entry(*empty), calls),
        "module_call_ms": host_ms(lambda: entry(*tensors, *extra), calls),
        "wrapper_ms": host_ms(lambda: wrapper(*tensors), calls),
        "dispatch_ms": host_ms(lambda: via_dispatch(*tensors), calls)}


def profile_window(run, window: int) -> dict:
    """Profile ``run()`` (``window`` chunk steps, synchronised at the end)
    with torch.profiler: the card's kernel time, kernels and host aten ops
    (nested ops included) per chunk step, against the wall time per step
    under the profiler.  The profiler adds host time, so the busy share it
    gives is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    host_ops = sum(e.count for e in events if e.device_type == DeviceType.CPU
                   and e.key.startswith("aten::"))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"chunks": window,
            "host_aten_ops_per_chunk": host_ops / window,
            "device_us_per_chunk": device_us / window,
            "wall_ms_per_chunk_profiled": 1e3 * wall_s / window,
            "busy_share_profiled": device_us * 1e-6 / wall_s,
            "kernels_per_chunk": sum(e.count for e in kernels) / window,
            "top_kernels_us_per_chunk": {e.key[:80]: e.self_device_time_total / window
                                         for e in top},
            # every scan kernel, with its launches: the mapper's occurrence
            # rank scans the outer dimension, DP's own rank the inner one
            "scan_kernels_per_chunk": {e.key[:80]: {"us": e.self_device_time_total / window,
                                                    "launches": e.count / window}
                                       for e in kernels if "scan" in e.key}}


def profile_chunks(cfg, spec, tuples, num_sec, dev, warm: int = 16,
                   window: int = 64) -> dict:
    """``profile_window`` over ``window`` chunks of one stream after
    ``warm`` chunks."""
    from repro_torch.core import make_resumable_executor
    res = make_resumable_executor(spec, 16, num_sec, CHUNK, device=dev)
    chunks = torch.as_tensor(tuples[:(warm + window) * CHUNK], device=dev).view(-1, CHUNK, 2)
    state, _ = res.run_chunks(res.init_state(), chunks[:warm])
    rec = profile_window(lambda: res.run_chunks(state, chunks[warm:]), window)
    return {"config": cfg, "num_sec": num_sec, **rec}


def pe_counts() -> dict:
    from repro_torch.kernels.cms_update import cms_update
    from repro_torch.kernels.route_accumulate import route_accumulate
    return {"route_accumulate": route_accumulate.launches,
            "cms_update": cms_update.launches}


def pagerank_path(dev) -> tuple[dict, dict]:
    """Phase 7: PageRank through Ditto on the card.  The most skewed graph
    of benchmarks/fig8_pagerank.py (R-MAT, degree 32, undirected) at the
    largest V of the Q16.16 budget: 2^20 edges, 256 chunks.  PR_ITERS
    iterations of edge_contributions (card) -> run -> apply_damping (host),
    each iteration's merged sums bit-exact against oracle_scatter.  Returns
    the record and the launch counts of the iterations."""
    from repro_torch.apps import pagerank
    from repro_torch.core import Ditto
    from repro_torch.data.graphs import out_degrees, rmat_graph
    v = PR_VERTICES
    t0 = time.perf_counter()
    edges = rmat_graph(v, v * 32, seed=SEED, undirected=True)
    deg = out_degrees(edges, v)
    data_s = time.perf_counter() - t0
    n_chunks = len(edges) // CHUNK
    assert len(edges) == n_chunks * CHUNK, len(edges)
    d = Ditto(pagerank.make_spec(v, 16), chunk_size=CHUNK, device=dev)
    x = d.select(edges[:, 1])
    impl = d.generate([x])[0]
    edges_d = torch.as_tensor(edges, device=dev)
    deg_d = torch.as_tensor(deg, device=dev)
    rank = want = pagerank.init_rank(v)
    run_s, iter_s, first = 0.0, 0.0, None
    torch.cuda.synchronize()
    reset_counts()                        # ---- the main path from here
    for it in range(PR_ITERS):
        t0 = time.perf_counter()
        contrib = pagerank.edge_contributions(edges_d, torch.as_tensor(rank, device=dev),
                                              deg_d)
        t1 = time.perf_counter()
        sums, stats = impl.run(contrib.view(n_chunks, CHUNK, 2))
        torch.cuda.synchronize()
        run_s += time.perf_counter() - t1
        sums = sums.cpu().numpy()
        rank = pagerank.apply_damping(sums, v)
        iter_s += time.perf_counter() - t0
        oracle = pagerank.oracle_scatter(edges, want, deg, v, 16)
        assert np.array_equal(sums, oracle), f"pagerank: iteration {it} differs from the oracle"
        want = pagerank.apply_damping(oracle, v)
        if first is None:
            first = (contrib, float(stats.modeled_cycles.double().sum()))
    counts = pe_counts()                  # ---- to here
    assert counts == {"route_accumulate": PR_ITERS * n_chunks, "cms_update": 0}, counts
    assert not any(lm_counts().values()), lm_counts()
    assert np.array_equal(rank, want), "pagerank: final ranks differ from the oracle loop"
    got = rank.astype(np.float64) / pagerank.ONE / v
    ref_err = float(np.abs(got - pagerank.pagerank_reference(edges, v, iters=PR_ITERS)).max())
    assert ref_err < 1e-3, f"pagerank: {ref_err} from the float reference"
    # Fig. 8's row: X = 0 on iteration 1's tuples, against Ditto's X
    contrib, cycles_x = first
    base, stats0 = d.generate([0])[0].run(contrib.view(n_chunks, CHUNK, 2))
    assert np.array_equal(base.cpu().numpy(), pagerank.oracle_scatter(
        edges, pagerank.init_rank(v), deg, v, 16)), "pagerank: X = 0 differs"
    cycles_0 = float(stats0.modeled_cycles.double().sum())
    n = len(edges)
    rec = {"vertices": v, "edges": n, "chunks": n_chunks, "iterations": PR_ITERS,
           "num_pri": 16, "num_sec": x, "max_in_degree": int(np.bincount(edges[:, 1]).max()),
           "graph_s": data_s, "run_s": run_s, "tuples_per_s": PR_ITERS * n / run_s,
           "ms_per_chunk": 1e3 * run_s / (PR_ITERS * n_chunks),
           "iteration_s": iter_s / PR_ITERS,
           "modeled_mteps_x0": n / cycles_0, "modeled_mteps_ditto": n / cycles_x,
           "modeled_speedup_vs_x0": cycles_0 / cycles_x,
           "max_abs_err_vs_float_reference": ref_err, "launches": counts,
           "oracle_exact": True,
           "profile": profile_chunks("pagerank", d.spec, contrib, x, dev)}
    return rec, counts


def dp_path(dev, stream) -> dict:
    """Phase 8: DP (radix 8 bits: 256 partitions, 16 a PriPE) through Ditto
    on the card over ``stream``, with Ditto's X.  No cursor may reach the
    capacity; the partitions must equal the oracle as multisets; the first
    PARITY_CHUNKS chunks must give identical regions on card and CPU; DP's
    PE update is plain PyTorch, so neither PE kernel may launch."""
    from repro_torch.apps import dp
    from repro_torch.core import Ditto
    spec = dp.make_spec(8, 16, DP_CAPACITY)
    d = Ditto(spec, chunk_size=CHUNK, device=dev)
    impl = d.build(stream[:, 0])
    x = impl.num_sec
    chunks = d.chunk(stream)
    n_chunks = chunks.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()                        # ---- the main path from here
    t0 = time.perf_counter()
    bufs, stats = impl.run(chunks)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = pe_counts()                  # ---- to here
    assert counts == {"route_accumulate": 0, "cms_update": 0}, counts
    assert not any(lm_counts().values()), lm_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del chunks
    max_cursor = int(bufs.cursor.max())
    assert max_cursor < DP_CAPACITY, \
        f"dp: a PE wrote {max_cursor} tuples, capacity {DP_CAPACITY}: raise the capacity"
    t0 = time.perf_counter()
    parts = dp.partitions_from_buffers(bufs, 256)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = dp.oracle(stream, 8)
    assert sum(len(p) for p in parts) == len(stream)
    for p, (got, ref) in enumerate(zip(parts, want)):
        assert dp.multiset_equal(got, ref), f"dp: partition {p} differs from the oracle"
    check_s = time.perf_counter() - t0
    cursors = bufs.cursor.tolist()
    del bufs, parts, want
    torch.cuda.empty_cache()
    # host time of DP's PE update alone on the first chunk as routed (into
    # small regions, and always from the same cursors: the update returns
    # new cursors and its cost does not depend on the capacity)
    small = dp.make_spec(8, 16, 1 << 16)
    eff, idx, value = chunk_inputs(small, stream, x, dev)
    regions = small.init_buffer(16 + x, dev)
    update_ms = host_ms(lambda: small.pe_update(regions, eff, idx, value))
    # card against CPU, slot for slot
    head = stream[:PARITY_CHUNKS * CHUNK]
    outs = []
    for where in (dev, torch.device("cpu")):
        dd = Ditto(spec, chunk_size=CHUNK, device=where)
        b, st = dd.generate([x])[0].run(dd.chunk(head))
        outs.append(({f: getattr(b, f).cpu() for f in ("out", "cursor", "dst_part")},
                     st.max_load.cpu()))
        del b
    (b_gpu, l_gpu), (b_cpu, l_cpu) = outs
    for f in b_gpu:
        assert torch.equal(b_gpu[f], b_cpu[f]), f"dp: card and CPU differ in {f}"
    assert torch.equal(l_gpu, l_cpu), "dp: card and CPU differ in ExecStats.max_load"
    del outs, b_gpu, b_cpu
    torch.cuda.empty_cache()
    return {"config": "dp_a3", "tuples": len(stream), "chunks": n_chunks, "radix_bits": 8,
            "partitions": 256, "num_pri": 16, "num_sec": x, "capacity_per_pe": DP_CAPACITY,
            "max_cursor": max_cursor, "cursors": cursors,
            "state_gb": (16 + x) * DP_CAPACITY * 12 / 1e9, "peak_mem_gb": peak_gb,
            "run_s": run_s, "tuples_per_s": len(stream) / run_s,
            "ms_per_chunk": 1e3 * run_s / n_chunks,
            "modeled_tuples_per_cycle": len(stream) / float(stats.modeled_cycles.double().sum()),
            "pe_update_host_ms": update_ms,
            "partitions_read_s": read_s, "oracle_check_s": check_s,
            "cpu_parity_chunks": PARITY_CHUNKS, "launches": counts, "oracle_exact": True}


def baseline_path(dev, cases, routed) -> tuple[list, dict]:
    """Phase 9: the replicated static-dispatch baseline (16 replicas, tuple
    i to PE i % 16) over the first N_TUPLES tuples of each phase-3 stream;
    the aggregate must equal the app's flat oracle (num_pri = 1) and the PE
    kernel launch once per chunk.  Beside it, Table II's modeled ratios
    against the routed runs of phase 3 (``routed``: their tuples/s, and
    their modeled cycles at Ditto's X and at X = 0 over the same chunks)."""
    from repro_torch.core import baseline
    recs, total = [], {"route_accumulate": 0, "cms_update": 0}
    for cfg, mk, stream, oracle, kernel in cases:
        stream = stream[:N_TUPLES]
        run = baseline.make_replicated_executor(mk(1), 16, CHUNK, device=dev)
        chunks = torch.as_tensor(stream.reshape(-1, CHUNK, 2), device=dev)
        n_chunks = chunks.shape[0]
        torch.cuda.synchronize()
        reset_counts()                    # ---- the main path from here
        t0 = time.perf_counter()
        agg, st = run(chunks)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = pe_counts()              # ---- to here
        for k, c in counts.items():
            want = n_chunks if k == kernel else 0
            assert c == want, f"baseline {cfg}: {k} launched {c} times, expected {want}"
            total[k] += c
        assert np.array_equal(agg.cpu().numpy(), oracle(stream[:, 0])), \
            f"baseline {cfg}: the aggregate differs from the flat oracle"
        cycles = float(st["chunk_cycles"].double().sum()) + float(st["merge_cycles"])
        r = routed[cfg]
        recs.append({
            "config": cfg, "tuples": len(stream), "chunks": n_chunks, "replicas": 16,
            "run_s": run_s, "tuples_per_s": len(stream) / run_s,
            "ms_per_chunk": 1e3 * run_s / n_chunks,
            "routed_tuples_per_s": r["tuples_per_s"], "routed_num_sec": r["num_sec"],
            "replica_bytes_per_pe": baseline.replica_buffer_bytes(mk(1), 16),
            "routed_bytes_per_pe": baseline.routed_buffer_bytes(mk(16), 16, 0),
            "bu_saving": baseline.replica_buffer_bytes(mk(1), 16)
            / baseline.routed_buffer_bytes(mk(16), 16, 0),
            "modeled_thro_vs_replication_x0": cycles / r["cycles_x0"],
            "modeled_thro_vs_replication_ditto": cycles / r["cycles"],
            "launches": counts, "oracle_exact": True})
        del chunks, agg
    return recs, total


def tune_path(dev) -> tuple[dict, dict]:
    """Phase 10: Ditto.tune on the card (model pass, then the measured pass
    over three chunk sizes) for HISTO on a TUNE_TUPLES alpha-1.5 stream; the
    model pass must pick the X the CPU picks, and the tuned plan must drive
    make_executor bit-exact against the oracle."""
    from repro_torch.apps import histo
    from repro_torch.core import Ditto, make_executor
    from repro_torch.data.zipf import zipf_tuples
    stream = zipf_tuples(TUNE_TUPLES, 1 << 20, 1.5, seed=SEED)
    spec = histo.make_spec(512, 1 << 20, 16)
    keys = stream[:, 0]
    model_cpu = Ditto(spec, chunk_size=CHUNK, device="cpu").tune(keys)
    model = Ditto(spec, chunk_size=CHUNK, device=dev).tune(keys)
    assert (model.num_sec, model.cycles_per_tuple) == (model_cpu.num_sec,
                                                        model_cpu.cycles_per_tuple), \
        f"tune: the card's model pass picked X={model.num_sec}, the CPU's {model_cpu.num_sec}"
    torch.cuda.synchronize()
    reset_counts()                        # ---- the main path from here
    t0 = time.perf_counter()
    tuned = Ditto(spec, chunk_size=CHUNK, device=dev).tune(
        keys, measure=True, chunk_sizes=TUNE_CHUNKS)
    tune_s = time.perf_counter() - t0
    tune_counts = pe_counts()
    chunk = tuned.chunk_size
    chunks = torch.as_tensor(stream.reshape(-1, chunk, 2), device=dev)
    reset_counts()
    t0 = time.perf_counter()
    merged, _ = make_executor(spec, tuned, device=dev)(chunks, tuned.route_plan)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = pe_counts()                  # ---- to here
    cands = tuned.measured_candidates
    # each candidate: one warm-up pass and two timed passes of 4 chunks
    assert tune_counts == {"route_accumulate": 3 * 4 * len(cands), "cms_update": 0}, tune_counts
    assert counts == {"route_accumulate": chunks.shape[0], "cms_update": 0}, counts
    assert tuned.source == "measured" and {c["chunk_size"] for c in cands} == set(TUNE_CHUNKS)
    assert np.array_equal(merged.cpu().numpy(), histo.oracle(keys, 512, 1 << 20, 16)), \
        "tune: the tuned run differs from the oracle"
    total = {k: tune_counts[k] + counts[k] for k in counts}
    return {"config": "histo_a1.5", "tuples": len(stream), "model_num_sec": model.num_sec,
            "model_num_sec_cpu": model_cpu.num_sec,
            "model_cycles_per_tuple": model.cycles_per_tuple,
            "default_cycles_per_tuple": model.default_cycles_per_tuple,
            "tuned": tuned.to_record(), "tune_s": tune_s, "run_s": run_s,
            "tuples_per_s": len(stream) / run_s, "ms_per_chunk": 1e3 * run_s / chunks.shape[0],
            "launches": total, "oracle_exact": True}, total


def _assert_stats_equal(got, want, what: str):
    """Every ExecStats field of ``got`` equal to ``want`` (tensors or numpy)."""
    for f in ("max_load", "modeled_cycles", "mode", "rescheduled", "workload"):
        a, b = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                for x in (getattr(got, f), getattr(want, f)))
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{what}: ExecStats.{f} differs"


def _tree_equal(a, b) -> bool:
    """Every leaf of two ExecStates / RoutePlans equal."""
    if dataclasses.is_dataclass(a):
        return all(_tree_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return torch.equal(a, b)


def stream_path(dev, stream_3) -> tuple[dict, dict]:
    """Phase 11: StreamEngine at serving size, every engine on the default
    obs bundle.  HISTO (512 bins, domain 2^20): an online batch of 8
    tenants at Zipf alpha STREAM_ALPHAS, 2^20 - r_i tuples each (r_0 = 0,
    seven ragged tails), and a planned batch of 5 tenants with plans from
    make_static_plan on a 0.1% sample, STREAM_SMALL tuples each (3 pad
    lanes); HHD (depth 4, width 1024): 8 tenants at alpha 3, STREAM_SMALL
    each; HLL (p = 12, domain 2^22): 4 ragged tenants (4 pad lanes).  M = 16, X = 14, chunks of
    CHUNK, max_streams = STREAM_LANES.  Checks: every tenant equal to the
    app's oracle and to its stream alone through make_executor on the card
    (merged and every ExecStats field); the first PARITY_LANE_CHUNKS chunks
    of the online batch identical on card and CPU; pad lanes left as
    init_state made them; each PE kernel once per batched chunk; the
    Prometheus text through parse_prometheus; the trace's spans.  Then the
    lane sweep, a profile at L = 8, and the flattened PE launch against L
    per-lane launches, in turns.  Returns the record and the launch counts
    of the flush windows."""
    from repro_torch import obs as obs_lib
    from repro_torch.apps import hhd, histo, hll
    from repro_torch.core.executor import (_lane_pe_update, make_executor,
                                           make_multistream_executor,
                                           make_resumable_executor, make_static_plan,
                                           stack_states, take_lanes, with_plan)
    from repro_torch.core.profiler import workload_hist
    from repro_torch.data.pipeline import chunk_stream
    from repro_torch.data.zipf import zipf_tuples
    from repro_torch.kernels import dispatch
    from repro_torch.obs.metrics import parse_prometheus, snapshot_from_prometheus
    from repro_torch.serve import StreamEngine

    o = obs_lib.get_default()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    short = rng.choice(np.arange(1, CHUNK), 7 + 4, replace=False)
    online = [zipf_tuples(STREAM_TUPLES - r, 1 << 20, a, seed=SEED + 100 + i)
              for i, (a, r) in enumerate(zip(STREAM_ALPHAS, [0, *short[:7]]))]
    planned = [zipf_tuples(STREAM_SMALL, 1 << 20, a, seed=SEED + 200 + i)
               for i, a in enumerate((1.0, 1.5, 2.0, 2.5, 3.0))]
    heavy = [zipf_tuples(STREAM_SMALL, 1 << 20, 3.0, seed=SEED + 300 + i) for i in range(8)]
    regs = [zipf_tuples(STREAM_SMALL - r, 1 << 22, a, seed=SEED + 400 + i)
            for i, (a, r) in enumerate(zip((0.0, 1.0, 2.0, 3.0), short[7:]))]
    data_s = time.perf_counter() - t0
    hspec = histo.make_spec(512, 1 << 20, 16)
    plans = []
    for data in planned:
        sample = data[rng.choice(len(data), len(data) // 1000, replace=False)]
        dst = hspec.pre(torch.as_tensor(sample, device=dev), 16)[0]
        plans.append(make_static_plan(16, STREAM_X, workload_hist(dst, 16), device=dev))
    cases = [
        # name, spec, tenants, plans, oracle, the kernel its PE update launches
        ("histo_online", hspec, online, None,
         lambda k: histo.oracle(k, 512, 1 << 20, 16), "route_accumulate"),
        ("histo_planned", hspec, planned, plans,
         lambda k: histo.oracle(k, 512, 1 << 20, 16), "route_accumulate"),
        ("hhd_a3", hhd.make_spec(4, 1024, 16), heavy, None,
         lambda k: hhd.oracle(k, 4, 1024, 16), "cms_update"),
        ("hll_ragged", hll.make_spec(12, 16), regs, None,
         lambda k: hll.oracle(k, 12, 16), "route_accumulate"),
    ]
    launches = {"route_accumulate": 0, "cms_update": 0}
    recs, recorded = [], {}
    with obs_lib.region("phase11") as region:
        for name, spec, tenants, tplans, oracle, kernel in cases:
            eng = StreamEngine(spec, num_pri=16, num_sec=STREAM_X, chunk_size=CHUNK,
                               max_streams=STREAM_LANES, device=dev, obs=o)
            inner = eng._run_streams

            def recording(tuples, plans=None, mask=None, inner=inner, name=name):
                out = inner(tuples, plans, mask=mask)
                recorded[name] = (tuples, plans, mask, out)
                return out
            eng._run_streams = recording
            rids = [eng.submit(data, plan=None if tplans is None else tplans[i])
                    for i, data in enumerate(tenants)]
            n_chunks = -(-max(len(d) for d in tenants) // CHUNK)
            torch.cuda.synchronize()
            reset_counts()                # ---- the main path from here
            t0 = time.perf_counter()
            out = eng.flush()
            flush_s = time.perf_counter() - t0
            counts = pe_counts()          # ---- to here
            assert not any(lm_counts().values()), lm_counts()
            for k, c in counts.items():
                want = n_chunks if k == kernel else 0
                assert c == want, f"{name}: {k} launched {c} times, expected {want} " \
                                  "(once per batched chunk)"
                launches[k] += c
            t0 = time.perf_counter()
            solo = make_executor(spec, 16, STREAM_X, CHUNK, device=dev)
            for i, (rid, data) in enumerate(zip(rids, tenants)):
                merged, stats = out[rid]
                assert np.array_equal(merged, oracle(data[:, 0])), \
                    f"{name}: tenant {i} differs from the numpy oracle"
                ts = chunk_stream(data, CHUNK, pad_tail=True)
                m, st = solo(torch.as_tensor(ts.body, device=dev),
                             None if tplans is None else tplans[i],
                             mask=None if len(data) % CHUNK == 0
                             else torch.as_tensor(ts.mask, device=dev))
                assert np.array_equal(merged, m.cpu().numpy()), \
                    f"{name}: tenant {i} differs from its stream run alone"
                _assert_stats_equal(stats, st, f"{name}: tenant {i} against its solo run")
            check_s = time.perf_counter() - t0
            # pad lanes: their outputs over the whole run, and their whole
            # state over the first chunks, as init_state made it
            tuples, tplan, mask, (merged, stats) = recorded[name]
            pads = list(range(len(tenants), STREAM_LANES))
            if pads:
                assert not merged[pads].any() and not stats.workload[pads].any() \
                    and not stats.max_load[pads].any() and not stats.rescheduled[pads].any()
                assert bool((stats.mode[pads] == int(tplans is not None)).all())
                res = make_resumable_executor(spec, 16, STREAM_X, CHUNK, device=dev)
                start = stack_states(res.init_state(), STREAM_LANES)
                if tplan is not None:
                    start = with_plan(start, tplan)
                end, _ = res.scan_lanes(start, tuples[:, :16], mask[:, :16])
                assert _tree_equal(take_lanes(end, pads), take_lanes(start, pads)), \
                    f"{name}: a pad lane's state moved"
            n_tuples = sum(len(d) for d in tenants)
            rec = {"engine": name, "tenants": len(tenants), "pad_lanes": len(pads),
                   "tuples": n_tuples, "batched_chunks": n_chunks, "flush_s": flush_s,
                   "tuples_per_s": n_tuples / flush_s,
                   "ms_per_batched_chunk": 1e3 * flush_s / n_chunks,
                   "launches": counts, "reschedules": int(stats.rescheduled.sum()),
                   "oracle_exact": True, "solo_exact": True, "check_s": check_s}
            print("stream_engine", json.dumps(rec))
            recs.append(rec)
            del tuples, mask, merged, stats
            recorded.clear()
    build_delta = dataclasses.asdict(region.inclusive)

    # the first chunks of the online batch on card and CPU
    body = np.stack([chunk_stream(d[:PARITY_LANE_CHUNKS * CHUNK], CHUNK).body for d in online])
    outs = []
    for where in (dev, torch.device("cpu")):
        run = make_multistream_executor(hspec, 16, STREAM_X, CHUNK, device=where)
        merged, stats = run(torch.as_tensor(body),
                            mask=torch.ones(body.shape[:3], dtype=torch.bool))
        outs.append((merged.cpu(), stats))
    assert torch.equal(outs[0][0], outs[1][0]), "online batch: card and CPU merged differ"
    _assert_stats_equal(outs[0][1], outs[1][1], "online batch: card against CPU")

    # the obs exports
    text = o.registry.prometheus_text()
    samples = {(n, tuple(sorted(lbl.items()))): v for n, lbl, v in parse_prometheus(text)}
    snapshot_from_prometheus(text)
    assert samples[("stream_requests_total", ())] == 25.0, samples
    assert samples[("stream_batches_total", ())] == 4.0, samples
    assert samples[("flush_latency_ms_count", (("scope", "stream"),))] == 4.0, samples
    trace = REPO / "build" / "stream_trace.json"
    trace.parent.mkdir(exist_ok=True)
    o.tracer.write(trace)
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"executor.build", "stream.flush", "stream.batch"} <= spans, spans

    # ms per batched chunk at L lanes of the alpha-3 stream, and per chunk
    # of the single-stream executor on lane 0's chunks, in turns
    k = LANE_SWEEP_CHUNKS
    runs = {lanes: (make_multistream_executor(hspec, 16, STREAM_X, CHUNK, device=dev),
                    torch.as_tensor(stream_3[:lanes * k * CHUNK], device=dev)
                    .view(lanes, k, CHUNK, 2)) for lanes in LANE_SWEEP}
    runs["single"] = (make_executor(hspec, 16, STREAM_X, CHUNK, device=dev),
                      runs[1][1][0])
    sweep = {key: [] for key in runs}
    for key in (*runs, *list(runs)[::-1]):
        run, tuples = runs[key]
        run(tuples[..., :2, :, :])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(tuples)
        torch.cuda.synchronize()
        sweep[key].append(1e3 * (time.perf_counter() - t0) / k)
    lane_ms = {key: sum(t) / len(t) for key, t in sweep.items()}
    lane_rate = {key: (1 if key == "single" else key) * CHUNK / (ms * 1e-3)
                 for key, ms in lane_ms.items()}

    # a profiled window of 16 batched chunks at L = 8 after 4
    lanes = LANE_SWEEP[-1]
    res = make_resumable_executor(hspec, 16, STREAM_X, CHUNK, device=dev)
    tuples = runs[lanes][1]
    assert tuples.shape[1] >= 20
    states, _ = res.scan_lanes(stack_states(res.init_state(), lanes), tuples[:, :4])
    profile = profile_window(lambda: res.scan_lanes(states, tuples[:, 4:20]), 16)

    # one flattened PE launch against L per-lane launches of the same chunk
    flat_vs = {}
    for app, spec, pe in (("histo", hspec, lambda b, e, i, v: dispatch.pe_buffer_update(
                              b, e, i, v, "add")),
                          ("hhd", hhd.make_spec(4, 1024, 16), dispatch.cms_update)):
        parts = [chunk_inputs(spec, stream_3[l * CHUNK:], STREAM_X, dev) for l in range(lanes)]
        eff, idx, val = (torch.stack(t) for t in zip(*parts))
        bufs = torch.stack([spec.init_buffer(16 + STREAM_X, dev)] * lanes)
        flat_vs[app] = cuda_ms_turns({
            "flattened_ms": lambda: _lane_pe_update(pe, bufs, eff, idx, val, 16 + STREAM_X),
            "per_lane_ms": lambda: [pe(bufs[l], eff[l], idx[l], val[l]) for l in range(lanes)]})
    rec = {"engines": recs, "data_s": data_s, "compilemon_phase11": build_delta,
           "cpu_parity_chunks": PARITY_LANE_CHUNKS,
           "ms_per_batched_chunk": lane_ms, "tuples_per_s_by_lanes": lane_rate,
           "profile_l8": profile, "flattened_vs_per_lane": flat_vs,
           "prometheus_samples": len(samples), "trace_spans": sorted(spans)}
    return rec, launches


# ---------------------------------------------------------------- phase 12

class SlotModel:
    """The session engine's documented admission and backlog semantics: a
    strictly FIFO queue admitted into the lowest free slot, and the tuples
    each session holds on the host (full chunks leave at a flush, all of
    them at a per-session flush or a query)."""

    def __init__(self, slots: int, chunk: int):
        self.slot_sid = [None] * slots
        self.queue, self.free, self.pending, self.chunk = [], list(range(slots)), {}, chunk

    def _admit(self):
        while self.queue and self.free:
            self.slot_sid[self.free.pop(0)] = self.queue.pop(0)

    def admitted(self) -> list:
        return [s for s in self.slot_sid if s is not None]

    def open(self, sid):
        self.pending[sid] = 0
        self.queue.append(sid)
        self._admit()

    def flush(self, force=()):
        self._admit()
        for s in self.admitted():
            self.pending[s] = 0 if s in force else self.pending[s] % self.chunk

    def close(self, sid):
        slot = self.slot_sid.index(sid)
        self.slot_sid[slot], self.pending[sid] = None, 0
        self.free = sorted(self.free + [slot])
        self._admit()


def session_script(lengths, rng, storm: int, wave_a: int, slots: int) -> list:
    """A seeded op script over tenants 0..len(lengths)-1 (tenant t is sid t):
    the first ``storm`` arrive as one open_batch whose first appends are 1-3
    chunks plus a ragged tail; the next ``wave_a`` open at once and queue,
    each with one ragged append; the rest open one at a time when a close
    frees a slot that no queued tenant takes.  Each round every admitted
    tenant appends 0-4 chunks plus a ragged tail with probability 0.8, one
    admitted tenant queries (either scope), then an engine flush (0.5) or a
    per-session flush (0.3), and admitted tenants whose stream is appended
    in full close.  A ("query_all",) op -- every admitted tenant queries --
    stands two thirds of the way through (phase 12b crashes there)."""
    model = SlotModel(slots, CHUNK)
    pos, ops, closed = [0] * len(lengths), [], set()

    def take(t, n):
        n = int(min(n, lengths[t] - pos[t]))
        pos[t] += n
        return n

    sizes = [take(t, (1 + rng.integers(3)) * CHUNK + rng.integers(1, CHUNK))
             for t in range(storm)]
    ops.append(("storm", list(range(storm)), sizes))
    for t in range(storm):
        model.open(t)
    for t in range(storm, storm + wave_a):
        ops.append(("open", t))
        model.open(t)
        ops.append(("append", t, take(t, rng.integers(1, 2 * CHUNK))))
    nxt = storm + wave_a
    while len(closed) < len(lengths):
        for t in model.admitted():
            if pos[t] < lengths[t] and rng.random() < 0.8:
                ops.append(("append", t, take(t, rng.integers(0, 5) * CHUNK
                                               + rng.integers(0, CHUNK))))
        admitted = model.admitted()
        if admitted:
            ops.append(("query", int(rng.choice(admitted)),
                        ("session", "engine")[int(rng.integers(2))]))
        r = rng.random()
        if r < 0.5:
            ops.append(("flush",))
        elif r < 0.8 and admitted:
            ops.append(("flush_session", int(rng.choice(admitted))))
        for t in model.admitted():
            if pos[t] == lengths[t]:
                ops.append(("close", t))
                model.close(t)
                closed.add(t)
                if model.free and nxt < len(lengths):
                    ops.append(("open", nxt))
                    model.open(nxt)
                    nxt += 1
    ops.insert(2 * len(ops) // 3, ("query_all",))
    return ops


class ScriptRunner:
    """Runs a session op script on an engine and checks it after every op:
    each query and close bit-exact against the app's oracle of the tenant's
    tuples so far, the engine's slot table, queue, free slots and every
    session's backlog equal to ``SlotModel``'s.  Records the answers, the
    query latencies by scope, the lanes busy and granted after each engine
    flush, and the slot table after each op.  The runner's position and
    model carry across engines (a recovered engine continues the script)."""

    def __init__(self, ops, streams, oracle, slots: int, full_check: bool = True):
        self.ops, self.streams, self.oracle = ops, streams, oracle
        self.full_check = full_check
        self.model = SlotModel(slots, CHUNK)
        self.pos = [0] * len(streams)
        # the running oracle by tenant (a tenant may query before it appends)
        self.want = [oracle(s[:0, 0]) for s in streams]
        self.answers, self.slot_log, self.lat = {}, [], {"session": [], "engine": []}
        self.busy, self.granted, self.i, self.queued_opens = [], [], 0, 0

    def _take(self, t, n):
        d = self.streams[t][self.pos[t]:self.pos[t] + n]
        self.pos[t] += n
        self.want[t] = self.want[t] + self.oracle(d[:, 0])
        return d

    def _answer(self, t, got):
        assert np.array_equal(got, self.want[t]), \
            f"op {self.i}: tenant {t} differs from the oracle of its tuples so far"

    def run(self, eng, stop=None, stop_steps=None, mark=None):
        """Ops from the current one up to ``stop`` (or until the engine's
        batched chunk steps reach ``stop_steps``); ``mark``: the op index
        before which the engine state is kept in ``self.marked``."""
        while self.i < len(self.ops) and (stop is None or self.i < stop):
            if stop_steps is not None and lane_steps(eng) >= stop_steps:
                break
            if self.i == mark:
                self.marked = engine_state(eng)
            self.step(eng, self.ops[self.i])
            self.i += 1

    def step(self, eng, op):
        m, kind = self.model, op[0]
        if kind == "storm":
            firsts = [self._take(t, n) for t, n in zip(op[1], op[2])]
            assert eng.open_batch([f"tenant{t}" for t in op[1]], first=firsts) == op[1]
            for t, n in zip(op[1], op[2]):
                m.open(t)
                m.pending[t] += n
            for t in op[1]:
                if t in m.admitted():
                    m.pending[t] %= CHUNK
        elif kind == "open":
            assert eng.open(f"tenant{op[1]}") == op[1]
            m.open(op[1])
            self.queued_opens += op[1] in m.queue
        elif kind == "append":
            eng.append(op[1], self._take(op[1], op[2]))
            m.pending[op[1]] += op[2]
        elif kind == "query":
            t0 = time.perf_counter()
            got = eng.query(op[1], scope=op[2])
            self.lat[op[2]].append(1e3 * (time.perf_counter() - t0))
            if op[2] == "engine":
                m.flush(force=(op[1],))
            m.pending[op[1]] = 0
            self._answer(op[1], got)
            self.answers[self.i] = got
        elif kind == "query_all":
            got = {t: eng.query(t) for t in m.admitted()}
            for t, a in got.items():
                m.pending[t] = 0
                self._answer(t, a)
            self.answers[self.i] = got
        elif kind == "flush":
            eng.flush()
            m.flush()
            granted = int((eng._sec_assign >= 0).sum())
            self.busy.append(len(m.admitted()) + granted)
            self.granted.append(granted)
        elif kind == "flush_session":
            eng.flush_session(op[1])
            m.pending[op[1]] = 0
        elif kind == "close":
            got, _ = eng.close(op[1])
            self._answer(op[1], got)
            if self.full_check:
                assert np.array_equal(got, self.oracle(self.streams[op[1]][:self.pos[op[1]], 0])), \
                    f"tenant {op[1]} differs from the oracle of its whole stream"
            m.close(op[1])
            self.answers[self.i] = got
        assert eng._slot_sid == m.slot_sid and list(eng._queue) == m.queue \
            and sorted(eng._free_slots) == m.free, f"op {self.i} {kind}: slot table or queue"
        for sid, n in m.pending.items():
            assert eng.sessions[sid].backlog_tuples == n, \
                f"op {self.i} {kind}: session {sid} holds {eng.sessions[sid].backlog_tuples}, not {n}"
        self.slot_log.append((tuple(eng._slot_sid), tuple(eng._queue),
                              tuple(eng._sec_assign.tolist())))


def lane_steps(eng, since: int = 0) -> int:
    """Batched chunk steps of an engine's flushes (its telemetry rows from
    ``since``): each is one chunk step of the lanes, one PE launch."""
    return sum(r["lane_width"] for r in list(eng._telemetry)[since:])


def engine_state(eng) -> dict:
    return {"flush_no": eng._flush_no, "slot_sid": list(eng._slot_sid),
            "queue": list(eng._queue), "sec_assign": eng._sec_assign.tolist(),
            "backlogs": {sid: s.backlog_tuples for sid, s in eng.sessions.items()}}


def int_rows(eng) -> list:
    """The integer fields of an engine's telemetry rows (the wall-clock
    milliseconds and the build counters left out)."""
    return [{k: v for k, v in r.items() if not k.endswith("_ms") and k != "n_retraces"}
            for r in eng._telemetry]


def session_summary(eng, drv, run_s: float) -> dict:
    rows = list(eng._telemetry)
    eng_rows = [r for r in rows if r["scope"] == "engine"]
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None
    return {"tuples": int(sum(drv.pos)), "run_s": run_s,
            "engine_flush_tuples_per_s": sum(r["tuples"] for r in eng_rows)
            / (1e-3 * sum(r["flush_ms"] for r in eng_rows)),
            "query_ms": {s: {"n": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                         for s, v in drv.lat.items()},
            "flushes": {s: sum(r["scope"] == s for r in rows)
                        for s in ("engine", "session", "admit")},
            "batched_chunks": lane_steps(eng), "slot_reschedules": eng.slot_reschedules,
            "grants_max": max(drv.granted, default=0),
            "busy_lanes_mean": float(np.mean(drv.busy)) if drv.busy else 0.0,
            "busy_lanes_max": max(drv.busy, default=0)}


def session_path(dev) -> tuple[dict, dict]:
    """Phase 12: SessionEngine at the paper's scale and shape (M = 16,
    X = 14, chunks of CHUNK) on the default obs bundle.  (a) HISTO (512
    bins, domain 2^20), SESSION_SLOTS lanes, aot_buckets=SESSION_AOT: 24
    tenants at Zipf alpha cycling SESSION_ALPHAS, ~SESSION_TUPLES tuples in
    all, through ``session_script``'s ops, every answer against the oracle,
    the slot table against FIFO admission, no build event after warmup(),
    route_accumulate once per batched chunk step; the first
    SESSION_PARITY_CHUNKS batched chunks of the same ops on a CPU engine
    with identical answers, slot tables and integer telemetry.  (b) the same
    ops on a DurableSessionEngine (checkpoint_every=4, keep=3), dropped
    without shutdown two thirds through and recovered on the card: answers,
    backlogs and slot table as (a)'s at that point, a checkpoint restored,
    fewer records replayed than logged, then the rest with (a)'s checks.
    (c) HHD (depth 4, width 1024), 8 tenants at alpha 3 with secondary
    grants: cms_update over [16 * 30, 4, 1024] lanes, answers against the
    oracle.  (d) DP (radix 8) on a SessionEngine(secondary_slots=0) of 4
    tenants of DP_SESSION_TUPLES at alpha 0-3, DP_SESSION_CAPACITY slots a
    PE: partitions against the oracle as multisets, no cursor at the
    capacity, no PE kernel launched.  Returns the printed records and the
    launch counts of the op scripts' runs."""
    import shutil

    from repro_torch import obs as obs_lib
    from repro_torch.apps import dp, hhd, histo
    from repro_torch.core import compilemon
    from repro_torch.data.zipf import zipf_tuples
    from repro_torch.serve import DurableSessionEngine, SessionEngine

    rng = np.random.default_rng(SEED + 12)
    launches = {"route_accumulate": 0, "cms_update": 0}
    primary, secondary = SESSION_SLOTS
    kw = dict(num_pri=16, num_sec=STREAM_X, chunk_size=CHUNK, primary_slots=primary,
              secondary_slots=secondary, aot_buckets=SESSION_AOT, telemetry_cap=None)
    hspec = histo.make_spec(512, 1 << 20, 16)
    horacle = lambda k: histo.oracle(k, 512, 1 << 20, 16)
    out = {}
    t0 = time.perf_counter()
    weights = 1 + np.arange(SESSION_TENANTS) % 3
    lengths = [int(SESSION_TUPLES * w / weights.sum()) - int(rng.integers(0, CHUNK))
               for w in weights]
    streams = [zipf_tuples(n, 1 << 20, SESSION_ALPHAS[t % len(SESSION_ALPHAS)],
                           seed=SEED + 500 + t) for t, n in enumerate(lengths)]
    ops = session_script(lengths, rng, storm=primary, wave_a=primary, slots=primary)
    crash_at = next(i for i, op in enumerate(ops) if op[0] == "query_all")
    data_s = time.perf_counter() - t0

    with obs_lib.region("phase12") as region:
        # ---- (a) HISTO sessions on the card
        eng = SessionEngine(hspec, device=dev, obs=obs_lib.get_default(), **kw)
        aot = eng.warmup(dtype=np.int32, feat_shape=(2,))
        snap = compilemon.snapshot()
        drv = ScriptRunner(ops, streams, horacle, primary)
        torch.cuda.synchronize()
        reset_counts()                    # ---- the main path from here
        t0 = time.perf_counter()
        drv.run(eng, mark=crash_at)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = pe_counts()              # ---- to here
        assert not any(lm_counts().values()), lm_counts()
        assert counts == {"route_accumulate": lane_steps(eng), "cms_update": 0}, counts
        assert compilemon.since(snap).n_compiles == 0, "a build event after warmup()"
        assert drv.i == len(ops) and all(eng.sessions[t].closed for t in range(len(lengths)))
        assert drv.queued_opens == primary, drv.queued_opens
        for k, c in counts.items():
            launches[k] += c
        rec = session_summary(eng, drv, run_s)
        rec.update({"tenants": len(lengths), "ops": len(ops), "data_s": data_s, "aot": aot,
                    "slots": SESSION_SLOTS, "launches": counts, "oracle_exact": True,
                    "queued_opens": drv.queued_opens})
        # the first batched chunks of the same ops on the CPU
        t0 = time.perf_counter()
        cpu = SessionEngine(hspec, device="cpu", obs=False, **kw)
        cpu.warmup(dtype=np.int32, feat_shape=(2,))
        cdrv = ScriptRunner(ops, streams, horacle, primary, full_check=False)
        cdrv.run(cpu, stop_steps=SESSION_PARITY_CHUNKS)
        for i, ans in cdrv.answers.items():
            want = drv.answers[i]
            assert (ans.keys() == want.keys() and all(np.array_equal(ans[k], want[k])
                                                      for k in ans)) \
                if isinstance(ans, dict) else np.array_equal(ans, want), f"cpu op {i}"
        assert cdrv.slot_log == drv.slot_log[:cdrv.i], "card and CPU slot tables differ"
        assert int_rows(cpu) == int_rows(eng)[:len(cpu._telemetry)], \
            "card and CPU telemetry differ"
        rec["cpu_parity"] = {"batched_chunks": lane_steps(cpu), "ops": cdrv.i,
                             "s": time.perf_counter() - t0}
        out["session"] = rec
        del cpu, cdrv, eng

        # ---- (b) the same ops, durable, crashed and recovered
        ddir = REPO / "build" / "phase12_durable"
        shutil.rmtree(ddir, ignore_errors=True)
        bobs = obs_lib.Observability()
        deng = DurableSessionEngine(hspec, directory=ddir, checkpoint_every=4, keep=3,
                                    wal_sync=False, device=dev, obs=bobs, **kw)
        deng.warmup(dtype=np.int32, feat_shape=(2,))
        ddrv = ScriptRunner(ops, streams, horacle, primary, full_check=False)
        reset_counts()
        t0 = time.perf_counter()
        ddrv.run(deng, stop=crash_at)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        counts = pe_counts()
        assert counts == {"route_accumulate": lane_steps(deng), "cms_update": 0}, counts
        for k, c in counts.items():
            launches[k] += c
        deng._mgr.wait()                  # the async checkpoint in flight reaches disk
        crashed, deng = deng, None        # dropped without shutdown or drain
        records = sum(v for n, _, v in obs_lib.parse_prometheus(
            bobs.registry.prometheus_text()) if n == "wal_records_total")
        t0 = time.perf_counter()
        reng = SessionEngine.recover(hspec, ddir, device=dev, obs=bobs)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        info = reng.recovery_info
        assert info["checkpoint_step"] is not None, info
        assert info["replayed_records"] < records and info["replay_anomalies"] == 0, info
        assert engine_state(reng) == drv.marked, "the recovered engine differs from (a)"
        snap, n0 = compilemon.snapshot(), len(reng._telemetry)
        reset_counts()
        t0 = time.perf_counter()
        ddrv.run(reng)
        torch.cuda.synchronize()
        post_s = time.perf_counter() - t0
        counts = pe_counts()
        assert counts == {"route_accumulate": lane_steps(reng, n0), "cms_update": 0}, counts
        assert compilemon.since(snap).n_compiles == 0, "a build event after recovery"
        for k, c in counts.items():
            launches[k] += c
        for i, want in drv.answers.items():
            got = ddrv.answers[i]
            assert (got.keys() == want.keys() and all(np.array_equal(got[k], want[k])
                                                      for k in got)) \
                if isinstance(want, dict) else np.array_equal(got, want), f"durable op {i}"
        t0 = time.perf_counter()
        reng.checkpoint(block=True)
        ckpt_ms = 1e3 * (time.perf_counter() - t0)
        samples = {n: v for n, lbl, v in obs_lib.parse_prometheus(bobs.registry.prometheus_text())
                   if not lbl}
        wal_bytes = samples["wal_bytes_total"]
        out["durability"] = {
            "ops_before_crash": crash_at, "run_s_before_crash": pre_s,
            "run_s_after_recovery": post_s, "recover_s": recover_s, "recovery": info,
            "records_logged_before_crash": records, "checkpoint_ms_blocking": ckpt_ms,
            "checkpoints": samples["checkpoints_total"], "wal_bytes": wal_bytes,
            "wal_mb_per_s_append": wal_bytes / 1e6 / (1e-3 * samples["wal_append_ms_sum"]),
            "wal_mb_per_s_run": wal_bytes / 1e6 / (pre_s + post_s),
            "query_ms": session_summary(reng, ddrv, pre_s + post_s)["query_ms"],
            "answers_equal_uninterrupted": True, "launches": counts}
        reng.shutdown()
        crashed.shutdown()
        shutil.rmtree(ddir, ignore_errors=True)
        del reng, crashed, drv, ddrv, streams

        # ---- (c) HHD sessions at alpha 3: cms_update over the lanes
        cspec = hhd.make_spec(4, 1024, 16)
        clen = [HHD_SESSION_TUPLES * (1 + t % 4) // 2 - int(rng.integers(0, CHUNK))
                for t in range(primary)]
        cstreams = [zipf_tuples(n, 1 << 20, 3.0, seed=SEED + 600 + t)
                    for t, n in enumerate(clen)]
        cops = session_script(clen, rng, storm=primary, wave_a=0, slots=primary)
        ceng = SessionEngine(cspec, device=dev, obs=obs_lib.get_default(), **kw)
        ceng.warmup(dtype=np.int32, feat_shape=(2,))
        cdrv = ScriptRunner(cops, cstreams, lambda k: hhd.oracle(k, 4, 1024, 16), primary)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        cdrv.run(ceng)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = pe_counts()
        assert counts == {"route_accumulate": 0, "cms_update": lane_steps(ceng)}, counts
        assert max(cdrv.granted) > 0, "no secondary lane was granted"
        for k, c in counts.items():
            launches[k] += c
        crec = session_summary(ceng, cdrv, run_s)
        crec.update({"tenants": primary, "lanes_x_pes": (primary + secondary) * (16 + STREAM_X),
                     "launches": counts, "oracle_exact": True})
        out["session"]["hhd"] = crec
        del ceng, cdrv, cstreams
        torch.cuda.empty_cache()

        # ---- (d) DP under lanes: 4 tenants, no secondary slots
        spec = dp.make_spec(8, 16, DP_SESSION_CAPACITY)
        dstreams = [zipf_tuples(DP_SESSION_TUPLES - (t * 977) % CHUNK, 1 << 20, float(t),
                                seed=SEED + 700 + t) for t in range(4)]
        deng = SessionEngine(spec, num_pri=16, num_sec=STREAM_X, chunk_size=CHUNK,
                             primary_slots=4, secondary_slots=0, device=dev,
                             obs=obs_lib.get_default(), telemetry_cap=None)
        sids = [deng.open(f"dp{t}") for t in range(4)]
        pieces = [np.array_split(s, 8 + t) for t, s in enumerate(dstreams)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        for r in range(max(len(p) for p in pieces)):
            for sid, p in zip(sids, pieces):
                if r < len(p):
                    deng.append(sid, p[r])
            deng.flush()
        closed = [deng.close(sid)[0] for sid in sids]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = pe_counts()
        assert counts == {"route_accumulate": 0, "cms_update": 0}, counts
        assert not any(lm_counts().values()), lm_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        t0 = time.perf_counter()
        cursors = []
        for t, bufs in enumerate(closed):
            cursors.append(int(bufs.cursor.max()))
            assert cursors[-1] < DP_SESSION_CAPACITY, \
                f"dp tenant {t}: a PE wrote {cursors[-1]} tuples, capacity {DP_SESSION_CAPACITY}"
            parts = dp.partitions_from_buffers(bufs, 256)
            assert sum(len(p) for p in parts) == len(dstreams[t])
            for p, (got, want) in enumerate(zip(parts, dp.oracle(dstreams[t], 8))):
                assert dp.multiset_equal(got, want), f"dp tenant {t}: partition {p}"
        rows = list(deng._telemetry)
        eng_rows = [r for r in rows if r["scope"] == "engine"]
        out["session_dp"] = {
            "tenants": 4, "tuples": sum(len(s) for s in dstreams), "run_s": run_s,
            "engine_flush_tuples_per_s": sum(r["tuples"] for r in eng_rows)
            / (1e-3 * sum(r["flush_ms"] for r in eng_rows)),
            "batched_chunks": lane_steps(deng), "capacity_per_pe": DP_SESSION_CAPACITY,
            "state_gb": 4 * (16 + STREAM_X) * DP_SESSION_CAPACITY * 12 / 1e9,
            "peak_mem_gb": peak_gb, "max_cursor_by_tenant": cursors,
            "check_s": time.perf_counter() - t0, "launches": counts, "oracle_exact": True}
        del deng, closed, dstreams
        torch.cuda.empty_cache()
    out["session"]["compilemon_phase12"] = dataclasses.asdict(region.inclusive)
    return out, launches

# ---------------------------------------------------------------- phase 13

def device_zipf_tuples(n: int, domain: int, alpha: float, seed: int, dev) -> np.ndarray:
    """[n, 2] int32 tuples with Zipf(alpha) keys over a permuted domain and
    random values, drawn on the card from a seeded generator (the inverse
    CDF of ``data.zipf``, made where it is fast) and copied to the host."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ranks = torch.arange(1, domain + 1, device=dev, dtype=torch.float64)
    w = ranks.pow(-alpha) if alpha > 0 else torch.ones_like(ranks)
    cdf = torch.cumsum(w / w.sum(), 0)
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    r = torch.searchsorted(cdf, u, right=True).clamp_(max=domain - 1)
    keys = torch.randperm(domain, generator=g, device=dev)[r]
    vals = torch.randint(0, 2**31 - 1, (n,), generator=g, device=dev)
    return torch.stack([keys, vals], 1).to(torch.int32).cpu().numpy()


class Gate:
    """The clients' way through a crash: a request enters only while the
    gate is open (``in_flight`` counts it until its answer), so the phase
    can close the gate, wait until every request still in flight is an open
    parked in the admission queue, and stop the service with nothing else
    outstanding.  Reopening hands out the new service's address."""

    def __init__(self, addr):
        self.cond = threading.Condition()
        self.open, self.in_flight, self.epoch, self.addr = True, 0, 0, addr

    def enter(self, block: bool = True):
        with self.cond:
            while not self.open:
                if not block:
                    return None
                self.cond.wait()
            self.in_flight += 1
            return self.epoch, self.addr

    def exit(self):
        with self.cond:
            self.in_flight -= 1

    def close(self):
        with self.cond:
            self.open = False

    def reopen(self, addr):
        with self.cond:
            self.epoch, self.addr, self.open = self.epoch + 1, addr, True
            self.cond.notify_all()


class Tally:
    """Client-side counts of each (op, status) and latencies of answered
    requests, shared by every client thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counts, self.ms = {}, {}

    def add(self, op, status, ms=None):
        with self.lock:
            self.counts[(op, status)] = self.counts.get((op, status), 0) + 1
            if ms is not None:
                self.ms.setdefault(op, []).append(ms)

    def snapshot(self) -> dict:
        with self.lock:
            return dict(self.counts)


def tenant_ops(length: int, rng) -> list:
    """One tenant's script over a stream of ``length`` tuples: ragged
    appends of 2^4-2^19 tuples (log-uniform, plus a ragged part), a query
    in either scope after about a third of them, then close."""
    ops, pos = [], 0
    while pos < length:
        n = int(min(length - pos, min(SERVICE_MAX_APPEND, 2 ** rng.uniform(4, 19)
                                      + rng.integers(0, CHUNK))))
        ops.append(("append", pos, n))
        pos += n
        if rng.random() < 0.3:
            ops.append(("query", ("session", "engine")[int(rng.integers(2))]))
    ops.append(("close",))
    return ops


def audit_slots(eng, faults: list):
    """Wrap the engine's slot-changing calls (on the instance) to check,
    after each, that no slot is held twice: the held slots, their sessions
    and the free heap agree."""
    def check():
        held = [(slot, sid) for slot, sid in enumerate(eng._slot_sid) if sid is not None]
        ok = (len({sid for _, sid in held}) == len(held)
              and not {slot for slot, _ in held} & set(eng._free_slots)
              and len(held) + len(eng._free_slots) == eng.primary_slots
              and all(eng.sessions[sid].slot == slot and not eng.sessions[sid].closed
                      for slot, sid in held))
        if not ok:
            faults.append((list(eng._slot_sid), sorted(eng._free_slots)))

    for name in ("open", "open_batch", "close"):
        fn = getattr(eng, name)

        def audited(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            check()
            return out
        setattr(eng, name, audited)


def service_counts(text: str) -> dict:
    """{(op, status): n} of ``service_requests_total`` in a /metrics body."""
    from repro_torch.obs import parse_prometheus
    return {(lbl["op"], lbl["status"]): int(v) for n, lbl, v in parse_prometheus(text)
            if n == "service_requests_total" and v}


def service_twin(dev, kw, hspec) -> dict:
    """The same ~SERVICE_TWIN_OPS single-client requests through a service
    over a CPU engine and one over a CUDA engine: identical response metas
    (trace ids and timings left out) and payload bytes."""
    from repro_torch.serve import SessionEngine
    from repro_torch.serve.service import (ServiceClient, ServiceConfig, SessionService,
                                           encode_frame)
    rng = np.random.default_rng(SEED + 13)
    sides = []
    for where in (dev, torch.device("cpu")):
        eng = SessionEngine(hspec, device=where, obs=False, **kw)
        eng.warmup(dtype=np.int32, feat_shape=(2,))
        svc = SessionService(eng, ServiceConfig(admission="scored"))
        svc.start()
        sides.append((svc, ServiceClient(*svc.address, timeout=600, trace=False)))
    t0 = time.perf_counter()
    live, n_tenant, seq, bytes_equal = [], 0, 0, 0

    def send(meta, payload=b""):
        nonlocal seq, bytes_equal
        seq += 1
        frame = encode_frame(dict(meta, id=seq), payload)
        for _, c in sides:
            c.send_raw(frame)
        (gm, gp), (cm, cp) = [c.read_response() for _, c in sides]
        for m in (gm, cm):                    # wall-clock totals differ
            for k in ("compile_stall_ms", "admit_stall_ms"):
                m.get("stats", {}).get("totals", {}).pop(k, None)
        assert gm == cm and gp == cp, f"twin request {seq} {meta['op']}: {gm} != {cm}"
        bytes_equal += len(gp)
        return gm

    while seq < SERVICE_TWIN_OPS:
        r = rng.random()
        if (r < 0.15 or not live) and len(live) < kw["primary_slots"]:
            live.append(send({"op": "open", "tenant": f"twin{n_tenant % 5}"})["sid"])
            n_tenant += 1
        elif r < 0.6:
            n = int(rng.integers(0, 3 * CHUNK))
            keys = (rng.zipf(1.5, n) % (1 << 20)).astype(np.int32)
            a = np.stack([keys, rng.integers(0, 1 << 30, n).astype(np.int32)], 1)
            send({"op": "append", "sid": int(rng.choice(live)),
                  "array": {"dtype": a.dtype.str, "shape": list(a.shape)}}, a.tobytes())
        elif r < 0.85:
            send({"op": "query", "sid": int(rng.choice(live)),
                  "scope": ("session", "engine")[int(rng.integers(2))]})
        elif r < 0.95:
            sid = live.pop(int(rng.integers(len(live))))
            send({"op": "close", "sid": sid})
        else:
            send({"op": ("stats", "bogus")[int(rng.integers(2))]})
    for sid in live:
        send({"op": "close", "sid": sid})
    for svc, c in sides:
        c.close_conn()
        svc.stop()
    return {"requests": seq, "payload_bytes_equal": bytes_equal,
            "s": time.perf_counter() - t0}


def service_path(dev) -> tuple[dict, dict]:
    """Phase 13: SessionService in front of a DurableSessionEngine on the
    card, HISTO at the paper's scale and shape (512 bins, domain 2^20,
    M = 16, X = 14, chunks of CHUNK, 8 + 8 lanes, aot_buckets=8,
    checkpoint_every=4, keep=3), scored admission, a per-tenant rate limit
    and the scrape sidecar.  SERVICE_TENANTS tenants at Zipf alpha cycling
    SESSION_ALPHAS, ~SERVICE_TUPLES tuples in all, over loopback from
    SERVICE_THREADS threads with a ServiceClient each (their tenants one
    after another) and one AsyncServiceClient that drives its tenants at
    once with pipelined appends; rate-limited requests sleep their
    RETRY-AFTER and retry.  About two thirds through, the clients pause,
    the service stops (parked opens answered ERR_BACKPRESSURE) and the
    engine is dropped without shutdown; recover() on the card, warmup() and
    a new service, and the clients reconnect and finish.  Checks: every
    query and close against the oracle of the tuples acknowledged by then;
    every acknowledged append in the recovered engine; every open answered;
    no slot held twice; held opens drain to 0; the client-side (op, status)
    counts equal service_requests_total from /metrics (at the pause and at
    the end); /healthz and /statusz; a traced request's echo and root span;
    no build event after each warmup(); route_accumulate once per batched
    chunk step; and ``service_twin``.  Returns the printed record and the
    launch counts of the two serving windows."""
    import asyncio
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    from repro_torch import obs as obs_lib
    from repro_torch.apps import histo
    from repro_torch.core import compilemon
    from repro_torch.serve import DurableSessionEngine, SessionEngine
    from repro_torch.serve.errors import BackpressureError, RateLimitedError
    from repro_torch.serve.service import (AsyncServiceClient, ServiceClient, ServiceConfig,
                                           SessionService)

    primary, secondary = SESSION_SLOTS
    kw = dict(num_pri=16, num_sec=STREAM_X, chunk_size=CHUNK, primary_slots=primary,
              secondary_slots=secondary, aot_buckets=SESSION_AOT, telemetry_cap=None)
    hspec = histo.make_spec(512, 1 << 20, 16)
    horacle = lambda k: histo.oracle(k, 512, 1 << 20, 16)
    rng = np.random.default_rng(SEED + 13)
    t_phase = time.perf_counter()
    weights = 1 + np.arange(SERVICE_TENANTS) % 3
    lengths = [int(SERVICE_TUPLES * w / weights.sum()) - int(rng.integers(0, CHUNK))
               for w in weights]
    streams = [device_zipf_tuples(n, 1 << 20, SESSION_ALPHAS[t % len(SESSION_ALPHAS)],
                                  SEED + 1300 + t, dev) for t, n in enumerate(lengths)]
    scripts = [tenant_ops(n, rng) for n in lengths]
    data_s = time.perf_counter() - t_phase
    total = sum(lengths)
    acked = [0] * SERVICE_TENANTS           # tuples acknowledged, by tenant
    want = [horacle(np.zeros(0, np.int64)) for _ in lengths]
    sids = [None] * SERVICE_TENANTS
    faults, tally = [], Tally()
    (REPO / "build").mkdir(exist_ok=True)
    ddir = Path(tempfile.mkdtemp(prefix="phase13_", dir=REPO / "build"))
    rate = dict(rate_limit=SERVICE_RATE[0], rate_burst=SERVICE_RATE[1])

    def url(svc, path):
        host, port = svc.scrape_address
        try:
            with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60) as r:
                return r.status, r.read().decode("utf-8")
        except urllib.error.HTTPError as e:  # 503: lost a mutation race, retry
            return e.code, e.read().decode("utf-8")

    def scrape_live(svc):
        """/healthz must answer 200; /statusz parses when the sidecar did
        not lose its read to a mutating worker (a documented 503)."""
        health.append(url(svc, "/healthz")[0])
        code, body = url(svc, "/statusz")
        statusz[code] = statusz.get(code, 0) + 1
        if code == 200:
            assert "service" in json.loads(body)

    def start(eng):
        audit_slots(eng, faults)
        svc = SessionService(eng, ServiceConfig(admission="scored", scrape_port=0, **rate))
        busy = [0.0]
        run = svc._run_batch

        def timed(batch):                 # the worker's busy time
            t0 = time.perf_counter()
            try:
                return run(batch)
            finally:
                busy[0] += time.perf_counter() - t0
        svc._run_batch = timed
        svc.start()
        return svc, busy

    def on_answer(t, op, got, stats=None):
        assert np.array_equal(got, want[t]), f"tenant {t}: {op} differs from the oracle"
        if stats is not None:
            assert stats["tuples_appended"] == acked[t], (t, stats, acked[t])

    def on_append(t, d):
        acked[t] += len(d)
        want[t] = want[t] + horacle(d[:, 0])

    # ---- the sync clients: one connection a thread, tenants in turn
    def sync_call(conn, op, fn):
        while True:
            epoch, addr = gate.enter()
            wait = 0.0
            try:
                if conn.get("epoch") != epoch:
                    if conn.get("c") is not None:
                        conn["c"].close_conn()
                    conn["c"], conn["epoch"] = ServiceClient(*addr, timeout=600), epoch
                t0 = time.perf_counter()
                try:
                    res = fn(conn["c"])
                except RateLimitedError as e:
                    tally.add(op, "ERR_RATELIMIT")
                    wait = e.retry_after_ms
                except BackpressureError as e:        # a parked open at stop()
                    tally.add(op, "ERR_BACKPRESSURE")
                    wait, conn["epoch"] = e.retry_after_ms, None
                else:
                    tally.add(op, "OK", 1e3 * (time.perf_counter() - t0))
                    return res
            finally:
                gate.exit()
            time.sleep(wait / 1e3)

    def sync_tenant(conn, t):
        sids[t] = sync_call(conn, "open", lambda c: c.open(f"tenant{t}"))
        for op in scripts[t]:
            if op[0] == "append":
                d = streams[t][op[1]:op[1] + op[2]]
                sync_call(conn, "append", lambda c: c.append(sids[t], d))
                on_append(t, d)
            elif op[0] == "query":
                on_answer(t, "query", sync_call(conn, "query",
                                                lambda c: c.query(sids[t], scope=op[1])))
            else:
                merged, stats = sync_call(conn, "close", lambda c: c.close(sids[t]))
                on_answer(t, "close", merged, stats)

    def sync_worker(k, errors):
        conn = {}
        try:
            for t in range(k, SERVICE_TENANTS - SERVICE_ASYNC_TENANTS, SERVICE_THREADS):
                sync_tenant(conn, t)
        except Exception as e:               # reported by the phase
            errors.append((f"sync {k}", repr(e)))
        finally:
            if conn.get("c") is not None:
                conn["c"].close_conn()

    # ---- the async client: one connection, its tenants at once, appends
    # pipelined in groups of up to 12 (beyond the burst: rate limits)
    async def async_main(errors):
        conn, lock = {}, asyncio.Lock()

        async def call(op, fn):
            while True:
                while (tok := gate.enter(block=False)) is None:
                    await asyncio.sleep(0.002)
                epoch, addr = tok
                wait = 0.0
                try:
                    async with lock:
                        if conn.get("epoch") != epoch:
                            if conn.get("c") is not None:
                                await conn["c"].aclose()
                            conn["c"] = await AsyncServiceClient.connect(*addr)
                            conn["epoch"] = epoch
                    t0 = time.perf_counter()
                    try:
                        res = await fn(conn["c"])
                    except RateLimitedError as e:
                        tally.add(op, "ERR_RATELIMIT")
                        wait = e.retry_after_ms
                    except BackpressureError as e:
                        tally.add(op, "ERR_BACKPRESSURE")
                        wait = e.retry_after_ms
                    else:
                        tally.add(op, "OK", 1e3 * (time.perf_counter() - t0))
                        return res
                finally:
                    gate.exit()
                await asyncio.sleep(wait / 1e3)

        async def tenant(t, trng):
            sids[t] = await call("open", lambda c: c.open(f"tenant{t}"))
            ops, i = scripts[t], 0
            while i < len(ops):
                if ops[i][0] == "append":
                    j, size = i, int(trng.integers(1, 13))
                    while j < len(ops) and ops[j][0] == "append" and j - i < size:
                        j += 1
                    group = [streams[t][o[1]:o[1] + o[2]] for o in ops[i:j]]

                    async def one(d):
                        await call("append", lambda c: c.append(sids[t], d))
                        on_append(t, d)
                    await asyncio.gather(*(one(d) for d in group))
                    i = j
                    continue
                if ops[i][0] == "query":
                    scope = ops[i][1]
                    on_answer(t, "query", await call("query",
                                                     lambda c: c.query(sids[t], scope=scope)))
                else:
                    on_answer(t, "close", await call("close", lambda c: c.close(sids[t])))
                i += 1

        try:
            first = SERVICE_TENANTS - SERVICE_ASYNC_TENANTS
            await asyncio.gather(*(tenant(t, np.random.default_rng(SEED + t))
                                   for t in range(first, SERVICE_TENANTS)))
        except Exception as e:               # reported by the phase
            errors.append(("async", repr(e)))
        finally:
            if conn.get("c") is not None:
                await conn["c"].aclose()

    with obs_lib.region("phase13") as region:
        obs = obs_lib.Observability()
        eng = DurableSessionEngine(hspec, directory=ddir, checkpoint_every=4, keep=3,
                                   wal_sync=False, device=dev, obs=obs, **kw)
        eng.warmup(dtype=np.int32, feat_shape=(2,))
        snap = compilemon.snapshot()
        svc, busy = start(eng)
        gate = Gate(svc.address)
        errors, health, statusz = [], [], {}
        torch.cuda.synchronize()
        reset_counts()                        # ---- the main path from here
        t_serve = time.perf_counter()
        # daemons: a failed check must not leave the process waiting on them
        threads = [threading.Thread(target=sync_worker, args=(k, errors), name=f"client-{k}",
                                    daemon=True) for k in range(SERVICE_THREADS)]
        threads.append(threading.Thread(target=lambda: asyncio.run(async_main(errors)),
                                        name="client-async", daemon=True))
        for th in threads:
            th.start()
        # serve until two thirds of the tuples are acknowledged
        while sum(acked) < 2 * total // 3 and not errors and any(th.is_alive() for th in threads):
            scrape_live(svc)
            time.sleep(0.25)
        assert not errors, errors
        gate.close()
        t0 = time.perf_counter()
        while not (gate.in_flight == svc.status()["service"]["held_opens"]
                   and svc.status()["service"]["request_queue"] == 0):
            assert time.perf_counter() - t0 < 120, "clients did not pause"
            time.sleep(0.005)
        serve1_s = time.perf_counter() - t_serve
        parked = gate.in_flight
        torch.cuda.synchronize()
        counts1 = pe_counts()                 # ---- to here (first window)
        steps1 = lane_steps(eng)
        assert counts1 == {"route_accumulate": steps1, "cms_update": 0}, (counts1, steps1)
        assert compilemon.since(snap).n_compiles == 0, "a build event after warmup()"
        metrics1 = url(svc, "/metrics")[1]
        assert service_counts(metrics1) == tally.snapshot(), \
            (service_counts(metrics1), tally.snapshot())
        rows1 = list(eng._telemetry)
        busy1 = busy[0]
        svc.stop()                            # parked opens: ERR_BACKPRESSURE
        t0 = time.perf_counter()
        while gate.in_flight:
            assert time.perf_counter() - t0 < 60, "a parked open was not answered"
            time.sleep(0.005)
        eng._mgr.wait()                       # the async checkpoint in flight reaches disk
        crashed, eng = eng, None              # dropped without shutdown or drain
        want_acked = list(acked)
        t0 = time.perf_counter()
        reng = SessionEngine.recover(hspec, ddir, device=dev, obs=obs)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        info = reng.recovery_info
        assert info["replay_anomalies"] == 0, info
        for t, sid in enumerate(sids):
            if sid is not None and not reng.sessions[sid].closed:
                s = reng.sessions[sid]
                assert s.backlog_tuples + s.stats.tuples_flushed == want_acked[t], \
                    f"tenant {t}: {s.backlog_tuples} + {s.stats.tuples_flushed} != {want_acked[t]}"
        t0 = time.perf_counter()
        reng.warmup(dtype=np.int32, feat_shape=(2,))
        warmup2_s = time.perf_counter() - t0
        snap, n0 = compilemon.snapshot(), len(reng._telemetry)
        svc, busy = start(reng)
        torch.cuda.synchronize()
        reset_counts()                        # ---- the main path again
        t_serve = time.perf_counter()
        gate.reopen(svc.address)
        traced = None
        while any(th.is_alive() for th in threads):
            scrape_live(svc)
            if traced is None:                # one traced request, its echo
                with ServiceClient(*svc.address, timeout=600) as c:
                    rmeta, _ = c.request({"op": "ping"})
                    traced = c.last_trace["trace_id"]
                    assert rmeta["trace"]["trace_id"] == traced, rmeta
            for th in threads:
                th.join(timeout=0.25)
        serve2_s = time.perf_counter() - t_serve
        assert not errors, errors
        torch.cuda.synchronize()
        counts2 = pe_counts()                 # ---- to here (second window)
        steps2 = lane_steps(reng, n0)
        assert counts2 == {"route_accumulate": steps2, "cms_update": 0}, (counts2, steps2)
        assert not any(lm_counts().values()), lm_counts()
        assert compilemon.since(snap).n_compiles == 0, "a build event after recovery"
        roots = [e for e in obs.tracer.events()
                 if e["name"] == "svc.request" and e["args"]["trace_id"] == traced]
        assert len(roots) == 1 and roots[0]["args"]["op"] == "ping", roots
        st = svc.status()
        assert st["service"]["held_opens"] == 0 and st["engine"]["open_sessions"] == 0, st
        assert all(reng.sessions[sid].closed for sid in sids)
        assert acked == lengths, "a tenant's stream was not acknowledged in full"
        assert not faults, faults
        assert set(health) == {200} and statusz.get(200), (health, statusz)
        metrics = url(svc, "/metrics")[1]
        got = service_counts(metrics)
        want_counts = tally.snapshot()
        want_counts[("ping", "OK")] = 1
        assert got == want_counts, (got, want_counts)
        samples = {n: v for n, lbl, v in obs_lib.parse_prometheus(metrics) if not lbl}
        busy2 = busy[0]
        svc.stop()
        rows2 = list(reng._telemetry)[n0:]
        reng.shutdown()
        crashed.shutdown()
        shutil.rmtree(ddir, ignore_errors=True)

        # ---- the same single-client requests over a CPU and a CUDA engine
        twin = service_twin(dev, kw, hspec)
    del streams
    serve_s = serve1_s + serve2_s
    rows = rows1 + rows2
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None
    ops = sorted({op for op, _ in tally.counts})
    out = {
        "tenants": SERVICE_TENANTS, "tuples": total, "clients": SERVICE_THREADS,
        "async_tenants": SERVICE_ASYNC_TENANTS, "data_s": data_s,
        "serve_s": serve_s, "serve_s_before_crash": serve1_s, "serve_s_after": serve2_s,
        "requests_per_s": {op: sum(v for (o, s), v in tally.counts.items()
                                   if o == op and s == "OK") / serve_s for op in ops},
        "client_ms": {op: {"n": len(tally.ms.get(op, [])), "p50": pct(tally.ms.get(op, []), 50),
                           "p99": pct(tally.ms.get(op, []), 99)} for op in ops},
        "append_tuples_per_s": total / serve_s,
        "engine_flush_tuples_per_s": sum(r["tuples"] for r in rows)
        / (1e-3 * sum(r["flush_ms"] for r in rows)),
        "batched_chunks": steps1 + steps2,
        "mean_batch_ops": samples["service_batch_ops_sum"] / samples["service_batch_ops_count"],
        "worker_busy_share": (busy1 + busy2) / serve_s,
        "rate_limited": sum(v for (o, s), v in tally.counts.items() if s == "ERR_RATELIMIT"),
        "backpressured": sum(v for (o, s), v in tally.counts.items() if s == "ERR_BACKPRESSURE"),
        "parked_at_crash": parked, "recover_s": recover_s, "warmup_after_recovery_s": warmup2_s,
        "recovery": info, "launches": {"route_accumulate": steps1 + steps2, "cms_update": 0},
        "statusz": statusz, "twin": twin, "oracle_exact": True,
        "compilemon_phase13": dataclasses.asdict(region.inclusive),
        "phase_s": time.perf_counter() - t_phase}
    assert out["rate_limited"] > 0, "no client reached the rate limit"
    return out, out["launches"]


# ---------------------------------------------------------------- phase 14

def mesh_launches(eng, since: int = 0) -> int:
    """PE launches of an engine's flushes (telemetry rows from ``since``):
    an engine-wide batched chunk step launches once a shard, a per-session
    or admission step once (its lane group gathered onto one device)."""
    shards = 1 if eng.mesh is None else eng.mesh.size
    return sum(r["lane_width"] * (shards if r["scope"] == "engine" else 1)
               for r in list(eng._telemetry)[since:])


def route_oracle(tup, eff, num_pe, capacity, shards, fill):
    """``route_all_to_all``'s documented result in numpy: per (destination,
    source) shard the source's tuples for that destination in stream order,
    the first ``capacity`` kept; and the number dropped."""
    t_loc, per = len(tup) // shards, num_pe // shards
    routed = np.full((shards, shards, capacity) + tup.shape[1:], fill, tup.dtype)
    valid = np.zeros((shards, shards, capacity), bool)
    dst = eff.astype(np.int64) // per
    dropped = 0
    for s in range(shards):
        fill_to = np.zeros(shards, np.int64)
        for i in range(s * t_loc, (s + 1) * t_loc):
            d = dst[i]
            if 0 <= d < shards and fill_to[d] < capacity:
                routed[d, s, fill_to[d]], valid[d, s, fill_to[d]] = tup[i], True
                fill_to[d] += 1
            else:
                dropped += 1
    return routed, valid, dropped


def pe_sharded_path(dev) -> tuple[dict, int]:
    """Phase 14 (a) and (b).  (a) ``run_stream`` with one PE a shard on
    MESH_PE_SHARDS logical shards of the card at the widths of
    examples/distributed_ditto.py: its 16-chunk HISTO streams at alpha 0 and
    2, X = 0 and 2, each chunk identical on the card and on a CPU mesh
    (buffers, loads, drops, workload), the example's claim (alpha 2: X = 0
    drops more than 1000 tuples after the plan, X = 2 none at a lower max
    receive load; alpha 0 oracle-exact); HLL (p = 12, max) at alpha 2, X = 2,
    oracle-exact, its chunks against the CPU; then a MESH_LONG_TUPLES alpha-2
    HISTO stream at X = 2, timed, oracle-exact when nothing dropped.  Every
    run launches route_accumulate once a shard a chunk.  (b)
    ``route_all_to_all`` on MESH_ROUTE's 8 card shards against its numpy
    oracle, timed.  Returns the record and the PE launches of (a)."""
    from repro_torch.apps import histo, hll
    from repro_torch.core import distributed as D
    from repro_torch.core.router import route_all_to_all
    from repro_torch.data.zipf import zipf_tuples

    mesh = D.make_mesh(MESH_PE_SHARDS, "pe", device=dev)
    cpu_mesh = D.make_mesh(MESH_PE_SHARDS, "pe", device="cpu")
    spec = histo.make_spec(MESH_BINS, MESH_DOMAIN, MESH_PRI)
    horacle = lambda k: histo.oracle(k, MESH_BINS, MESH_DOMAIN, MESH_PRI)
    launches, runs = 0, {}

    def traced(spec_, m, data, sec):
        per = []

        def keep(c, buffers, load, dropped, workload):
            per.append([torch.cat([b.cpu() for b in buffers]), load.cpu(), dropped.cpu(),
                        workload.cpu()])

        merged, stats = D.run_stream(spec_, m, data, MESH_PRI, sec, capacity=MESH_CAP,
                                     on_chunk=keep)
        return merged.cpu(), stats, per

    def card_and_cpu(name, spec_, data, sec):
        nonlocal launches
        torch.cuda.synchronize()
        reset_counts()
        merged, stats, per = traced(spec_, mesh, data, sec)
        torch.cuda.synchronize()
        counts = pe_counts()
        want = {"route_accumulate": MESH_PE_SHARDS * len(data), "cms_update": 0}
        assert counts == want, f"{name}: {counts}, expected {want}"
        launches += counts["route_accumulate"]
        cmerged, cstats, cper = traced(spec_, cpu_mesh, data, sec)
        for c, (a, b) in enumerate(zip(per, cper)):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), f"{name}: chunk {c} card != CPU"
        assert torch.equal(merged, cmerged) and stats["loads"] == cstats["loads"], name
        return merged, stats

    for alpha in (0.0, 2.0):
        data = zipf_tuples(MESH_CHUNK * MESH_CHUNKS, MESH_DOMAIN, alpha,
                           seed=SEED).reshape(MESH_CHUNKS, MESH_CHUNK, 2)
        for sec in (0, MESH_SEC):
            merged, stats = card_and_cpu(f"histo a{alpha} X{sec}", spec, data, sec)
            exact = stats["dropped"] == 0 and np.array_equal(
                merged.numpy(), horacle(data.reshape(-1, 2)[:, 0]))
            runs[f"histo_a{alpha:g}_x{sec}"] = {
                k: stats[k] for k in ("max_load", "max_load_postplan", "dropped",
                                      "dropped_postplan")} | {"oracle_exact": exact}
    a0 = [runs[f"histo_a0_x{x}"] for x in (0, MESH_SEC)]
    a2x0, a2x2 = runs["histo_a2_x0"], runs[f"histo_a2_x{MESH_SEC}"]
    assert all(r["oracle_exact"] for r in a0), a0
    assert a2x0["dropped_postplan"] > 1000 and a2x2["dropped_postplan"] == 0, runs
    assert a2x2["max_load_postplan"] < a2x0["max_load_postplan"], runs

    # HLL: max folds; the profiling chunk's drops repeat hot keys that
    # later chunks carry, so the registers still equal the oracle's
    hspec = hll.make_spec(12, MESH_PRI)
    data = zipf_tuples(MESH_CHUNK * MESH_CHUNKS, MESH_DOMAIN, 2.0,
                       seed=SEED).reshape(MESH_CHUNKS, MESH_CHUNK, 2)
    merged, stats = card_and_cpu("hll a2", hspec, data, MESH_SEC)
    assert np.array_equal(merged.numpy(), hll.oracle(data.reshape(-1, 2)[:, 0], 12, MESH_PRI)), \
        "hll: merged registers differ from the oracle"
    assert stats["dropped_postplan"] == 0, stats
    runs["hll_a2_x2"] = {k: stats[k] for k in ("max_load", "max_load_postplan", "dropped",
                                                 "dropped_postplan")} | {"oracle_exact": True}

    # the long stream, timed
    n = MESH_LONG_TUPLES // MESH_CHUNK
    long = zipf_tuples(n * MESH_CHUNK, MESH_DOMAIN, 2.0, seed=SEED + 14).reshape(n, MESH_CHUNK, 2)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    merged, stats = D.run_stream(spec, mesh, long, MESH_PRI, MESH_SEC, capacity=MESH_CAP)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = pe_counts()
    assert counts == {"route_accumulate": MESH_PE_SHARDS * n, "cms_update": 0}, counts
    launches += counts["route_accumulate"]
    assert stats["dropped_postplan"] == 0, stats
    exact = None
    if stats["dropped"] == 0:
        exact = bool(np.array_equal(merged.cpu().numpy(), horacle(long.reshape(-1, 2)[:, 0])))
        assert exact, "the long stream differs from the oracle"
    rec = {"shards": MESH_PE_SHARDS, "num_pri": MESH_PRI, "num_sec": MESH_SEC,
           "chunk": MESH_CHUNK, "capacity": MESH_CAP, "runs": runs,
           "long": {"tuples": n * MESH_CHUNK, "chunks": n, "run_s": run_s,
                    "ms_per_chunk": 1e3 * run_s / n, "tuples_per_s": n * MESH_CHUNK / run_s,
                    "max_load_preplan": stats["loads"][0],
                    "max_load_postplan": stats["max_load_postplan"],
                    "dropped": stats["dropped"], "dropped_postplan": stats["dropped_postplan"],
                    "assignment": stats["assignment"].tolist(), "oracle_exact": exact}}

    # (b) route_all_to_all on card shards against its oracle
    shards, num_pe, t_loc, cap = MESH_ROUTE
    rng = np.random.default_rng(SEED + 140)
    tup = rng.integers(-2**31, 2**31 - 1, size=(shards * t_loc, 2), dtype=np.int64).astype(np.int32)
    eff = np.minimum(rng.zipf(1.3, size=shards * t_loc) - 1, num_pe).astype(np.int32)
    rmesh = D.make_mesh(shards, "model", device=dev)
    args = (torch.as_tensor(tup, device=dev), torch.as_tensor(eff, device=dev), num_pe, cap,
            rmesh)
    routed, valid = route_all_to_all(*args, fill_value=-1)
    want_r, want_v, dropped = route_oracle(tup, eff, num_pe, cap, shards, -1)
    for d in range(shards):
        assert np.array_equal(routed[d].cpu().numpy(), want_r[d]) and \
            np.array_equal(valid[d].cpu().numpy(), want_v[d]), f"route_all_to_all shard {d}"
    assert len(tup) - sum(int(v.sum()) for v in valid) == dropped
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        route_all_to_all(*args, fill_value=-1)
    torch.cuda.synchronize()
    rec["route_all_to_all"] = {"shards": shards, "num_pe": num_pe, "tuples": len(tup),
                               "capacity": cap, "dropped": dropped, "oracle_exact": True,
                               "ms_per_call": 1e3 * (time.perf_counter() - t0) / 20}
    return rec, launches


def mesh_session_path(dev) -> tuple[dict, int]:
    """Phase 14 (c) and (d).  (c) ``SessionEngine(mesh=make_mesh(
    MESH_LANE_SHARDS, "lanes"))`` at phase 12a's shape (HISTO, 8 + 8 lanes,
    4 a shard, aot_buckets=8) and a local engine on the card, through one
    seeded op script of ~MESH_SESSION_TUPLES tuples: every answer against
    the oracle and equal across the two, slot tables, grants, folds and the
    integer telemetry equal, some fold across shards, no build event after
    warmup(), route_accumulate once a shard an engine-wide step and once a
    per-session or admission step; then HHD on a meshed engine (cms_update
    likewise).  (d) the same ops on a durable meshed engine dropped two
    thirds through, recovered onto the mesh and onto mesh=None: each equal
    to (c)'s run at the crash and to the end.  Returns the record and the PE
    launches of every op script's run."""
    import copy
    import shutil

    from repro_torch import obs as obs_lib
    from repro_torch.apps import hhd, histo
    from repro_torch.core import compilemon
    from repro_torch.core import distributed as D
    from repro_torch.data.zipf import zipf_tuples
    from repro_torch.serve import DurableSessionEngine, SessionEngine

    rng = np.random.default_rng(SEED + 14)
    launches = {"route_accumulate": 0, "cms_update": 0}
    primary, secondary = SESSION_SLOTS
    kw = dict(num_pri=16, num_sec=STREAM_X, chunk_size=CHUNK, primary_slots=primary,
              secondary_slots=secondary, aot_buckets=SESSION_AOT, telemetry_cap=None)
    hspec = histo.make_spec(512, 1 << 20, 16)
    horacle = lambda k: histo.oracle(k, 512, 1 << 20, 16)
    mesh = D.make_mesh(MESH_LANE_SHARDS, "lanes", device=dev)
    weights = 1 + np.arange(SESSION_TENANTS) % 3
    lengths = [int(MESH_SESSION_TUPLES * w / weights.sum()) - int(rng.integers(0, CHUNK))
               for w in weights]
    streams = [zipf_tuples(n, 1 << 20, SESSION_ALPHAS[t % len(SESSION_ALPHAS)],
                           seed=SEED + 800 + t) for t, n in enumerate(lengths)]
    ops = session_script(lengths, rng, storm=primary, wave_a=primary, slots=primary)
    crash_at = next(i for i, op in enumerate(ops) if op[0] == "query_all")

    def counted(eng, drv, kernel, **run_kw):
        """Run the script on ``eng``: its launches checked and summed."""
        n0 = len(eng._telemetry)
        snap = compilemon.snapshot()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        drv.run(eng, **run_kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = pe_counts()
        want = {"route_accumulate": 0, "cms_update": 0, kernel: mesh_launches(eng, n0)}
        assert counts == want, f"launches {counts}, expected {want}"
        assert compilemon.since(snap).n_compiles == 0, "a build event after warmup()"
        for k, c in counts.items():
            launches[k] += c
        return run_s

    out, drvs, folds = {}, {}, []
    for name, m in (("mesh", mesh), ("local", None)):
        eng = SessionEngine(hspec, device=dev, mesh=m, obs=obs_lib.Observability(), **kw)
        aot = eng.warmup(dtype=np.int32, feat_shape=(2,))
        if m is not None:
            fold = eng._fold_lane

            def spy(states, src, dst, fold=fold, shard=eng._lanes.lane_sharding):
                folds.append((shard[src], shard[dst]))
                return fold(states, src, dst)

            eng._fold_lane = spy
        drv = ScriptRunner(ops, streams, horacle, primary)
        run_s = counted(eng, drv, "route_accumulate", mark=crash_at)
        assert drv.i == len(ops) and drv.queued_opens == primary
        out[name] = session_summary(eng, drv, run_s) | {
            "aot_warmup_ms": aot["warmup_ms"], "launches": mesh_launches(eng),
            "lanes_per_device": eng.lanes_per_device,
            "mesh_devices": eng.telemetry_record()["extra"]["config"]["mesh_devices"]}
        drvs[name] = (drv, eng.slot_reschedules, int_rows(eng))
        del eng
    (mdrv, mfolds, mrows), (ldrv, lfolds, lrows) = drvs["mesh"], drvs["local"]
    for i, want in ldrv.answers.items():
        got = mdrv.answers[i]
        assert (got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)) \
            if isinstance(want, dict) else np.array_equal(got, want), f"mesh op {i}"
    assert mdrv.slot_log == ldrv.slot_log and mfolds == lfolds and mrows == lrows, \
        "meshed and local engines differ in slot tables, folds or telemetry"
    cross = sum(a != b for a, b in folds)
    assert cross > 0, "no fold crossed shards"
    out.update({"tenants": len(lengths), "ops": len(ops), "folds": len(folds),
                "cross_shard_folds": cross, "answers_equal_local": True})

    # HHD on the meshed engine: cms_update once a shard an engine-wide step
    cspec = hhd.make_spec(4, 1024, 16)
    clen = [MESH_HHD_TUPLES * (1 + t % 2) - int(rng.integers(0, CHUNK))
            for t in range(MESH_HHD_TENANTS)]
    cstreams = [zipf_tuples(n, 1 << 20, 3.0, seed=SEED + 900 + t) for t, n in enumerate(clen)]
    cops = session_script(clen, rng, storm=MESH_HHD_TENANTS, wave_a=0, slots=primary)
    ceng = SessionEngine(cspec, device=dev, mesh=mesh, obs=False, **kw)
    ceng.warmup(dtype=np.int32, feat_shape=(2,))
    cdrv = ScriptRunner(cops, cstreams, lambda k: hhd.oracle(k, 4, 1024, 16), primary)
    run_s = counted(ceng, cdrv, "cms_update")
    out["hhd"] = {"tenants": MESH_HHD_TENANTS, "run_s": run_s, "oracle_exact": True,
                  "launches": mesh_launches(ceng), "grants_max": max(cdrv.granted, default=0)}
    del ceng, cdrv, cstreams

    # (d) durable and meshed, crashed two thirds through, recovered twice
    ddir = REPO / "build" / "phase14_durable"
    ldir = REPO / "build" / "phase14_durable_local"
    for d in (ddir, ldir):
        shutil.rmtree(d, ignore_errors=True)
    bobs = obs_lib.Observability()
    deng = DurableSessionEngine(hspec, directory=ddir, checkpoint_every=4, keep=3,
                                wal_sync=False, device=dev, mesh=mesh, obs=bobs, **kw)
    deng.warmup(dtype=np.int32, feat_shape=(2,))
    ddrv = ScriptRunner(ops, streams, horacle, primary, full_check=False)
    pre_s = counted(deng, ddrv, "route_accumulate", stop=crash_at)
    deng._mgr.wait()
    crashed = deng
    records = sum(v for n, _, v in obs_lib.parse_prometheus(bobs.registry.prometheus_text())
                  if n == "wal_records_total")
    shutil.copytree(ddir, ldir)
    durable = {"ops_before_crash": crash_at, "run_s_before_crash": pre_s,
               "records_logged_before_crash": records}
    for target, d, m in (("mesh", ddir, mesh), ("local", ldir, None)):
        drv = copy.deepcopy(ddrv)
        t0 = time.perf_counter()
        reng = SessionEngine.recover(hspec, d, mesh=m, device=dev,
                                     obs=obs_lib.Observability())
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        info = reng.recovery_info
        assert info["checkpoint_step"] is not None, info
        assert info["replayed_records"] < records and info["replay_anomalies"] == 0, info
        assert engine_state(reng) == mdrv.marked, f"recovered onto {target}: differs at the crash"
        post_s = counted(reng, drv, "route_accumulate")
        for i, want in mdrv.answers.items():
            got = drv.answers[i]
            assert (got.keys() == want.keys() and all(np.array_equal(got[k], want[k])
                                                      for k in got)) \
                if isinstance(want, dict) else np.array_equal(got, want), \
                f"recovered onto {target}: op {i}"
        durable[target] = {"recover_s": recover_s, "recovery": info, "run_s_after": post_s,
                           "answers_equal_uninterrupted": True}
        reng.shutdown()
    crashed.shutdown()
    for d in (ddir, ldir):
        shutil.rmtree(d, ignore_errors=True)
    out["durable"] = durable
    return out, launches


LM_KERNELS = ("onehot_dispatch", "onehot_combine", "flash_attention")


def lm_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_onehot import onehot_combine, onehot_dispatch
    return {"onehot_dispatch": onehot_dispatch.launches,
            "onehot_combine": onehot_combine.launches,
            "flash_attention": flash_attention.launches}


def reset_counts():
    """Every kernel's launch count to 0."""
    from repro_torch.kernels.cms_update import cms_update
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.moe_onehot import onehot_combine, onehot_dispatch
    from repro_torch.kernels.route_accumulate import route_accumulate
    for kernel in (route_accumulate, cms_update, onehot_dispatch, onehot_combine,
                   flash_attention, flash_attention_bwd):
        kernel.launches = 0


def check_lm_kernels(dev) -> dict:
    """Phase A: the three LM kernels against their plain versions on the
    same CUDA tensors.  Pack/unpack must be bit-exact on unique cells (one
    add onto zero; the gate product rounds once in both).  Where duplicate
    cells sum, the partial sums round in another order, so each cell's
    error is held to tol * (1 + the sum of |x| that went into it), tol 1e-5
    (float32) or 2e-2 (bfloat16).  Flash: rtol = atol = 1e-5 (float32) or
    2e-2 (bfloat16), as in tests/test_kernels.py."""
    from repro_torch.kernels import dispatch, ops, ref
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = dict.fromkeys(LM_KERNELS, 0.0)
    floats = ((torch.float32, 1e-5), (torch.bfloat16, 2e-2))

    def compare(name, got, want, tol, magnitude=None):
        """Bit-exact for tol 0, else |got - want| <= tol * (1 + magnitude)
        element by element; magnitude defaults to |want|."""
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        diff = (got.double() - want.double()).abs()
        err[name] = max(err[name], float(diff.max()))
        if not tol:
            assert torch.equal(got, want), f"{name}: max |err| {err[name]}"
            return
        mag = want.double().abs() if magnitude is None else magnitude.double()
        assert bool((diff <= tol * (1 + mag)).all()), f"{name}: max |err| {err[name]}"

    pe, d = 72, 2048                 # 64 experts + X = 8 slots, d_model
    # prefill, decode at 4 slots, decode at 64 slots (many past capacity)
    for g, t, cap in ((8, 3072, 60), (1, 24, 4), (1, 384, 7)):
        eff = torch.from_numpy(rng.integers(0, pe, (g, t)).astype(np.int32)).to(dev)
        drop = torch.from_numpy(rng.random((g, t))).to(dev)
        for unique in (True, False):
            slot = (ops.occurrence_rank(eff, pe) if unique else torch.from_numpy(
                rng.integers(0, cap, (g, t)).astype(np.int32)).to(dev))
            e = torch.where(drop < 0.02, -1, torch.where(drop < 0.04, pe, eff))
            s = torch.where((drop >= 0.04) & (drop < 0.06), cap + 2, slot)
            e, s = e.to(torch.int32), s.to(torch.int32)
            for dtype, tol in floats:
                x = torch.randn((g, t, d), generator=gen, device=dev).to(dtype)
                compare("onehot_dispatch", dispatch.onehot_dispatch(e, s, x, pe, cap),
                        ref.onehot_dispatch(e, s, x, pe, cap), 0 if unique else tol,
                        ref.onehot_dispatch(e, s, x.float().abs(), pe, cap))
                packed = torch.randn((g, pe, cap, d), generator=gen, device=dev).to(dtype)
                gate = torch.rand((g, t), generator=gen, device=dev).to(dtype)
                for gt in (gate, None):
                    compare("onehot_combine", dispatch.onehot_combine(e, s, packed, gt),
                            ref.onehot_combine(e, s, packed, gt), 0)
    # (S, KV heads, dh, window, q scale) at B = 4, H = 16: the prefill shape
    # and its variants, other head dims, one query, and a moving running max
    flash = [(sl, kvh, 128, window, 1) for sl in (1024, 1000) for kvh in (16, 4)
             for window in (0, 256)]
    flash += [(1024, 16, 64, 0, 1), (1024, 16, 256, 0, 1), (1, 16, 128, 0, 1),
              (1024, 16, 128, 0, 8)]
    for sl, kvh, dh, window, q_scale in flash:
        for dtype, tol in floats:
            q = (q_scale * torch.randn((4, sl, 16, dh), generator=gen, device=dev)).to(dtype)
            k, v = (torch.randn((4, sl, kvh, dh), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            compare("flash_attention",
                    dispatch.flash_attention(q, k, v, causal=True, window=window),
                    ref.flash_attention(q, k, v, causal=True, window=window), tol)
    return err


def load_engine(model, params, dev):
    """A DecodeEngine at serving load: LOAD_SLOTS slots, each holding a
    request whose context (LOAD_CONTEXT tokens, seeded) is already in the KV
    cache.  The cache holds seeded random K/V in place of the prompts' own:
    the engine admits one decode step per prompt token (as the JAX engine
    does), which at these lengths would outlast the whole script.  A decode
    step's work does not depend on the cached values."""
    from repro_torch.serve.engine import DecodeEngine, Request
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 2)
    vocab = model.cfg.vocab
    engine = DecodeEngine(model, params, slots=LOAD_SLOTS, max_len=LOAD_MAX_LEN)
    for kv in engine.cache.values():
        for t in kv:
            t.normal_(generator=gen)
    lens = rng.integers(*LOAD_CONTEXT, LOAD_SLOTS).astype(np.int32)
    first = rng.integers(0, vocab, LOAD_SLOTS).astype(np.int32)
    for i, n in enumerate(lens):
        req = Request(1000 + i, rng.integers(0, vocab, n).astype(np.int32), LOAD_MAX_LEN)
        req.out.append(int(first[i]))       # the token admission returns
        engine.slot_req[i] = req
    engine.slot_len[:] = lens
    engine.tokens.copy_(torch.as_tensor(first, device=dev))
    return engine


def decode_load(engine) -> dict:
    """Decode at serving load: two warm steps of ``load_engine``'s engine,
    then LOAD_STEPS timed steps with every slot busy; ms a step and
    tokens/s."""
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOAD_STEPS):
        assert engine.step() == LOAD_SLOTS
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    contexts = engine.slot_len - 2 - LOAD_STEPS
    return {"slots": LOAD_SLOTS, "max_len": LOAD_MAX_LEN, "steps": LOAD_STEPS,
            "context_min": int(contexts.min()), "context_max": int(contexts.max()),
            "context_mean": float(contexts.mean()), "s": load_s,
            "ms_per_step": 1e3 * load_s / LOAD_STEPS,
            "tokens_per_s": LOAD_SLOTS * LOAD_STEPS / load_s}


def cli_requests(vocab: int) -> list:
    """The requests of repro_torch.launch.serve's run: 8, prompts of 4-16
    tokens (its seed, 0), 16 new tokens each."""
    from repro_torch.serve.engine import Request
    prompts = np.random.default_rng(0)
    requests = []
    for rid in range(8):
        plen = int(prompts.integers(4, 17))
        requests.append(Request(rid, prompts.integers(0, vocab, size=plen)
                                .astype(np.int32), 16))
    return requests


def serve_smoke(model, params, requests) -> dict:
    """The serve CLI's run: a DecodeEngine of SMOKE_SLOTS slots over
    ``requests`` until every one is done (admission, continuous batching,
    exit); every request must return 16 tokens."""
    from repro_torch.serve.engine import DecodeEngine
    engine = DecodeEngine(model, params, slots=SMOKE_SLOTS, max_len=SMOKE_MAX_LEN)
    for req in requests:
        engine.submit(req)
    t0 = time.perf_counter()
    ticks = 0
    while engine.queue or any(r is not None for r in engine.slot_req):
        engine.step()
        ticks += 1
    torch.cuda.synchronize()
    smoke_s = time.perf_counter() - t0
    assert all(len(r.out) == 16 and r.done for r in requests), \
        [len(r.out) for r in requests]
    return {"requests": len(requests), "new_tokens": 16 * len(requests),
            "prompt_tokens": int(sum(len(r.prompt) for r in requests)),
            "slots": SMOKE_SLOTS, "max_len": SMOKE_MAX_LEN, "engine_ticks": ticks,
            "s": smoke_s}


def lm_path(dev):
    """Phase B: the MoE LM's inference entry points at full width.  Returns
    the record, the main path's launch counts, the model, its weights, the
    prefill tokens and the serving-load engine."""
    from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG
    from repro_torch.models import zoo
    cfg = dataclasses.replace(CONFIG, num_layers=LM_LAYERS)
    model = zoo.build(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init_params(model.generator(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calls = [0]

    def decode_fn(p, batch):
        calls[0] += 1
        return model.decode_fn(p, batch)

    counted = dataclasses.replace(model, decode_fn=decode_fn)
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, PREFILL_SHAPE), device=dev)
    requests = cli_requests(cfg.vocab)

    torch.cuda.synchronize()
    reset_counts()                        # ---- the main path from here
    t0 = time.perf_counter()
    logits = counted.prefill_fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    first_prefill_s = time.perf_counter() - t0
    after_prefill = lm_counts()
    # a smoke of the serve CLI's run: admission, continuous batching, exit
    smoke = serve_smoke(counted, params, requests)
    smoke["decode_fn_calls"] = calls[0]
    # decode at serving load: LOAD_SLOTS busy slots with long contexts
    engine = load_engine(counted, params, dev)
    load = decode_load(engine)
    lens = torch.as_tensor(engine.slot_len, device=dev)
    load_logits, _ = counted.decode_fn(params, {"tokens": engine.tokens[:, None],
                                                "cache": engine.cache, "cache_len": lens})
    torch.cuda.synchronize()
    counts = lm_counts()                  # ---- to here
    assert not any(pe_counts().values()), pe_counts()

    assert logits.shape == (*PREFILL_SHAPE, cfg.vocab) and logits.dtype == cfg.cdtype
    assert bool(torch.isfinite(logits).all()), "prefill logits are not finite"
    assert after_prefill == dict.fromkeys(LM_KERNELS, LM_LAYERS), after_prefill
    assert load_logits.shape == (LOAD_SLOTS, 1, cfg.vocab)
    assert bool(torch.isfinite(load_logits).all()), "decode logits are not finite"
    assert all(len(r.out) == 3 + LOAD_STEPS and not r.done
               for r in engine.slot_req), "a serving-load slot lost a token"
    for name in ("onehot_dispatch", "onehot_combine"):
        assert counts[name] == LM_LAYERS * (1 + calls[0]), (name, counts, calls)
    assert counts["flash_attention"] == LM_LAYERS, counts
    del logits, load_logits
    steady = [host_ms(lambda: model.prefill_fn(params, {"tokens": tokens}), calls=3)]
    n_tok = PREFILL_SHAPE[0] * PREFILL_SHAPE[1]
    rec = {"arch": cfg.name, "layers": LM_LAYERS, "params_init_s": init_s,
           "prefill_tokens": list(PREFILL_SHAPE), "first_prefill_s": first_prefill_s,
           "prefill_ms_per_forward": steady[0],
           "prefill_tokens_per_s": n_tok / (steady[0] * 1e-3),
           "decode_load": load,
           "serve_smoke": smoke,
           "decode_fn_calls": calls[0], "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    return rec, counts, model, params, tokens, engine


def profile_lm(model, params, tokens, engine, decode_steps: int = 8) -> dict:
    """Where a prefill forward and a decode step at serving load spend the
    card's time: torch.profiler over one prefill_fn call and over
    ``decode_steps`` steps of the serving-load engine, against the wall time
    under the profiler (which stretches the host side, so the busy share is
    a lower bound); the top kernels, and the top aten ops by the card time
    of the kernels each launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def prefill():
        model.prefill_fn(params, {"tokens": tokens})

    def per_call(rows, calls, width=80) -> dict:
        """ms a call of each row, rows whose names agree in their first
        ``width`` characters summed."""
        out = {}
        for e in rows:
            out[e.key[:width]] = out.get(e.key[:width], 0.0) + 1e-3 * e.self_device_time_total / calls
        return out

    out = {}
    for name, fn, calls in (("prefill", prefill, 1), ("decode_step", engine.step, decode_steps)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        ops = [e for e in events
               if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
        top_ops = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
        out[name] = {
            "calls": calls, "wall_ms_per_call_profiled": 1e3 * wall_s / calls,
            "device_ms_per_call": 1e-3 * device_us / calls,
            "busy_share_profiled": device_us * 1e-6 / wall_s,
            "kernels_per_call": sum(e.count for e in kernels) / calls,
            "host_aten_ops_per_call": sum(
                e.count for e in events if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::")) / calls,
            "flash_attention_ms_per_call": 1e-3 * sum(
                e.self_device_time_total for e in kernels if "flash_" in e.key) / calls,
            "top_kernels_ms_per_call": per_call(top, calls),
            "top_ops_device_ms_per_call": per_call(top_ops, calls)}
    out["decode_step"]["slots"] = LOAD_SLOTS
    return out


def first_periods(params, n: int) -> dict:
    """``params`` with every block leaf cut to its first ``n`` periods
    (views; the other leaves as they are)."""
    first = lambda tree: ({k: first(v) for k, v in tree.items()}
                          if isinstance(tree, dict) else tree[:n])
    return {k: first(v) if k == "blocks" else v for k, v in params.items()}


def lm_cpu_parity(dev, params_deep, config=None, n_tokens: int = 64,
                  layers: int = 2) -> dict:
    """Phase C (and E (e), (k)): full width, ``layers`` layers (default 2),
    compute float32 with TF32 off; the weights are the first periods of
    ``params_deep`` (float32, a deeper run's of ``config``, default
    moonshot's), copied to the CPU.  Prefill logits on [1, n_tokens] (with
    the VLM's seeded patches in front) within rtol = atol = 1e-3 (float32
    sums in another order over d_model and the vocabulary) and identical
    greedy tokens of a 2-request DecodeEngine."""
    from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG
    from repro_torch.models import frontends, zoo
    from repro_torch.models.transformer import tree_to
    from repro_torch.serve.engine import DecodeEngine, Request
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(config or CONFIG, num_layers=layers, compute_dtype="float32")
    gpu_params = first_periods(params_deep, cfg.num_periods)
    t0 = time.perf_counter()
    cpu_params = tree_to(gpu_params, torch.device("cpu"))
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, cfg.vocab, (1, n_tokens))
    patches = (frontends.random_patches(cfg, torch.Generator().manual_seed(SEED), 1)
               if cfg.num_patches else None)
    prompts = [rng.integers(0, cfg.vocab, 4).astype(np.int32) for _ in range(2)]
    outs = []
    for where, params in ((dev, gpu_params), (torch.device("cpu"), cpu_params)):
        model = zoo.build(cfg, device=where)
        batch = {"tokens": torch.as_tensor(tokens, device=where)}
        if patches is not None:
            batch["patches"] = patches.to(where)
        logits = model.prefill_fn(params, batch)
        engine = DecodeEngine(model, params, slots=2, max_len=16)
        reqs = [Request(i, p, 4) for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run()
        outs.append((logits.cpu(), [r.out for r in reqs]))
    (l_gpu, t_gpu), (l_cpu, t_cpu) = outs
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-3, atol=1e-3)
    assert t_gpu == t_cpu, (t_gpu, t_cpu)
    return {"arch": cfg.name, "layers": layers, "compute_dtype": "float32",
            "prefill_tokens": [1, n_tokens], "patches": cfg.num_patches,
            "max_abs_logit_diff": float((l_gpu - l_cpu).abs().max()),
            "greedy_tokens": t_gpu, "host_s": time.perf_counter() - t0}


def library_dispatch(eff, slot, xin, num_pe, cap):
    """onehot_dispatch's library yardstick: zero_() then
    index_put_(accumulate=True) of the kept rows at their flat cells, both
    precomputed; and the kept row count."""
    g, _, d = xin.shape
    keep = (eff >= 0) & (eff < num_pe) & (slot >= 0) & (slot < cap)
    cells = (torch.arange(g, device=xin.device)[:, None] * (num_pe * cap)
             + eff.long() * cap + slot.long())[keep]
    rows = xin[keep]
    buf = torch.zeros((g * num_pe * cap, d), dtype=xin.dtype, device=xin.device)
    return lambda: buf.zero_().index_put_((cells,), rows, accumulate=True), int(keep.sum())


def lm_kernel_times(dev, model, params, tokens, counts, max_err) -> list:
    """Phase D: each LM kernel on the inputs that the first layer of a
    prefill run hands it (captured in passing), its plain version and one
    library call, beside its bound from this run's data."""
    from repro_torch.kernels import dispatch, ref

    def first_inputs(call, names) -> dict:
        """The arguments of the first call of each named dispatch entry
        point that ``call`` makes."""
        seen = {}
        originals = {n: getattr(dispatch, n) for n in names}

        def capture(name):
            def fn(*args, **kwargs):
                seen.setdefault(name, (args, kwargs))
                return originals[name](*args, **kwargs)
            return fn

        for n in names:
            setattr(dispatch, n, capture(n))
        try:
            call()
        finally:
            for n in names:
                setattr(dispatch, n, originals[n])
        torch.cuda.synchronize()
        return seen

    seen = first_inputs(lambda: model.prefill_fn(params, {"tokens": tokens}), LM_KERNELS)
    # a decode step at serving load: one token for each of LOAD_SLOTS slots
    cache = model.init_cache(params, LOAD_SLOTS, 16)
    step = {"tokens": tokens.reshape(-1)[:LOAD_SLOTS, None], "cache": cache, "cache_len": 0}
    (eff_d, slot_d, x_d, pe_d, cap_d), _ = first_inputs(
        lambda: model.decode_fn(params, step), ("onehot_dispatch",))["onehot_dispatch"]
    del cache, step
    # slots are occurrence ranks, so every kept cell is unique: bit-exact
    assert torch.equal(dispatch.onehot_dispatch(eff_d, slot_d, x_d, pe_d, cap_d),
                       ref.onehot_dispatch(eff_d, slot_d, x_d, pe_d, cap_d)), \
        "onehot_dispatch differs from its plain version at the decode-at-load shape"
    out = []

    # a call is the head-map memset, the link kernel and the fill kernel
    kernels_of_call = ("dispatch_link_kernel", "dispatch_fill_kernel", "Memset")
    (eff, slot, xin, num_pe, cap), _ = seen["onehot_dispatch"]
    g, t, d = xin.shape
    es = xin.element_size()
    library, kept = library_dispatch(eff, slot, xin, num_pe, cap)
    fn = lambda: dispatch.onehot_dispatch(eff, slot, xin, num_pe, cap)
    turns = cuda_ms_turns({"kernel": fn, "library": library}, iters=50)
    b_ms, b_by = bound_ms(g * t * 8 + kept * d * es + g * num_pe * cap * d * es, kept * d)
    library_d, kept_d = library_dispatch(eff_d, slot_d, x_d, pe_d, cap_d)
    fn_d = lambda: dispatch.onehot_dispatch(eff_d, slot_d, x_d, pe_d, cap_d)
    turns_d = cuda_ms_turns({"kernel": fn_d, "library": library_d})
    out.append({
        "name": "onehot_dispatch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_onehot.cu",
        "replaces": "src/repro/kernels/moe_onehot.py:74",
        "launches": counts["onehot_dispatch"], "max_abs_err": max_err["onehot_dispatch"],
        "ms": turns["kernel"],
        "device_ms": device_ms(fn, kernels_of_call, calls=50, per_call=3),
        "plain_ms": cuda_ms(lambda: ref.onehot_dispatch(eff, slot, xin, num_pe, cap), iters=20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": turns["library"],
        "ms_decode": turns_d["kernel"],
        "device_ms_decode": device_ms(fn_d, kernels_of_call, per_call=3),
        "library_ms_decode": turns_d["library"],
        "shape": f"prefill layer 0: G={g} T={t} -> [{g}, {num_pe}, {cap}, {d}] "
                 f"{str(xin.dtype).removeprefix('torch.')}, {kept} rows kept; *_decode: "
                 f"decode layer 0 at {LOAD_SLOTS} slots: G={x_d.shape[0]} T={x_d.shape[1]} "
                 f"-> [{x_d.shape[0]}, {pe_d}, {cap_d}, {x_d.shape[2]}], {kept_d} rows kept",
        "library_call": "zero_() then index_put_(accumulate=True) on precomputed "
                        "flat cells; ms and library_ms timed in turns"})
    out[-1]["kernel_ms"] = out[-1]["ms"]

    (eff, slot, packed, gate), _ = seen["onehot_combine"]
    g, num_pe, cap, d = packed.shape
    t = eff.shape[1]
    es = packed.element_size()
    keep = (eff >= 0) & (eff < num_pe) & (slot >= 0) & (slot < cap)
    flat = (torch.arange(g, device=dev)[:, None] * (num_pe * cap)
            + eff.long() * cap + slot.long())
    used = int(torch.unique(flat[keep]).numel())
    flat = torch.where(keep, flat, 0).reshape(-1)
    packed_rows = packed.view(-1, d)
    gate_col = gate.reshape(-1, 1)
    fn = lambda: dispatch.onehot_combine(eff, slot, packed, gate)
    b_ms, b_by = bound_ms(g * t * (8 + es) + used * d * es + g * t * d * es, g * t * d)
    out.append({
        "name": "onehot_combine", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_onehot.cu",
        "replaces": "src/repro/kernels/moe_onehot.py:105",
        "launches": counts["onehot_combine"], "max_abs_err": max_err["onehot_combine"],
        "ms": cuda_ms(fn, iters=50),
        "device_ms": device_ms(fn, "combine_kernel", calls=50),
        "plain_ms": cuda_ms(lambda: ref.onehot_combine(eff, slot, packed, gate), iters=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: packed_rows.index_select(0, flat) * gate_col, iters=50),
        "shape": f"prefill layer 0: [{g}, {num_pe}, {cap}, {d}] -> G={g} T={t} "
                 f"{str(packed.dtype).removeprefix('torch.')}, {used} cells read",
        "library_call": "index_select then * gate on precomputed flat cells"})
    out[-1]["kernel_ms"] = out[-1]["ms"]

    (q, k, v), kw = seen["flash_attention"]
    assert kw["causal"] and not kw["window"] and not kw["softcap"], kw
    kw = {"causal": True, "window": 0}
    b, sq, h, dh = q.shape
    pairs = flash_pairs(b, h, sq, k.shape[1], True, 0)
    fn = lambda: dispatch.flash_attention(q, k, v, **kw)
    b_ms, b_by = flash_bound(q, k, v, True, 0, 0.0)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    q32, k32, v32 = (x.float() for x in (q, k, v))
    fn32 = lambda: dispatch.flash_attention(q32, k32, v32, **kw)
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": counts["flash_attention"], "max_abs_err": max_err["flash_attention"],
        "ms": cuda_ms(fn, iters=50),
        "device_ms": device_ms(fn, "flash_bf16_kernel", calls=50),
        "ms_float32": cuda_ms(fn32, iters=10),
        "device_ms_float32": device_ms(fn32, "flash_kernel", calls=10),
        "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v, **kw), iters=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=20),
        "shape": f"prefill layer 0: B={b} S={sq} H={h} KV={k.shape[2]} dh={dh} causal "
                 f"{str(q.dtype).removeprefix('torch.')}, {pairs} (q, k) pairs; "
                 "ms_float32 on float32 copies (CUDA cores)",
        "library_call": "F.scaled_dot_product_attention(is_causal=True)"})
    out[-1]["kernel_ms"] = out[-1]["ms"]
    return out



# ---------------------------------------------------------------- phase E

# (name, B, S, H, KV, dh, window, cap, q scale): gemma2's prefill shape with
# its cap of 50; one sequence long enough that the local layers' window of
# 4096 masks; a window of 256; q x 8 (the running max moves); MLA's prefill
# (qk dim 192, V padded to it, no cap); Jamba's attention layer (GQA 64/8)
# and phi-3's MHA over 1024 patches + 1024 tokens (dh 96 in the 128 template)
E_FLASH = (("gemma2", 4, 1024, 8, 4, 256, 0, 50.0, 1),
           ("gemma2_window4096", 1, 5120, 8, 4, 256, 4096, 50.0, 1),
           ("gemma2_window256", 4, 1024, 8, 4, 256, 256, 50.0, 1),
           ("gemma2_q_x8", 4, 1024, 8, 4, 256, 0, 50.0, 8),
           ("mla", 4, 1024, 16, 16, 192, 0, 0.0, 1),
           ("jamba", 1, 1024, 64, 8, 128, 0, 0.0, 1),
           ("phi3", 1, 2048, 32, 32, 96, 0, 0.0, 1))
# (arch, layers run, prefill shapes, other fields cut); None = all of the
# config's layers, nothing cut.  Float32 weights: deepseek ~2.34 GB a layer
# (27 ~64 GB leave no room for the placed copies; it runs 4, its phase took
# 32 s at 8 with the script at 593 s of 600), gemma2 ~10.5 GB in all,
# llama3.2-3b ~12.9 GB, starcoder2-15b ~1.5 GB a layer (40 ~63 GB),
# mamba2-780m ~3.1 GB, phi-3-vision ~14.9 GB.  yi-6b runs 8 of its 32
# layers: at full depth the script passed 600 s (the serve run's decode
# steps are host-bound, ~0.2 s a layer).  llama3.2-3b's serve run is the
# CLI's own (serve_cli_default).  Jamba runs one 8-layer period (the
# config allows whole periods only) with 4 of its 16 experts in bfloat16,
# ~15.6 B parameters, 31 GB: 16 experts in bfloat16 make a period 89 GB,
# 4 in float32 62.6 GB before the MoE's gathered slot weights (~1.2 GB a
# slot); top-2 and the 4 secondary slots are kept.
E_CONFIGS = (("deepseek-v2-lite-16b", 4, ((4, 1024),), None),
             ("gemma2-2b", None, ((4, 1024), (1, 5120)), None),
             ("llama3.2-3b", None, ((1, 1024),), None),
             ("yi-6b", 8, ((1, 1024),), None),
             ("starcoder2-15b", 8, ((1, 1024),), None),
             ("mamba2-780m", None, ((4, 1024), (1, 8192)), None),
             ("jamba-1.5-large-398b", 8, ((1, 1024),),
              {"num_experts": 4, "param_dtype": "bfloat16"}),
             ("phi-3-vision-4.2b", None, ((1, 1024),), None))
E_SSM_ARCH = "mamba2-780m"            # decode at load, profile, admission reset
E_CLI_ARCH = "llama3.2-3b"            # repro_torch.launch.serve's default
E_PARITY_TOKENS = 256


def check_flash_softcap(dev) -> dict:
    """Phase E (a): the soft-capped flash kernel (and MLA's head dim)
    against its plain version on CUDA tensors, bf16 and float32, one launch
    each; rtol = atol = 1e-5 (float32) or 2e-2 (bfloat16), as phase A.  The
    causal first row reads key 0 alone: its output must be v's row 0, which
    a masked sentinel turned into -cap by the cap would spoil."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {}
    for name, b, sl, h, kvh, dh, window, cap, q_scale in E_FLASH:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            q = (q_scale * torch.randn((b, sl, h, dh), generator=gen, device=dev)).to(dtype)
            k, v = (torch.randn((b, sl, kvh, dh), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            before = flash_attention.launches
            got = dispatch.flash_attention(q, k, v, causal=True, window=window, softcap=cap)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1, name
            want = ref.flash_attention(q, k, v, causal=True, window=window, softcap=cap)
            first = v[:, :1].repeat_interleave(h // kvh, dim=2)
            for what, g, w in (("", got, want), ("_first_row", got[:, :1], first)):
                diff = (g.double() - w.double()).abs()
                key = f"{name}{what}_{str(dtype).removeprefix('torch.')}"
                err[key] = float(diff.max())
                assert bool((diff <= tol * (1 + w.double().abs())).all()), \
                    f"flash_attention {key}: max |err| {err[key]}"
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return err


def layer_counts(cfg) -> tuple[int, int]:
    """(attention layers, MoE layers) of ``cfg``: the flash kernel runs once
    an attention (or MLA) layer a prefill, the MoE pack and unpack once an
    MoE layer a call; a mamba layer runs no kernel."""
    attn = sum(k != "mamba" for k in cfg.block_pattern) * cfg.num_periods
    moe = sum(k == "moe" for k in cfg.ffn_pattern) * cfg.num_periods
    return attn, moe


def prefill_batch(cfg, shape, dev, seed: int = SEED) -> dict:
    """Seeded tokens of ``shape`` and, for the VLM, seeded patch embeddings
    of the stub frontend ([B, num_patches, patch_embed_dim], JAX's layout)."""
    from repro_torch.models import frontends
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, shape), device=dev)}
    if cfg.num_patches:
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch["patches"] = frontends.random_patches(cfg, gen, shape[0])
    return batch


def lm_config_path(dev, arch: str, layers, prefill_shapes, serve: bool = True,
                   changes=None) -> tuple[dict, dict, object, dict]:
    """Phase E (b)-(d), (h)-(j): one config at full width (depth cut to
    ``layers``, other fields replaced by ``changes``), seeded random
    weights.  The main path, counted from 0: prefill_fn on each of
    ``prefill_shapes`` (with the VLM's patches; finite logits over every
    position; flash_attention once an attention layer, the MoE pack and
    unpack once an MoE layer) and, with ``serve``, the serve CLI's run
    (every request returns 16 tokens; pack and unpack once an MoE layer a
    decode_fn call).  Then prefill tokens/s at each shape (patches
    included).  Returns the record, the launch counts, the model and its
    weights."""
    from repro_torch.configs import get
    from repro_torch.models import zoo
    full = get(arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers,
                              **(changes or {}))
    model = zoo.build(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(model.generator(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calls = [0]

    def decode_fn(p, batch):
        calls[0] += 1
        return model.decode_fn(p, batch)

    counted = dataclasses.replace(model, decode_fn=decode_fn)
    batches = [prefill_batch(cfg, shape, dev) for shape in prefill_shapes]
    attn, moe = layer_counts(cfg)

    torch.cuda.synchronize()
    reset_counts()                        # ---- the main path from here
    first_s = []
    for batch in batches:
        t0 = time.perf_counter()
        logits = counted.prefill_fn(params, batch)
        torch.cuda.synchronize()
        first_s.append(time.perf_counter() - t0)
        b, s = batch["tokens"].shape
        assert logits.shape == (b, cfg.num_patches + s, cfg.vocab), logits.shape
        assert logits.dtype == cfg.cdtype
        assert bool(torch.isfinite(logits).all()), f"{arch}: prefill logits are not finite"
        del logits
    after_prefill = lm_counts()
    if serve:
        smoke = serve_smoke(counted, params, cli_requests(cfg.vocab))
        smoke["decode_fn_calls"] = calls[0]
    counts = lm_counts()                  # ---- to here
    assert not any(pe_counts().values()), pe_counts()

    n = len(batches)
    assert after_prefill == {"flash_attention": n * attn, "onehot_dispatch": n * moe,
                             "onehot_combine": n * moe}, after_prefill
    for name in ("onehot_dispatch", "onehot_combine"):
        assert counts[name] == moe * (n + calls[0]), (name, counts, calls)
    assert counts["flash_attention"] == n * attn, counts
    prefill = []
    for batch, s in zip(batches, first_s):
        ms = host_ms(lambda: model.prefill_fn(params, batch), calls=3)
        b, sl = batch["tokens"].shape
        n_tok = b * (cfg.num_patches + sl)
        prefill.append({"tokens": [b, sl], "patches": cfg.num_patches, "first_s": s,
                        "ms_per_forward": ms, "tokens_per_s": n_tok / (ms * 1e-3)})
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "of_layers": full.num_layers,
           "params_init_s": init_s, "prefill": prefill,
           "serve_smoke": smoke if serve else None, "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if changes:
        rec["reduced"] = {k: [getattr(full, k), v] for k, v in changes.items()}
    return rec, counts, model, params


def placement_check(dev, model, params) -> dict:
    """Phase E (b): ``place_slot_weights`` at layer 0 with the plan that the
    live path derives from the same batch (the layer-0 FFN input of a
    [4, 1024] prefill): the placed moe_apply (pack and unpack at P = S_pad)
    equal to the live one within rtol = atol = 1e-3 (bf16)."""
    from repro_torch.core.scheduler import schedule_secpes
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.kernels.moe_onehot import onehot_dispatch
    cfg = model.cfg
    pp = T.take(params["blocks"], 0)
    tokens = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, PREFILL_SHAPE), device=dev)
    x = L.embed_lookup(params["embed"], tokens, cfg.cdtype)
    x = x + T._apply_mixer(cfg, cfg.block_pattern[0], pp["0.mixer"],
                           L.rmsnorm(pp["0.norm1"], x, cfg.norm_eps))
    h = L.rmsnorm(pp["0.norm2"], x, cfg.norm_eps)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor, num_secondary=cfg.ditto_secondary,
              act=cfg.act, compute_dtype=cfg.cdtype, group_size=cfg.moe_group_size)
    live, aux_live = MOE.moe_apply(pp["0.ffn"], h, **kw)
    probs = torch.softmax(h.reshape(-1, cfg.d_model).float() @ pp["0.ffn"]["router"], -1)
    ids = torch.topk(probs, cfg.top_k, dim=-1).indices
    hist = torch.bincount(ids.reshape(-1), minlength=cfg.num_experts).to(torch.int32)
    assignment = schedule_secpes(hist, cfg.ditto_secondary)
    placed = MOE.place_slot_weights(pp["0.ffn"], assignment, cfg.num_experts)
    slots = placed["up_slots"].shape[0]
    before = onehot_dispatch.launches
    got, aux = MOE.moe_apply(placed, h, **kw)
    torch.cuda.synchronize()
    assert onehot_dispatch.launches == before + 1
    torch.testing.assert_close(got, live, rtol=1e-3, atol=1e-3)
    assert float(aux["drop_frac"]) == float(aux_live["drop_frac"])
    rec = {"layer": 0, "tokens": list(PREFILL_SHAPE), "slots": slots,
           "assignment": assignment.tolist(),
           "max_abs_diff": float((got.float() - live.float()).abs().max()),
           "drop_frac": float(aux["drop_frac"]),
           "max_slot_load": int(aux["max_slot_load"]),
           "max_designated_load": int(aux["max_designated_load"])}
    del placed
    return rec


def serve_cli_default(dev, argv=("--full",)) -> dict:
    """Phase E (d): ``repro_torch.launch.serve.main(["--full"])``, the CLI
    at its default arch (llama3.2-3b) on the card, its output captured and
    its requests recorded: every one returns 16 tokens.  Phase F runs it
    at ``--arch whisper-base``.  The record names the arch the engine
    served."""
    import contextlib
    import io
    from repro_torch.launch import serve
    seen, archs = [], set()

    class Recording(serve.DecodeEngine):
        def submit(self, req):
            seen.append(req)
            archs.add(self.model.cfg.name)
            super().submit(req)

    out = io.StringIO()
    original = serve.DecodeEngine
    serve.DecodeEngine = Recording
    try:
        torch.cuda.synchronize()
        reset_counts()                    # ---- the main path from here
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            serve.main(list(argv))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = lm_counts()              # ---- to here
    finally:
        serve.DecodeEngine = original
    line = out.getvalue().strip()
    assert line.startswith("served 8 requests / 128 tokens"), line
    assert line.endswith(f"{SMOKE_SLOTS} slots, {dev.type})"), line
    assert len(seen) == 8 and all(len(r.out) == 16 and r.done for r in seen), \
        [len(r.out) for r in seen]
    assert not any(counts.values()), counts     # a dense decode step launches none
    (arch,) = archs
    return {"argv": list(argv), "arch": arch, "output": line, "wall_s": wall_s,
            "launches": counts}


def flash_times(dev) -> dict:
    """Phase E (f), (g): the flash kernel at gemma2's prefill shape with cap
    50 and cap 0, at MLA's, Jamba's and phi-3's (dh 96 in the 128
    template), each beside SDPA at the same shape with no cap
    (the only library yardstick: no library call soft-caps) and its bound;
    CUDA events, in turns."""
    from repro_torch.kernels import dispatch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, b, sl, h, kvh, dh, caps in (("gemma2", 4, 1024, 8, 4, 256, (50.0, 0.0)),
                                          ("mla", 4, 1024, 16, 16, 192, (0.0,)),
                                          ("jamba", 1, 1024, 64, 8, 128, (0.0,)),
                                          ("phi3", 1, 2048, 32, 32, 96, (0.0,))):
        q = torch.randn((b, sl, h, dh), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, sl, kvh, dh), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2) for x in (k, v))
        fns = {f"cap{cap:g}": (lambda c=cap: dispatch.flash_attention(q, k, v, softcap=c))
               for cap in caps}
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        turns = cuda_ms_turns(fns, iters=50)
        rec = {"shape": f"B={b} S={sl} H={h} KV={kvh} dh={dh} causal bfloat16",
               "library_ms": turns.pop("sdpa"),
               "library_call": "F.scaled_dot_product_attention(is_causal=True), "
                               "KV heads repeated outside the timing, no cap"}
        for key, ms in turns.items():
            cap = float(key.removeprefix("cap"))
            b_ms, b_by = flash_bound(q, k, v, True, 0, cap)
            rec[key] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
        out[name] = rec
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def admission_reset_check(dev, params_deep) -> dict:
    """Phase E (l): a 2-slot DecodeEngine on mamba2-780m's first 2 layers
    (full width, float32) serves 4 requests of 6 tokens, the last two in
    slots that the first two (and the empty slots' stale decodes) left
    state in.  Every admission's logits equal a fresh-cache prefill_cache's
    of the same prompt within rtol = atol = 1e-5."""
    from repro_torch.configs import get
    from repro_torch.models import zoo
    from repro_torch.serve import engine as E
    cfg = dataclasses.replace(get(E_SSM_ARCH), num_layers=2, compute_dtype="float32")
    model = zoo.build(cfg, device=dev)
    params = first_periods(params_deep, cfg.num_periods)
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab, 6).astype(np.int32) for _ in range(4)]
    seen = []
    real = E.prefill_cache

    def recording(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        seen.append(logits[0])
        return logits, cache

    eng = E.DecodeEngine(model, params, slots=2, max_len=32)
    for i, p in enumerate(prompts):
        eng.submit(E.Request(i, p, 8))
    E.prefill_cache = recording
    try:
        eng.run()
    finally:
        E.prefill_cache = real
    assert len(seen) == 4, len(seen)
    diffs = []
    for got, p in zip(seen, prompts):
        fresh, _ = real(model, params, torch.as_tensor(p, device=dev)[None],
                        model.init_cache(None, 1, 32))
        torch.testing.assert_close(got, fresh[0], rtol=1e-5, atol=1e-5)
        diffs.append(float((got - fresh[0]).abs().max()))
    return {"arch": cfg.name, "layers": 2, "slots": 2, "requests": 4,
            "max_abs_logit_diff_per_admission": diffs}


def lm_configs_path(dev) -> tuple[dict, dict]:
    """Phase E: the slice's other configs on the card, one model at a time.
    Returns the lm_configs record and the main paths' launch counts,
    summed."""
    from repro_torch.configs import get, get_reduced
    from repro_torch.models import zoo
    from repro_torch.models.transformer import tree_to
    total = dict.fromkeys(LM_KERNELS, 0)
    rec = {"flash_check_max_abs_err": check_flash_softcap(dev), "configs": []}
    for arch, layers, shapes, changes in E_CONFIGS:
        t0 = time.perf_counter()
        one, counts, model, params = lm_config_path(dev, arch, layers, shapes,
                                                    serve=arch != E_CLI_ARCH,
                                                    changes=changes)
        if arch == E_SSM_ARCH:
            # decode at load: O(1) state a slot, whatever the context; then
            # where a prefill and a serving-load step spend the card's time
            reset_counts()                # ---- the main path from here
            engine = load_engine(model, params, dev)
            one["decode_load"] = decode_load(engine)
            load_counts = lm_counts()     # ---- to here
            assert not any(load_counts.values()), load_counts   # the SSD runs no kernel
            tokens = prefill_batch(model.cfg, shapes[0], dev)["tokens"]
            one["profile"] = profile_lm(model, params, tokens, engine, decode_steps=2)
            del engine
            torch.cuda.empty_cache()
            one["admission_reset"] = admission_reset_check(dev, params)
        for k, c in counts.items():
            total[k] += c
        if arch == "deepseek-v2-lite-16b":
            one["placement"] = placement_check(dev, model, params)
        if arch in ("deepseek-v2-lite-16b", "gemma2-2b", E_SSM_ARCH, "phi-3-vision-4.2b"):
            one["cpu_parity"] = lm_cpu_parity(dev, params, get(arch), E_PARITY_TOKENS)
        del model, params
        torch.cuda.empty_cache()
        if arch == "jamba-1.5-large-398b":
            # full width in float32 does not fit: the REDUCED hybrid (one
            # period: mamba, attention, dense and MoE layers) on both
            cfg = get_reduced(arch)
            cpu_model = zoo.build(cfg, device="cpu")
            reduced = cpu_model.init_params(cpu_model.generator(SEED))
            one["cpu_parity"] = lm_cpu_parity(dev, tree_to(reduced, dev), cfg,
                                              E_PARITY_TOKENS, layers=cfg.num_layers)
        if arch == E_CLI_ARCH:
            one["serve_cli"] = serve_cli_default(dev)
            torch.cuda.empty_cache()
        one["phase_s"] = time.perf_counter() - t0
        print("lm_config", json.dumps(one))
        rec["configs"].append({k: one[k] for k in ("arch", "layers", "prefill", "phase_s")})
    rec["flash_times"] = flash_times(dev)
    return rec, total


# ------------------------------------------------------------------ phase F
F_ARCH = "whisper-base"
F_PREFILL = (4, 448)          # tokens; frames [4, encoder_len = 1500, 512]
F_GREEDY = (2, 8, 16)         # requests, prompt tokens, new tokens
F_PARITY_TOKENS = 64
# (name, b, sq, sk, h, kv, dh, causal): the encoder's self-attention over
# its 1500 frames (not a multiple of the 64-key tile) and the decoder's
# cross-attention from 448 tokens to them
F_FLASH = (("whisper_encoder", 4, 1500, 1500, 8, 8, 64, False),
           ("whisper_cross", 4, 448, 1500, 8, 8, 64, False))


def flash_inputs(gen, dev, b, sq, sk, h, kvh, dh, dtype, q_scale=1):
    """Seeded q [b, sq, h, dh] (times q_scale), k and v [b, sk, kvh, dh]."""
    q = (q_scale * torch.randn((b, sq, h, dh), generator=gen, device=dev)).to(dtype)
    k, v = (torch.randn((b, sk, kvh, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v


def check_flash_whisper(dev) -> dict:
    """Phase F (a): the flash kernel at whisper's two shapes against its
    plain version, bf16 and float32, one launch each; rtol = atol = 1e-5
    (float32) or 2e-2 (bfloat16), as phase A."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {}
    for name, b, sq, sk, h, kvh, dh, causal in F_FLASH:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            q, k, v = flash_inputs(gen, dev, b, sq, sk, h, kvh, dh, dtype)
            before = flash_attention.launches
            got = dispatch.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1, name
            want = ref.flash_attention(q, k, v, causal=causal)
            diff = (got.double() - want.double()).abs()
            key = f"{name}_{str(dtype).removeprefix('torch.')}"
            err[key] = float(diff.max())
            assert bool((diff <= tol * (1 + want.double().abs())).all()), \
                f"flash_attention {key}: max |err| {err[key]}"
            del q, k, v, got, want, diff
    torch.cuda.empty_cache()
    return err


def whisper_batch(cfg, shape, dev, seed: int = SEED, labels: bool = False) -> dict:
    """Seeded tokens of ``shape`` (and their next-token labels) and the stub
    frontend's seeded frames [B, encoder_len, d_model]."""
    from repro_torch.models import frontends
    rng = np.random.default_rng(seed)
    b, s = shape
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s + 1)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": toks[:, :-1], "frames": frontends.random_frames(cfg, gen, b)}
    if labels:
        batch["labels"] = toks[:, 1:]
    return batch


def greedy_with_memory(model, params, frames, prompts, new_tokens: int):
    """A greedy decode whose cross-attention K/V come from ``encode`` of
    ``frames``: prefill_cache over ``prompts`` [B, S], then ``new_tokens``
    steps.  Returns the tokens [B, new_tokens] and the prompt's last logits."""
    from repro_torch.models import whisper as W
    from repro_torch.serve.engine import decode_tokens, prefill_cache
    b, s = prompts.shape
    memory = W.encode(model.cfg, params, frames)
    cache = model.init_cache(params, b, s + new_tokens, memory=memory)
    logits, cache = prefill_cache(model, params, prompts, cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = []
    for i in range(new_tokens):
        out.append(tok)
        tok, cache = decode_tokens(model, params, tok, cache, s + i)
    return torch.stack(out, dim=1), logits


def whisper_layers(params, layers: int) -> dict:
    """``params`` with the encoder and decoder stacks cut to their first
    ``layers`` layers (views; the other leaves as they are)."""
    first = lambda tree: ({k: first(v) for k, v in tree.items()}
                          if isinstance(tree, dict) else tree[:layers])
    return {k: first(v) if k in ("encoder", "decoder") else v for k, v in params.items()}


def whisper_cpu_parity(dev, params_deep, layers: int = 2) -> dict:
    """Phase F (e): whisper-base at full width with its first ``layers``
    encoder and decoder layers, compute float32 with TF32 off, on the card
    and on the CPU from the same weights: prefill logits on seeded frames
    [1, 1500, 512] and tokens [1, F_PARITY_TOKENS] within rtol = atol = 1e-3
    (float32 sums in another order), and identical greedy tokens of a
    decode over encoded frames."""
    from repro_torch.configs import get
    from repro_torch.models import frontends, zoo
    from repro_torch.models.transformer import tree_to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get(F_ARCH), num_layers=layers, encoder_layers=layers,
                              compute_dtype="float32")
    gpu_params = whisper_layers(params_deep, layers)
    t0 = time.perf_counter()
    cpu_params = tree_to(gpu_params, torch.device("cpu"))
    rng = np.random.default_rng(SEED + 5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, F_PARITY_TOKENS)))
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 4)), dtype=torch.int32)
    frames = frontends.random_frames(cfg, torch.Generator().manual_seed(SEED), 2)
    outs = []
    for where, params in ((dev, gpu_params), (torch.device("cpu"), cpu_params)):
        model = zoo.build(cfg, device=where)
        logits = model.prefill_fn(params, {"tokens": tokens.to(where),
                                           "frames": frames[:1].to(where)})
        greedy, _ = greedy_with_memory(model, params, frames.to(where),
                                       prompts.to(where), 8)
        outs.append((logits.cpu(), greedy.cpu()))
    (l_gpu, t_gpu), (l_cpu, t_cpu) = outs
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-3, atol=1e-3)
    assert torch.equal(t_gpu, t_cpu), (t_gpu, t_cpu)
    return {"arch": cfg.name, "layers": [layers, layers], "compute_dtype": "float32",
            "frames": cfg.encoder_len, "prefill_tokens": [1, F_PARITY_TOKENS],
            "max_abs_logit_diff": float((l_gpu - l_cpu).abs().max()),
            "greedy_tokens": t_gpu.tolist(), "host_s": time.perf_counter() - t0}


def whisper_flash_times(dev) -> dict:
    """Phase F (f): the flash kernel at whisper's two shapes, bf16, beside
    SDPA at the same shape and the bound; CUDA events, in turns."""
    from repro_torch.kernels import dispatch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, b, sq, sk, h, kvh, dh, causal in F_FLASH:
        q, k, v = flash_inputs(gen, dev, b, sq, sk, h, kvh, dh, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        turns = cuda_ms_turns({
            "kernel": lambda: dispatch.flash_attention(q, k, v, causal=causal),
            "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)}, iters=50)
        b_ms, b_by = flash_bound(q, k, v, causal, 0, 0.0)
        out[name] = {"shape": f"B={b} Sq={sq} Sk={sk} H={h} KV={kvh} dh={dh} "
                              f"{'causal' if causal else 'non-causal'} bfloat16",
                     "ms": turns["kernel"], "library_ms": turns["sdpa"],
                     "bound_ms": b_ms, "bound_by": b_by}
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def whisper_path(dev) -> tuple[dict, dict]:
    """Phase F: whisper-base at full width and depth (6 + 6 layers, d 512,
    8 x 64 heads), seeded random weights.  The main path, counted from 0:
    prefill_fn on frames [4, 1500, 512] and tokens [4, 448] (finite logits;
    flash once an encoder layer and twice a decoder layer, 18 a forward)
    and a greedy decode of 2 requests whose cross K/V come from encode of
    seeded frames (6 launches more); then the serve CLI at --arch
    whisper-base, the card against the CPU, and flash times.  Returns the
    record and the main path's launch counts."""
    from repro_torch.configs import get
    from repro_torch.models import zoo
    cfg = get(F_ARCH)
    rec = {"flash_check_max_abs_err": check_flash_whisper(dev)}
    model = zoo.build(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(model.generator(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = whisper_batch(cfg, F_PREFILL, dev)
    n_req, n_prompt, n_new = F_GREEDY
    prompts = torch.as_tensor(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab, (n_req, n_prompt)), dtype=torch.int32, device=dev)
    per_forward = whisper_flash_per_forward()

    torch.cuda.synchronize()
    reset_counts()                        # ---- the main path from here
    t0 = time.perf_counter()
    logits = model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    after_prefill = lm_counts()
    greedy, last = greedy_with_memory(model, params, batch["frames"][:n_req], prompts, n_new)
    torch.cuda.synchronize()
    counts = lm_counts()                  # ---- to here
    assert not any(pe_counts().values()), pe_counts()

    assert logits.shape == (*F_PREFILL, cfg.vocab) and logits.dtype == cfg.cdtype
    assert bool(torch.isfinite(logits).all()), "whisper prefill logits are not finite"
    assert after_prefill == {"flash_attention": per_forward, "onehot_dispatch": 0,
                             "onehot_combine": 0}, after_prefill
    assert counts["flash_attention"] == per_forward + cfg.encoder_layers, counts
    assert greedy.shape == (n_req, n_new) and bool(torch.isfinite(last).all())
    assert bool(((greedy >= 0) & (greedy < cfg.vocab)).all())
    del logits
    ms = host_ms(lambda: model.prefill_fn(params, batch), calls=3)
    b, s = F_PREFILL
    rec.update({
        "arch": cfg.name, "layers": [cfg.encoder_layers, cfg.num_layers],
        "params_init_s": init_s, "prefill": {
            "tokens": [b, s], "frames": cfg.encoder_len, "first_s": first_s,
            "ms_per_forward": ms,
            "positions_per_s": b * (cfg.encoder_len + s) / (ms * 1e-3),
            "tokens_per_s": b * s / (ms * 1e-3)},
        "greedy_with_memory": {"requests": n_req, "prompt_tokens": n_prompt,
                               "new_tokens": n_new, "tokens": greedy.tolist()},
        "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    rec["serve_cli"] = serve_cli_default(dev, ("--full", "--arch", F_ARCH))
    torch.cuda.empty_cache()
    rec["cpu_parity"] = whisper_cpu_parity(dev, params)
    del model, params, batch
    torch.cuda.empty_cache()
    rec["flash_times"] = whisper_flash_times(dev)
    return rec, counts


# ------------------------------------------------------------------ phase G
# (name, b, sq, sk, h, kv, dh, causal, window, cap, q scale): llama3.2-3b's
# training shape, gemma2's with its cap and with a window, whisper's two
# (Sk = 1500 off the tile, Sq != Sk; the encoder's 1500 queries leave a
# ragged last query tile of 28), q x 8 (peaked probabilities), and a cap
# that bites: q x 4 under cap 5 puts the scores where 1 - tanh^2(s / cap)
# averages ~0.6 (at cap 50 and unit q it is >= 0.994, so a backward without
# the cap's derivative would pass there)
G_BWD = (("llama", 1, 1024, 1024, 24, 8, 128, True, 0, 0.0, 1),
         ("gemma2_cap50", 4, 1024, 1024, 8, 4, 256, True, 0, 50.0, 1),
         ("gemma2_window256", 4, 1024, 1024, 8, 4, 256, True, 256, 50.0, 1),
         ("whisper_encoder", 4, 1500, 1500, 8, 8, 64, False, 0, 0.0, 1),
         ("whisper_cross", 4, 448, 1500, 8, 8, 64, False, 0, 0.0, 1),
         ("llama_q_x8", 1, 1024, 1024, 24, 8, 128, True, 0, 0.0, 8),
         ("gemma2_cap5_q_x4", 1, 1024, 1024, 8, 4, 256, True, 0, 5.0, 4))
# Against the plain backward of float32 copies, each of dQ, dK and dV is held
# to two bounds.  Element by element, |got - want| <= tol * (1 + max |want|)
# (G_BWD_TOL): float32 sums in another order; bf16 rounds P and dS to bf16
# before their products.  As a whole, ||got - want||_F / ||want||_F <= rel
# (G_BWD_REL): the elementwise bound is never below tol and grows with the
# largest value, so it can be as large as a typical element; rounding P, dS
# and the outputs to bf16 gives a few 1e-3 of the norm, dropping whisper's
# ragged last query tile (28 of 1500) from dK and dV ~sqrt(28 / 1500) = 0.14
G_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
G_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
G_BWD_TIMED = ("llama", "whisper_encoder", "whisper_cross", "gemma2_cap50")
# the backward's bf16 kernels: Delta, the one-pass tile kernel, the conversion
G_BWD_KERNELS = ("delta_kernel", "bwd_tile_kernel", "bwd_convert_kernel")
G_WHISPER = (8, 448, 20)      # batch, tokens (frames: encoder_len), steps
G_LLAMA = (4, (2, 1024), 8)   # layers of 28, batch shape, steps
G_PARITY = (2, (2, 64))       # encoder and decoder layers, token shape
G_CLI_STEPS = (4, 8)          # the launcher's run, then its resumption
G_GATE = 1e-3                 # card vs CPU: max |a - b| / max |b| of any leaf


def check_flash_bwd(dev) -> tuple[dict, dict]:
    """Phase G (a): the backward kernel through FlashAttention's backward
    against ref.flash_attention_bwd on float32 copies of the same inputs,
    bf16 and float32, one launch each, held to G_BWD_TOL element by element
    and to G_BWD_REL in norm.  Returns the max |err| of each case and its
    relative norm error beside that bound; prints each reading beside its
    bounds."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err, rel_err = {}, {}
    for name, b, sq, sk, h, kvh, dh, causal, window, cap, q_scale in G_BWD:
        for dtype, tol in G_BWD_TOL.items():
            q, k, v = flash_inputs(gen, dev, b, sq, sk, h, kvh, dh, dtype, q_scale)
            do = torch.randn((b, sq, h, dh), generator=gen, device=dev).to(dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = flash_attention_bwd.launches
            out = dispatch.flash_attention(*leaves, causal=causal, window=window,
                                           softcap=cap)
            got = torch.autograd.grad(out, leaves, do)
            torch.cuda.synchronize()
            assert flash_attention_bwd.launches == before + 1, name
            want = ref.flash_attention_bwd(q.float(), k.float(), v.float(), do.float(),
                                           causal=causal, window=window, softcap=cap)
            for part, g, w in zip(("dq", "dk", "dv"), got, want):
                assert g.dtype == dtype and g.shape == w.shape, (name, part)
                delta = g.double() - w.double()
                diff = float(delta.abs().max())
                bound = tol * (1 + float(w.abs().max()))
                rel = float(delta.norm() / w.double().norm())
                key = f"{name}_{part}_{str(dtype).removeprefix('torch.')}"
                err[key] = diff
                rel_err[key] = {"rel": rel, "bound": G_BWD_REL[dtype]}
                print(f"flash_attention_bwd {key}: max |err| {diff:.3e} (bound {bound:.3e}), "
                      f"norm err {rel:.3e} (bound {G_BWD_REL[dtype]:.0e})", file=sys.stderr)
                assert diff <= bound, f"flash_attention_bwd {key}: max |err| {diff} > {bound}"
                assert rel <= G_BWD_REL[dtype], \
                    f"flash_attention_bwd {key}: norm err {rel} > {G_BWD_REL[dtype]}"
            del q, k, v, do, leaves, out, got, want
    torch.cuda.empty_cache()
    return err, rel_err


def flash_bwd_bound(q, k, v, causal, window) -> tuple[float, str]:
    """Bytes: q, k, v, o, dO and LSE read once, dQ, dK, dV written once.
    Operations: the five products of FlashAttention-2's backward (S, dP,
    dV, dK, dQ), 10 dh a kept pair, at the bf16 tensor-core rate."""
    b, sq, h, dh = q.shape
    pairs = flash_pairs(b, h, sq, k.shape[1], causal, window)
    nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * q.element_size() \
        + 4 * b * h * sq
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 10 * dh * pairs / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_flash_bwd(q, k, v, do, causal):
    """The library's backward kernel at q [b, sq, h, dh], k, v [b, sk, kvh,
    dh] and dO as a call that launches it alone: PyTorch's FlashAttention
    forward (aten) once, outside the call, for its output and log-sum-exp,
    then a closure over aten's flash backward with them (KV heads repeated
    and every transpose made outside).  A yardstick only: the port never
    calls it."""
    h, kvh, dh = q.shape[2], k.shape[2], q.shape[3]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    dot = do.transpose(1, 2).contiguous()
    scale = dh ** -0.5
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
        torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, causal, False,
                                                           scale=scale)
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, seed, offset,
        scale=scale)


def flash_bwd_times(dev) -> dict:
    """Phase G: the backward kernel (the wrapper's call: Delta, the tile
    kernel, the conversion) at G_BWD_TIMED's shapes in bf16, beside
    PyTorch's FlashAttention backward kernel at the same shape
    (``sdpa_flash_bwd``, aten called directly: no autograd, no cap) in
    turns; the card time of the call's three kernels (together and each),
    its plain version and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, b, sq, sk, h, kvh, dh, causal, window, cap, _ in G_BWD:
        if name not in G_BWD_TIMED:
            continue
        q, k, v = flash_inputs(gen, dev, b, sq, sk, h, kvh, dh, torch.bfloat16)
        do = torch.randn((b, sq, h, dh), generator=gen, device=dev).to(torch.bfloat16)
        o, lse = flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                                 return_lse=True)
        fns = {"kernel": lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                                     window=window, softcap=cap),
               "sdpa": sdpa_flash_bwd(q, k, v, do, causal)}
        turns = cuda_ms_turns(fns, iters=20)
        card_ms = device_ms(fns["kernel"], G_BWD_KERNELS, calls=50, per_call=3)
        by_kernel = {n: device_ms(fns["kernel"], n, calls=50) for n in G_BWD_KERNELS}
        plain_ms = cuda_ms(lambda: ref.flash_attention_bwd(q, k, v, do, causal=causal,
                                                           window=window, softcap=cap),
                           iters=5, warmup=1)
        b_ms, b_by = flash_bwd_bound(q, k, v, causal, window)
        out[name] = {"shape": f"B={b} Sq={sq} Sk={sk} H={h} KV={kvh} dh={dh} "
                              f"{'causal' if causal else 'non-causal'} bfloat16",
                     "ms": turns["kernel"], "device_ms": card_ms,
                     "device_ms_by_kernel": by_kernel,
                     "library_ms": turns["sdpa"], "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        del q, k, v, do, o, lse, fns
    torch.cuda.empty_cache()
    return out


def train_steps(model, params, batch, steps: int, schedule):
    """``steps`` of make_train_step (adamw at ``schedule``, clip 1.0) on
    one fixed batch.  Returns the last state, the losses and the host
    seconds of each step (each ends in reading its loss)."""
    from repro_torch.optim import adamw
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.state import TrainState
    opt = adamw(schedule)
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=model.device),
                       params=params, opt_state=opt.init(params))
    step = make_train_step(model, opt)
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
    return state, losses, secs, step


def bwd_share(step, state, batch) -> dict:
    """One more step under torch.profiler: the card's time in the backward
    kernel's three kernels against the step's wall time under the profiler
    (null where the profiler recorded none of them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = G_BWD_KERNELS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    bwd_ms = 1e-3 * sum(e.self_device_time_total for e in kernels
                        if any(n in e.key for n in names))
    device_ms = 1e-3 * sum(e.self_device_time_total for e in kernels)
    return {"wall_ms_profiled": wall_ms, "device_ms": device_ms,
            "flash_bwd_ms": bwd_ms if bwd_ms else None,
            "flash_bwd_share_of_step": bwd_ms / wall_ms if bwd_ms else None}


def train_run(dev, cfg, batch, steps: int, per_step: int, schedule) -> tuple[dict, dict]:
    """Phase G (b), (c): ``steps`` training steps of ``cfg`` at seeded
    random weights on one fixed batch, the main path counted from 0: the
    forward and backward kernels ``per_step`` times a step each, the loss
    falls and every parameter stays finite.  Then ms a step (the steps
    after the first), tokens/s and the backward kernel's share of a step."""
    from repro_torch.models import zoo
    from repro_torch.tree import tree_leaves
    model = zoo.build(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init_params(model.generator(SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.synchronize()
    reset_counts()                        # ---- the main path from here
    state, losses, secs, step = train_steps(model, params, batch, steps, schedule)
    torch.cuda.synchronize()
    counts = train_counts()               # ---- to here
    assert counts == {"flash_attention": steps * per_step,
                      "flash_attention_bwd": steps * per_step}, counts
    assert losses[-1] < losses[0], f"{cfg.name}: the loss did not fall: {losses}"
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params)), \
        f"{cfg.name}: a parameter is not finite"
    step_s = sum(secs[1:]) / (steps - 1)
    b, s = batch["tokens"].shape
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "batch": [b, s], "steps": steps, "losses": losses,
           "first_step_s": secs[0], "ms_per_step": 1e3 * step_s,
           "tokens_per_s": b * s / step_s, "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if "frames" in batch:
        rec["frames"] = batch["frames"].shape[1]
    rec["profile"] = bwd_share(step, state, batch)
    return rec, counts


def train_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches}


def rel_diff(got, want) -> float:
    """max over the leaves of max |got - want| / max |want|."""
    from repro_torch.tree import tree_leaves
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = w.detach().cpu().float()
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g.detach().cpu().float() - w).abs().max()) / scale)
    return worst


def train_cpu_parity(dev, params_deep) -> dict:
    """Phase G (d): one adamw step (constant max_lr, clip 1.0) of
    whisper-base's first G_PARITY layers in float32 (TF32 off) on the card
    and on the CPU, from the same weights and batch: the loss within
    1e-3 (relative), and the gradients and the params after the step within
    G_GATE (max |card - CPU| / max |CPU| of any leaf)."""
    from repro_torch.configs import get
    from repro_torch.models import zoo
    from repro_torch.models.transformer import tree_to
    from repro_torch.optim import adamw, constant
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.state import TrainState
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, shape = G_PARITY
    cfg = dataclasses.replace(get(F_ARCH), num_layers=layers, encoder_layers=layers,
                              compute_dtype="float32")
    t0 = time.perf_counter()
    gpu_params = tree_map(lambda t: t.clone(), whisper_layers(params_deep, layers))
    cpu = torch.device("cpu")
    batch = whisper_batch(cfg, shape, cpu, seed=SEED + 7, labels=True)
    opt = adamw(constant(cfg.max_lr))
    outs = []
    for where, params in ((dev, gpu_params), (cpu, tree_to(gpu_params, cpu))):
        model = zoo.build(cfg, device=where)
        b = {k: v.to(where) for k, v in batch.items()}
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = model.loss_fn(leaves, b)
        loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        state = TrainState(step=torch.zeros((), dtype=torch.int32, device=where),
                           params=params, opt_state=opt.init(params))
        new, m = make_train_step(model, opt)(state, b)
        outs.append((float(m["loss"]), tree_to(grads, cpu), tree_to(new.params, cpu)))
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = outs
    grad_diff, param_diff = rel_diff(g_gpu, g_cpu), rel_diff(p_gpu, p_cpu)
    assert abs(l_gpu - l_cpu) <= 1e-3 * max(1.0, abs(l_cpu)), (l_gpu, l_cpu)
    assert grad_diff <= G_GATE, f"gradients differ by {grad_diff} > {G_GATE}"
    assert param_diff <= G_GATE, f"params after the step differ by {param_diff} > {G_GATE}"
    return {"arch": cfg.name, "layers": [layers, layers], "compute_dtype": "float32",
            "tokens": list(shape), "frames": cfg.encoder_len, "loss_card": l_gpu,
            "loss_cpu": l_cpu, "max_rel_grad_diff": grad_diff,
            "max_rel_param_diff_after_step": param_diff, "gate": G_GATE,
            "host_s": time.perf_counter() - t0}


def train_cli(dev) -> tuple[dict, dict]:
    """Phase G (e): ``repro_torch.launch.train.main`` at --arch
    whisper-base with a checkpoint directory under build/, G_CLI_STEPS[0]
    steps, then the same command resumed to G_CLI_STEPS[1] from its
    checkpoint: the second run takes the remaining steps only."""
    import contextlib
    import io
    import tempfile
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    first, last = G_CLI_STEPS
    per_step = whisper_flash_per_forward()
    out = io.StringIO()
    runs = []
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        for steps in (first, last):
            argv = ["--arch", F_ARCH, "--steps", str(steps), "--ckpt", d]
            torch.cuda.synchronize()
            reset_counts()                # ---- the main path from here
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                state = train.main(argv)
            torch.cuda.synchronize()
            counts = train_counts()       # ---- to here
            runs.append({"argv": argv, "wall_s": time.perf_counter() - t0,
                         "step": int(state.step), "launches": counts})
            assert int(state.step) == steps
            assert CheckpointManager(d).latest_step() == steps
            assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params))
            del state
    for run, ran in zip(runs, (first, last - first)):     # the resumption runs the rest
        assert run["launches"] == {"flash_attention": ran * per_step,
                                   "flash_attention_bwd": ran * per_step}, run
    text = out.getvalue()
    assert f"finished at step {first}" in text and f"finished at step {last}" in text, text
    total = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    return {"runs": runs, "output": text.strip().splitlines()}, total


def whisper_flash_per_forward() -> int:
    """Flash launches a whisper-base forward: one an encoder layer, two (self
    and cross) a decoder layer, 18 at 6 + 6 layers."""
    from repro_torch.configs import get
    cfg = get(F_ARCH)
    return cfg.encoder_layers + 2 * cfg.num_layers


def training_path(dev) -> tuple[dict, dict, dict]:
    """Phase G: the backward kernel against its plain version, training
    whisper-base and llama3.2-3b (4 of 28 layers) on the card, one step
    against the CPU, the launcher with a resumption, and the backward
    kernel's times.  Returns the record, the main paths' launch counts
    (summed) and the kernels-line entry of flash_attention_bwd."""
    from repro_torch.configs import get
    from repro_torch.models import zoo
    from repro_torch.optim import warmup_cosine
    rec = dict(zip(("bwd_check_max_abs_err", "bwd_check_norm_err"), check_flash_bwd(dev)))
    total = {"flash_attention": 0, "flash_attention_bwd": 0}

    cfg = get(F_ARCH)
    b, s, steps = G_WHISPER
    t0 = time.perf_counter()
    one, counts = train_run(dev, cfg, whisper_batch(cfg, (b, s), dev, labels=True), steps,
                            whisper_flash_per_forward(),
                            warmup_cosine(cfg.max_lr, max(steps // 10, 1), steps))
    one["phase_s"] = time.perf_counter() - t0
    rec["whisper"] = one
    total = {k: total[k] + counts[k] for k in total}
    torch.cuda.empty_cache()

    # the CPU comparison takes fresh weights of its own layers
    model = zoo.build(get(F_ARCH), device=dev)
    rec["cpu_parity"] = train_cpu_parity(dev, model.init_params(model.generator(SEED)))
    del model
    torch.cuda.empty_cache()

    layers, shape, steps = G_LLAMA
    cfg = dataclasses.replace(get("llama3.2-3b"), num_layers=layers)
    batch = prefill_batch(cfg, (shape[0], shape[1] + 1), dev)
    batch = {"tokens": batch["tokens"][:, :-1], "labels": batch["tokens"][:, 1:]}
    t0 = time.perf_counter()
    one, counts = train_run(dev, cfg, batch, steps, layers,
                            warmup_cosine(cfg.max_lr, max(steps // 10, 1), steps))
    one["phase_s"] = time.perf_counter() - t0
    one["of_layers"] = get("llama3.2-3b").num_layers
    rec["llama"] = one
    total = {k: total[k] + counts[k] for k in total}
    torch.cuda.empty_cache()

    rec["train_cli"], counts = train_cli(dev)
    total = {k: total[k] + counts[k] for k in total}
    torch.cuda.empty_cache()

    times = flash_bwd_times(dev)
    rec["flash_bwd_times"] = times
    main = times["llama"]
    entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84 (its gradient; the JAX "
                    "package differentiates sdpa_chunked with jax.grad, no Pallas backward)",
        "launches": total["flash_attention_bwd"],
        "max_abs_err": max(rec["bwd_check_max_abs_err"].values()),
        "ms": main["ms"], "device_ms": main["device_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": main["shape"] + "; *_whisper_encoder and *_whisper_cross at whisper's, "
                 "*_gemma2_cap50 at gemma2-2b's (cap 50; the library call has no cap)",
        "library_call": "aten._scaled_dot_product_flash_attention_backward called directly "
                        "(is_causal as the kernel's), KV heads repeated outside the timing",
        **{f"{key}_{name}": times[name][key] for name in G_BWD_TIMED[1:]
           for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    return rec, total, entry


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
    from repro_torch.apps import dp, hhd, histo, hll
    from repro_torch.core import Ditto, compilemon, perfmodel
    from repro_torch.core.profiler import workload_hist
    from repro_torch.core.scheduler import schedule_secpes
    from repro_torch.core.types import ExecStats
    from repro_torch.data.zipf import zipf_tuples
    from repro_torch.kernels import _build, dispatch, ref
    from repro_torch.kernels import cms_update as cms_mod
    from repro_torch.kernels import route_accumulate as route_mod
    from repro_torch.kernels.cms_update import cms_update
    from repro_torch.kernels.route_accumulate import route_accumulate

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # ---- 1. build
    compilemon.install()
    before = compilemon.snapshot()
    t0 = time.perf_counter()
    logs = _build.build()          # every csrc/*.cu, one nvcc each, in parallel
    build_s = time.perf_counter() - t0
    for kernel, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"build {kernel}: {usage}")
    print(f"build_s {build_s:.3f}")

    # ---- 2. kernels against their plain versions
    max_err = check_kernels(route_accumulate, cms_update, ref, dev)
    print("kernel_check", json.dumps(max_err))
    print("compilemon_phases_1_2", json.dumps(dataclasses.asdict(compilemon.since(before))))

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
    results, picked, routed = [], {}, {}
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
        reset_counts()
        t0 = time.perf_counter()
        merged, stats = impl.run(chunks, mask=mask)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = pe_counts()
        for k, c in counts.items():
            launches[k] += c
            want = n_chunks if k == kernel.__name__ else 0
            assert c == want, f"{cfg}: {k} launched {c} times, expected {want}"
        assert not any(lm_counts().values()), lm_counts()
        want = oracle(tuples[:, 0])
        got = merged.cpu().numpy()
        assert got.shape == want.shape and np.array_equal(got, want), \
            f"{cfg}: merged buffers differ from the numpy oracle"
        cycles = float(stats.modeled_cycles.double().sum())
        # modeled cycles over the chunks of the first N_TUPLES tuples, at
        # Ditto's X and at X = 0 (whose busiest PE is the busiest PriPE)
        body = N_TUPLES // CHUNK
        routed[cfg] = {
            "tuples_per_s": len(tuples) / run_s, "num_sec": impl.num_sec,
            "cycles": float(stats.modeled_cycles[:body].double().sum()),
            "cycles_x0": float(perfmodel.chunk_cycles(
                CHUNK, stats.workload[:body].max(dim=1).values, d.mem_width_tuples,
                spec.ii_pe).double().sum())}
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
    def route_bound(buf, eff, idx):
        """Bytes: 12 per tuple, plus a read and a write of each cell this
        chunk's valid tuples touch.  Operations: one fold per valid tuple."""
        num_pe, local = buf.shape
        ok = (eff >= 0) & (eff < num_pe) & (idx >= 0) & (idx < local)
        cells = torch.unique((eff.long() * local + idx.long())[ok]).numel()
        return bound_ms(CHUNK * 12 + 2 * 4 * cells, int(ok.sum()))

    kernels = []
    hspec = hll.make_spec(12, 16)
    eff, idx, val = chunk_inputs(hspec, stream_hll, picked["hll_a3_ragged"], dev)
    num_pe = 16 + picked["hll_a3_ragged"]
    buf = hspec.init_buffer(num_pe, dev)
    local = buf.shape[1]
    flat = (eff.long() * local + idx.long())
    lib_buf = buf.clone().view(-1)
    fn = lambda: route_accumulate(buf, eff, idx, val, "max")
    turns = cuda_ms_turns({"kernel": fn, "library": lambda: lib_buf.scatter_reduce_(
        0, flat, val, "amax")})
    ms, lib_ms = turns["kernel"], turns["library"]
    dev_ms = device_ms(fn, "route_accumulate_")
    print("route_accumulate_host", json.dumps(pe_host_pieces(
        route_mod._entry(), lambda *t: route_accumulate(*t, "max"),
        lambda *t: dispatch.pe_buffer_update(*t, "max"), (buf, eff, idx, val), (1,))))
    plain_ms = cuda_ms(lambda: ref.pe_buffer_update(buf, eff, idx, val, "max"))
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
    eff, cols, val = chunk_inputs(cspec, stream_3, picked["hhd_a3"], dev)
    num_pe = 16 + picked["hhd_a3"]
    sketch = cspec.init_buffer(num_pe, dev)
    rows = torch.arange(4, device=dev)
    flat = ((eff.long()[:, None] * 4 + rows) * 1024 + cols.long()).reshape(-1)
    vals = val[:, None].expand(-1, 4).reshape(-1).contiguous()
    lib_sketch = sketch.clone().view(-1)
    fn = lambda: cms_update(sketch, eff, cols, val)
    turns = cuda_ms_turns({"kernel": fn,
                           "library": lambda: lib_sketch.index_add_(0, flat, vals)})
    ms, lib_ms = turns["kernel"], turns["library"]
    dev_ms = device_ms(fn, "cms_update_kernel")
    # the same update on an alpha-0 chunk (no hot cell), under the X that
    # Ditto picks for the alpha-0 stream
    x0 = Ditto(cspec, chunk_size=CHUNK, device=dev).select(stream_0[:, 0])
    eff0, cols0, val0 = chunk_inputs(cspec, stream_0, x0, dev)
    sketch0 = cspec.init_buffer(16 + x0, dev)
    dev_ms_a0 = device_ms(lambda: cms_update(sketch0, eff0, cols0, val0), "cms_update_kernel")
    print("cms_update_host", json.dumps(pe_host_pieces(
        cms_mod._entry(), cms_update, dispatch.cms_update, (sketch, eff, cols, val))))
    plain_ms = cuda_ms(lambda: ref.cms_update(sketch, eff, cols, val))
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
        "device_ms_alpha0": dev_ms_a0,
        "shape": f"HHD alpha=3 chunk: T={CHUNK} int32 into [{num_pe}, 4, 1024]; "
                 f"device_ms_alpha0 at an alpha=0 chunk into [{16 + x0}, 4, 1024]",
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

    # ---- 7. PageRank on the most skewed Fig. 8 graph at V = 2^14
    rec, counts = pagerank_path(dev)
    launches["route_accumulate"] += counts["route_accumulate"]
    print("pagerank", json.dumps(rec))
    torch.cuda.empty_cache()

    # ---- 8. DP over the alpha-3 stream, and its card time per chunk
    rec = dp_path(dev, stream_3)
    rec["profile"] = profile_chunks("dp_a3", dp.make_spec(8, 16, DP_CAPACITY), stream_3,
                                    rec["num_sec"], dev)
    print("dp", json.dumps(rec))
    torch.cuda.empty_cache()

    # ---- 9. the replicated baseline on the alpha-3 streams
    recs, counts = baseline_path(dev, [
        ("histo_a3", lambda m: histo.make_spec(512, 1 << 20, m), stream_3,
         lambda k: histo.oracle(k, 512, 1 << 20, 1), "route_accumulate"),
        ("hll_a3_ragged", lambda m: hll.make_spec(12, m), stream_hll,
         lambda k: hll.oracle(k, 12, 1), "route_accumulate"),
        ("hhd_a3", lambda m: hhd.make_spec(4, 1024, m), stream_3,
         lambda k: hhd.oracle(k, 4, 1024, 1), "cms_update")], routed)
    for k, c in counts.items():
        launches[k] += c
    print("baseline", json.dumps(recs))

    # ---- 10. the autotuner on the card
    rec, counts = tune_path(dev)
    launches["route_accumulate"] += counts["route_accumulate"]
    print("tune", json.dumps(rec))
    torch.cuda.empty_cache()

    # ---- 11. StreamEngine at serving size
    t0 = time.perf_counter()
    rec, counts = stream_path(dev, stream_3)
    for k, c in counts.items():
        launches[k] += c
    rec["phase_s"] = time.perf_counter() - t0
    print("stream", json.dumps(rec))
    torch.cuda.empty_cache()

    # ---- 12. SessionEngine, its durability, HHD and DP sessions
    t0 = time.perf_counter()
    recs, counts = session_path(dev)
    for k, c in counts.items():
        launches[k] += c
    recs["session"]["phase_s"] = time.perf_counter() - t0
    for key in ("session", "durability", "session_dp"):
        print(key, json.dumps(recs[key]))
    torch.cuda.empty_cache()

    # ---- 13. SessionService over TCP, crashed and recovered behind a new one
    rec, counts = service_path(dev)
    for k, c in counts.items():
        launches[k] += c
    print("service", json.dumps(rec))
    torch.cuda.empty_cache()

    # ---- 14. multi-device Ditto on logical shards of the card
    t0 = time.perf_counter()
    rec, n = pe_sharded_path(dev)
    launches["route_accumulate"] += n
    rec["phase_s"] = time.perf_counter() - t0
    print("mesh_pe", json.dumps(rec))
    t0 = time.perf_counter()
    rec, counts = mesh_session_path(dev)
    for k, c in counts.items():
        launches[k] += c
    rec["phase_s"] = time.perf_counter() - t0
    print("mesh_session", json.dumps(rec))
    torch.cuda.empty_cache()
    for k in kernels:                     # every main path's count, summed
        k["launches"] = launches[k["name"]]

    # ---- A. the MoE LM's kernels against their plain versions
    lm_err = check_lm_kernels(dev)
    print("lm_kernel_check", json.dumps(lm_err))
    torch.cuda.empty_cache()

    # ---- B. the LM path at full width (depth cut to LM_LAYERS)
    rec, lm_launches, model, params, tokens, engine = lm_path(dev)
    print("lm_e2e", json.dumps(rec))
    print("lm_profile", json.dumps(profile_lm(model, params, tokens, engine)))
    del engine
    torch.cuda.empty_cache()

    # ---- C. card against CPU, full width, 2 layers, float32
    print("lm_cpu_parity", json.dumps(lm_cpu_parity(dev, params)))

    # ---- D. the LM kernels' times at the prefill shape
    kernels += lm_kernel_times(dev, model, params, tokens, lm_launches, lm_err)
    del model, params
    torch.cuda.empty_cache()

    # ---- E. MLA and deepseek, soft-capped gemma2, the dense configs,
    # mamba2 (SSD), the Jamba hybrid and phi-3-vision
    t0 = time.perf_counter()
    rec, counts = lm_configs_path(dev)
    rec["phase_s"] = time.perf_counter() - t0
    print("lm_configs", json.dumps(rec))
    for k in kernels:
        k["launches"] += counts.get(k["name"], 0)
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    times = rec["flash_times"]
    flash.update({
        "ms_gemma2_cap50": times["gemma2"]["cap50"]["ms"],
        "bound_ms_gemma2_cap50": times["gemma2"]["cap50"]["bound_ms"],
        "ms_gemma2_cap0": times["gemma2"]["cap0"]["ms"],
        "library_ms_gemma2": times["gemma2"]["library_ms"],
        "ms_mla": times["mla"]["cap0"]["ms"], "bound_ms_mla": times["mla"]["cap0"]["bound_ms"],
        "library_ms_mla": times["mla"]["library_ms"],
        **{f"{key}_{name}": times[name][k1][k2] if k2 else times[name][k1]
           for name in ("jamba", "phi3")
           for key, k1, k2 in (("ms", "cap0", "ms"), ("bound_ms", "cap0", "bound_ms"),
                               ("bound_by", "cap0", "bound_by"),
                               ("library_ms", "library_ms", None))},
        "max_abs_err_softcap": max(rec["flash_check_max_abs_err"].values())})
    flash["shape"] += ("; *_gemma2: B=4 S=1024 H=8 KV=4 dh=256 causal bfloat16 (cap 50 "
                       "and 0); *_mla: B=4 S=1024 H=KV=16 dh=192; *_jamba: B=1 S=1024 "
                       "H=64 KV=8 dh=128; *_phi3: B=1 S=2048 H=KV=32 dh=96 (in the 128 "
                       "template); library_ms_* SDPA without a cap")

    # ---- F. whisper-base, the encoder-decoder family
    t0 = time.perf_counter()
    rec, counts = whisper_path(dev)
    rec["phase_s"] = time.perf_counter() - t0
    print("whisper", json.dumps(rec))
    flash["launches"] += counts["flash_attention"]
    times = rec["flash_times"]
    flash.update({f"{key}_{name}": times[name][key] for name in times
                  for key in ("ms", "bound_ms", "bound_by", "library_ms")})
    flash["max_abs_err_whisper"] = max(rec["flash_check_max_abs_err"].values())
    flash["shape"] += ("; *_whisper_encoder: B=4 S=1500 H=KV=8 dh=64 non-causal; "
                       "*_whisper_cross: B=4 Sq=448 Sk=1500 H=KV=8 dh=64 non-causal")

    # ---- G. training: the backward kernel, whisper-base and llama3.2-3b
    t0 = time.perf_counter()
    rec, counts, bwd = training_path(dev)
    rec["phase_s"] = time.perf_counter() - t0
    print("training", json.dumps(rec))
    flash["launches"] += counts["flash_attention"]
    kernels.append(bwd)

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
