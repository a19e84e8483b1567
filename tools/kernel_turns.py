#!/usr/bin/env python3
"""Time the PE update and the MoE dispatch of two or more checkouts of the
port on one NVIDIA GPU, in turns (A, B, B, A), so that their numbers
compare within one call on one card.

    python3 tools/kernel_turns.py PARENT_ROOT .

Each turn is a process of its own that imports ``repro_torch`` from
``ROOT/src`` (building its kernels into ``ROOT/build``) and times, on
inputs made from a seed:
  - ``dispatch.pe_buffer_update`` (max) at the first chunk of an HLL
    alpha = 3 stream (p = 12, M = 16, X = 14), against
    ``scatter_reduce_(amax)`` timed in turns with it;
  - ``dispatch.onehot_dispatch`` at moonshot's prefill shape (G = 8,
    T = 3072, 72 slots x 60, D = 2048 bf16) and at its serving-load decode
    shape (G = 1, T = 384, 72 slots x 7), slots by occurrence rank as on the
    model path, against ``zero_()`` + ``index_put_(accumulate=True)``;
  - ``dispatch.flash_attention`` without a soft-cap at moonshot's prefill
    shape (B = 4, S = 1024, H = KV = 16, dh = 128) and gemma2's (H 8 / KV 4,
    dh 256), causal, bf16, against SDPA, and its card time alone; its
    outputs there and in float32
    are hashed, and the roots' hashes must agree (``flash_identical``: the
    uncapped kernel's output bit for bit).
``ms`` is a call's time from CUDA events over back-to-back calls;
``device_ms`` the card's time of every kernel and memset a call launches,
from ``chip_smoke.device_ms`` (null where torch.profiler missed launches).
The timing helpers and the library yardsticks are ``chip_smoke.py``'s.
Prints one JSON line a turn, the card's name and power limit, then the
mean of each number per root (null if any turn's is null).
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SEED = 3


def child(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(REPO))
    from chip_smoke import CHUNK, chunk_inputs, cuda_ms_turns, device_ms, library_dispatch
    from repro_torch.apps import hll
    from repro_torch.data.zipf import zipf_tuples
    from repro_torch.kernels import dispatch, ops
    assert Path(dispatch.__file__).resolve().is_relative_to(root.resolve())
    dev = torch.device("cuda", 0)
    out = {"root": str(root)}

    spec = hll.make_spec(12, 16)
    eff, idx, val = chunk_inputs(spec, zipf_tuples(CHUNK, 1 << 22, 3.0, seed=SEED), 14, dev)
    buf = spec.init_buffer(30, dev)
    flat = eff.long() * buf.shape[1] + idx.long()
    lib_buf = buf.clone().view(-1)
    fn = lambda: dispatch.pe_buffer_update(buf, eff, idx, val, "max")
    turns = cuda_ms_turns({"kernel": fn, "library": lambda: lib_buf.scatter_reduce_(
        0, flat, val, "amax")})
    out["route_accumulate"] = {"ms": turns["kernel"], "library_ms": turns["library"],
                               "device_ms": device_ms(fn, "route_accumulate_")}

    # a dispatch call is a memset and the parent's one scatter kernel, or a
    # memset and this tree's link and fill kernels
    source = root / "src/repro_torch/kernels/csrc/moe_onehot.cu"
    per_call = 3 if "dispatch_link_kernel" in source.read_text() else 2

    rng = np.random.default_rng(SEED)
    for name, (g, t, pe, cap, d) in (("dispatch_prefill", (8, 3072, 72, 60, 2048)),
                                     ("dispatch_decode", (1, 384, 72, 7, 2048))):
        e = torch.from_numpy(rng.integers(0, pe, (g, t)).astype(np.int32)).to(dev)
        s = ops.occurrence_rank(e, pe).to(torch.int32)
        x = torch.from_numpy(rng.standard_normal((g, t, d)).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        library, kept = library_dispatch(e, s, x, pe, cap)
        fn = lambda: dispatch.onehot_dispatch(e, s, x, pe, cap)
        assert torch.equal(fn().view(-1, d), library())
        turns = cuda_ms_turns({"kernel": fn, "library": library}, iters=50)
        out[name] = {"ms": turns["kernel"], "library_ms": turns["library"],
                     "device_ms": device_ms(fn, ("dispatch_", "Memset"), calls=50,
                                            per_call=per_call),
                     "kept": kept}

    digests = {}
    for name, (h, kvh, dh) in (("flash_moonshot", (16, 16, 128)),
                               ("flash_gemma2", (8, 4, 256))):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = (torch.randn((4, 1024, n, dh), generator=gen, device=dev)
                   for n in (h, kvh, kvh))
        q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
        for tag, args in (("bfloat16", (q16, k16, v16)), ("float32", (q, k, v))):
            got = dispatch.flash_attention(*args, causal=True)
            digests[f"{name}_{tag}"] = hashlib.sha1(
                got.view(torch.int16 if tag == "bfloat16" else torch.int32)
                .cpu().numpy().tobytes()).hexdigest()
        qt = q16.transpose(1, 2)
        kt, vt = (x.repeat_interleave(h // kvh, dim=2).transpose(1, 2) for x in (k16, v16))
        turns = cuda_ms_turns({
            "kernel": lambda: dispatch.flash_attention(q16, k16, v16, causal=True),
            "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)}, iters=50)
        out[name] = {"ms": turns["kernel"], "library_ms": turns["library"],
                     "device_ms": device_ms(
                         lambda: dispatch.flash_attention(q16, k16, v16, causal=True),
                         "flash_bf16_kernel", calls=50)}
    out["digests"] = digests
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--child"]:
        print(json.dumps(child(Path(argv[1]))))
        return 0
    roots = argv
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    results = {r: [] for r in roots}
    for root in roots + roots[::-1]:
        run = subprocess.run([sys.executable, __file__, "--child", root],
                             capture_output=True, text=True, timeout=600)
        if run.returncode:
            print(run.stdout, run.stderr, file=sys.stderr)
            return 1
        line = run.stdout.strip().splitlines()[-1]
        print("turn", line)
        results[root].append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    def mean(values):
        return None if None in values else float(np.mean(values))

    means = {root: {k: {f: mean([r[k][f] for r in runs]) for f in runs[0][k]}
                    for k in runs[0] if k not in ("root", "digests")}
             for root, runs in results.items()}
    digests = [run["digests"] for runs in results.values() for run in runs]
    print(json.dumps({"mean": means,
                      "flash_identical": all(d == digests[0] for d in digests)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
