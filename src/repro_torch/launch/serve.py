"""Serving launcher: continuous-batching greedy decode of random-init
weights (a throughput and machinery demo).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch whisper-base

The CLI of ``repro.launch.serve`` plus ``--device`` (default ``cuda``,
which raises without a CUDA device).  ``--arch`` takes any config the port
has (``repro_torch.configs.ARCH_IDS`` or a dashed alias: the dense, MoE,
MLA, SSM (mamba2-780m), hybrid (jamba-1.5-large-398b) and VLM
(phi-3-vision-4.2b) decoders and the encoder-decoder whisper-base; default
llama3.2-3b, as in the JAX CLI); ``--full`` serves its full-size config,
else its REDUCED one.  The VLM serves text only, and whisper against a
zero encoder memory, as the JAX engine does.  ``--ckpt`` restores params
from the directory's newest checkpoint (a checkpoint of the params tree,
as the JAX CLI restores it; either package's).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get, get_reduced
from repro_torch.models import zoo
from repro_torch.serve.engine import DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: REDUCED, CPU-scale)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get(args.arch) if args.full else get_reduced(args.arch)
    model = zoo.build(cfg, device=args.device)
    params = model.init_params(model.generator(args.seed))
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt)
        restored = mgr.restore(params, device=model.device)
        mgr.close()
        if restored is not None:
            params = restored
    engine = DecodeEngine(model, params, slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 17))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        engine.submit(Request(rid, prompt, args.max_new))

    t0 = time.perf_counter()
    ticks = 0
    while engine.queue or any(r is not None for r in engine.slot_req):
        engine.step()
        ticks += 1
    dt = time.perf_counter() - t0
    total = args.requests * args.max_new
    print(f"served {args.requests} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {ticks} engine ticks, "
          f"{args.slots} slots, {model.device})")


if __name__ == "__main__":
    main()
