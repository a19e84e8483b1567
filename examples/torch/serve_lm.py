"""Serve a small model on PyTorch with batched requests through the
continuous-batching engine (slot scheduler + per-slot cache positions).

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from train_lm import SMALL  # noqa: E402

from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve.engine import DecodeEngine, Request  # noqa: E402

SLOTS, MAX_LEN, REQUESTS = 4, 96, 10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = zoo.build(SMALL, args.device)
    params = model.init_params(model.generator(0))
    engine = DecodeEngine(model, params, slots=SLOTS, max_len=MAX_LEN)

    rng = np.random.default_rng(1)
    reqs = []
    for rid in range(REQUESTS):
        prompt = rng.integers(0, SMALL.vocab,
                              size=int(rng.integers(4, 24))).astype(np.int32)
        req = Request(rid, prompt, max_new_tokens=int(rng.integers(8, 24)))
        reqs.append(req)
        engine.submit(req)

    t0 = time.perf_counter()
    ticks = 0
    while engine.queue or any(r is not None for r in engine.slot_req):
        engine.step()
        ticks += 1
    dt = time.perf_counter() - t0

    tokens = sum(len(r.out) for r in reqs)
    assert all(len(r.out) == r.max_new_tokens for r in reqs)
    print(f"{len(reqs)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s, {ticks} ticks on {SLOTS} slots)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}...")
    return reqs


if __name__ == "__main__":
    main()
