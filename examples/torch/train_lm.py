"""End-to-end example on PyTorch: train a small LM for a few hundred steps
on the card (or the CPU with ``--device cpu``).

    PYTHONPATH=src python examples/torch/train_lm.py             # ~20M, quick
    PYTHONPATH=src python examples/torch/train_lm.py --big       # ~100M params

Uses the full production stack: zoo model, AdamW + warmup-cosine, the
train step, async atomic checkpointing with resume, preemption guard,
straggler telemetry.  The same entry point scales to the assigned
architectures via --arch (``repro_torch.launch.train``).  Attention runs
in the hand-written flash kernels on the card, forward and backward.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import synthetic_batches
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.train import loop as TL

SMALL = ArchConfig(
    name="lm-20m", family="dense", num_layers=6, d_model=384,
    num_heads=6, num_kv_heads=2, head_dim=64, d_ff=1024, vocab=8192,
    block_pattern=("attn",), ffn_pattern=("dense",),
    compute_dtype="float32")

BIG = dataclasses.replace(SMALL, name="lm-100m", num_layers=12,
                          d_model=768, num_heads=12, num_kv_heads=4,
                          d_ff=2048, vocab=16384)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "ditto_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = BIG if args.big else SMALL
    model = zoo.build(cfg, args.device)
    print(f"{cfg.name}: {zoo.param_count(cfg)/1e6:.1f}M params")
    opt = make_optimizer("adamw", warmup_cosine(3e-4, 20, args.steps))
    data = synthetic_batches(cfg, args.batch, args.seq, seed=0, device=model.device)
    state = TL.train(model, opt, data, num_steps=args.steps,
                     ckpt_dir=args.ckpt, ckpt_every=100, log_every=20)
    print(f"done at step {int(state.step)}; checkpoints in {args.ckpt}")
    return state


if __name__ == "__main__":
    main()
