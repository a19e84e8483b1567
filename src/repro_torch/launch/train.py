"""Training launcher: the port's counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt /tmp/ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        --steps 4 --ckpt build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch jamba-1.5-large-398b --reduced --steps 20 --seq 64

The JAX CLI plus ``--device`` (default ``cuda``, which raises without a
CUDA device).  ``--arch`` takes every config: dense, MoE (the pack and
unpack kernels are each other's gradient), MLA, SSM, the hybrid (with its
config's ``adamw8bit``), the VLM and whisper.  ``--reduced`` takes the
REDUCED config; without it the full one.  With
``--ckpt`` it resumes from the directory's newest checkpoint and writes one
at the end (and every ``--ckpt-every`` steps).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get, get_reduced
from repro_torch.models import frontends as F
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.train import loop as TL


def synthetic_batches(cfg, batch: int, seq: int, seed: int = 0, device="cpu"):
    """Synthetic LM stream: power-law token draws (Zipf 1.3 over the vocab,
    numpy, seeded) with next-token labels; whisper's frames and the VLM's
    patches from a generator seeded the same way, the same every batch (as
    the JAX launcher's fixed key gives)."""
    rng = np.random.default_rng(seed)
    st = seq - cfg.num_patches if cfg.num_patches else seq
    while True:
        ranks = rng.zipf(1.3, size=(batch, st + 1)).astype(np.int64)
        toks = torch.as_tensor((ranks - 1) % cfg.vocab, dtype=torch.int32, device=device)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        gen = torch.Generator(device=device).manual_seed(seed)
        if cfg.family == "encdec":
            out["frames"] = F.random_frames(cfg, gen, batch)
        if cfg.num_patches:
            out["patches"] = F.random_patches(cfg, gen, batch)
        yield out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the REDUCED config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get(args.arch)
    model = zoo.build(cfg, device=args.device)
    opt = make_optimizer(cfg.optimizer,
                         warmup_cosine(args.lr or cfg.max_lr,
                                       max(args.steps // 20, 1), args.steps))
    data = synthetic_batches(cfg, args.batch, args.seq, args.seed, model.device)
    state = TL.train(model, opt, data, num_steps=args.steps,
                     ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                     log_every=args.log_every, seed=args.seed,
                     compress_grads=args.compress_grads)
    print(f"finished at step {int(state.step)}")
    return state


if __name__ == "__main__":
    main()
