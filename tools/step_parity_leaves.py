#!/usr/bin/env python3
"""One float32 training step of a config's first layers on the card and on
the CPU, leaf by leaf: where the two steps differ most.

    python3 tools/step_parity_leaves.py mamba2-780m 2 512

runs ``make_train_step`` (the config's optimizer at a constant max_lr,
clip 1.0, TF32 off) at full width with ARCH's first LAYERS layers on
seeded weights and a seeded [1, TOKENS] batch, once on the card and once
on the CPU (each on its own gradients), then prints one JSON line a leaf,
worst first (the top ``--top``, default 8): the params' max |card - CPU| /
max |CPU| after the step (``param_rel``, chip_smoke.py's measure), the
gradients' (``grad_rel``), and at the element where the params differ
most its value before the step, after it on both, and both gradients.
``phase G (d')`` of chip_smoke.py holds the card's step against the CPU's
optimizer applied to the card's gradients; this shows why it does not
hold it against the CPU's own step.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in the order of ``tree_leaves`` (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, x in enumerate(tree) for pair in named_leaves(x, f"{prefix}/{i}")]
    return [(prefix, tree)]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("layers", type=int)
    ap.add_argument("tokens", type=int)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_parity_leaves: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    from chip_smoke import SEED, lm_train_batch
    from repro_torch.configs import get
    from repro_torch.models import zoo
    from repro_torch.models.transformer import tree_to
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.state import TrainState
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    cfg = dataclasses.replace(get(args.arch), num_layers=args.layers, compute_dtype="float32")
    model = zoo.build(cfg, device=dev)
    before = tree_to(model.init_params(model.generator(SEED)), cpu)
    batch = lm_train_batch(cfg, (1, args.tokens), cpu, seed=SEED + 7)
    runs = []
    for where in (dev, cpu):
        model = zoo.build(cfg, device=where)
        params = tree_to(before, where)
        opt = make_optimizer(cfg.optimizer, constant(cfg.max_lr))
        seen = {}

        def update(grads, state, params, step, _update=opt.update):
            seen["grads"] = grads
            return _update(grads, state, params, step)

        opt = dataclasses.replace(opt, update=update)
        state = TrainState(step=torch.zeros((), dtype=torch.int32, device=where),
                           params=params, opt_state=opt.init(params))
        new, m = make_train_step(model, opt)(state, {k: v.to(where) for k, v in batch.items()})
        runs.append((float(m["loss"]), float(m["grad_norm"]), tree_to(seen["grads"], cpu),
                     tree_to(new.params, cpu)))
        del model, params, state, new, seen
        torch.cuda.empty_cache()
    (l_card, n_card, g_card, p_card), (l_cpu, n_cpu, g_cpu, p_cpu) = runs
    print(json.dumps({"arch": cfg.name, "layers": args.layers, "tokens": args.tokens,
                      "lr": cfg.max_lr, "loss": [l_card, l_cpu], "grad_norm": [n_card, n_cpu]}))
    rows = []
    for (path, a), (_, b), (_, ga), (_, gb), (_, p0) in zip(
            named_leaves(p_card), named_leaves(p_cpu), named_leaves(g_card),
            named_leaves(g_cpu), named_leaves(before)):
        scale = float(b.abs().max()) or 1.0
        diff = (a - b).abs()
        i = int(diff.argmax())
        rows.append({"leaf": path, "shape": list(b.shape),
                     "param_rel": float(diff.max()) / scale,
                     "grad_rel": float((ga - gb).abs().max()) / (float(gb.abs().max()) or 1.0),
                     "p_before": float(p0.reshape(-1)[i]), "p_card": float(a.reshape(-1)[i]),
                     "p_cpu": float(b.reshape(-1)[i]), "g_card": float(ga.reshape(-1)[i]),
                     "g_cpu": float(gb.reshape(-1)[i]), "leaf_max_after": scale})
    for row in sorted(rows, key=lambda r: -r["param_rel"])[:args.top]:
        print(json.dumps(row))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
