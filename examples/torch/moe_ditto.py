"""Ditto-MoE demo on PyTorch: the paper's skew-oblivious routing as an MoE
feature.

A deliberately skewed router sends most tokens to a few hot experts;
capacity is provisioned for the uniform load (the BRAM analogue).  The
sweep shows dropped-token rate vs number of secondary expert slots --
paper Fig. 7 transplanted to the MoE problem (DESIGN.md §2).  On the card
the pack and unpack run in the hand-written ``onehot_dispatch`` and
``onehot_combine`` kernels.

    PYTHONPATH=src python examples/torch/moe_ditto.py [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import moe as MOE

E, K, D, FF, T = 16, 2, 64, 128, 2048
GROUP = 512


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = MOE.moe_params(torch.Generator(dev).manual_seed(0), D, FF, E)
    bias = torch.tensor([4.0 / (i + 1) ** 1.2 for i in range(E)], device=dev)
    params = dict(params, router=params["router"] * 0.0 + bias[None, :])
    x = torch.randn((1, T, D), generator=torch.Generator(dev).manual_seed(1),
                    device=dev)

    rows = []
    print(f"{'slots':10s} {'drop rate':>10s} {'max slot load':>14s}")
    with torch.no_grad():
        for xs in (0, 2, 4, 8, E - 1):
            y, aux = MOE.moe_apply(params, x, num_experts=E, top_k=K,
                                   num_secondary=xs, group_size=GROUP)
            assert y.shape == x.shape and bool(torch.isfinite(y).all())
            drop, load = float(aux["drop_frac"]), int(aux["max_slot_load"])
            print(f"{E}P+{xs:<2d}S    {drop:10.3f} {load:14d}")
            rows.append({"secondary": xs, "drop_frac": drop, "max_slot_load": load})
    print("\n(the 'add' merge of shadow buffers is the gate-weighted combine;"
          "\n secondary slots compute with their primary expert's weights)")
    return rows


if __name__ == "__main__":
    main()
