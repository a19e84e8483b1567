"""Int8 gradient compression with error feedback: the PyTorch counterpart
of ``repro/optim/compression.py``.

Each leaf is quantized to int8 per trailing row and dequantized (the wire
format of a compressed all-reduce); the quantization error is carried to
the next step per leaf.  Used by ``train.loop`` when ``compress_grads``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map, tree_unzip

_Q = 127.0


class CompressionState(NamedTuple):
    error: Any   # per-leaf float32 residual (error feedback memory)


def init_compression(params) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def compress_decompress(grads, state: CompressionState):
    """grads -> (dequantized grads, new state).  Per-trailing-row int8."""
    def one(g, e):
        g = g.float() + e
        scale = torch.amax(torch.abs(g), dim=-1, keepdim=True) / _Q
        q = torch.round(g / torch.clamp(scale, min=1e-30)).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq, g - deq

    deq, err = tree_unzip(tree_map(one, grads, state.error), 2)
    return deq, CompressionState(error=err)
