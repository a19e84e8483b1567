"""HHD -- heavy-hitter detection with a count-min sketch (paper Table I).

Keys route by murmur3 (dst PE = h(key) % M); each PE owns a private
count-min sketch of D rows x W columns over its key subrange.  The sketch
is linear, so the ``add`` merge folds SecPE shadow sketches exactly.  The
estimate of key k is min_i sketch[pe(k), i, h_i(k)]; the heavy hitters are
the keys whose estimate reaches a threshold.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.hashes import murmur3_fmix32, murmur3_fmix32_np
from repro_torch.core.types import DittoSpec
from repro_torch.kernels import dispatch

ROW_SEEDS = (0x9E3779B9, 0x7F4A7C15, 0x94D049BB, 0xD6E8FEB8)


def _route(key: torch.Tensor, depth: int, width: int,
           num_pri: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(PE [...], the D row columns [..., D]) of each key, int64: the PE is
    h(key) % M, row i's column h_i(key) & (W - 1).  The sketch's update and
    its point query both route through here."""
    pe = murmur3_fmix32(key) % num_pri
    cols = torch.stack([murmur3_fmix32(key, seed=ROW_SEEDS[i]) & (width - 1)
                        for i in range(depth)], dim=-1)
    return pe, cols


def make_spec(depth: int, width: int, num_pri: int) -> DittoSpec:
    """CMS spec.  ``idx`` carries the D per-row columns as a [T, D] int32
    tensor; the PE update is the ``cms_update`` kernel (the plain version on
    the CPU), folding the chunk into the carried sketch in place."""
    if depth > len(ROW_SEEDS):
        raise ValueError(f"depth must be <= {len(ROW_SEEDS)}, got {depth}")
    if width & (width - 1):
        raise ValueError(f"width must be a power of two, got {width}")

    def pre(chunk, num_pri_):
        key = chunk[..., 0]
        dst, cols = _route(key, depth, width, num_pri_)
        return (dst.to(torch.int32), cols.to(torch.int32),
                torch.ones(key.shape, dtype=torch.int32, device=key.device))

    def init_buffer(num_pe, device):
        return torch.zeros((num_pe, depth, width), dtype=torch.int32, device=device)

    return DittoSpec(name="hhd", pre=pre, init_buffer=init_buffer,
                     combine="add", pe_update=dispatch.cms_update,
                     tuple_bytes=8, ii_pre=1, ii_pe=2)


def oracle(keys: np.ndarray, depth: int, width: int, num_pri: int) -> np.ndarray:
    out = np.zeros((num_pri, depth, width), np.int64)
    pe = (murmur3_fmix32_np(keys) % np.uint32(num_pri)).astype(np.int64)
    for i in range(depth):
        col = (murmur3_fmix32_np(keys, seed=ROW_SEEDS[i])
               & np.uint32(width - 1)).astype(np.int64)
        np.add.at(out, (pe, i, col), 1)
    return out


def estimate(merged, keys, depth: int, width: int) -> torch.Tensor:
    """CMS point query: min over rows of ``merged[pe(k), i, h_i(k)]`` on the
    merged [M, D, W] sketches, on ``merged``'s device.

    ``merged`` and ``keys`` are tensors or numpy arrays; numpy keys move to
    ``merged``'s device.  Returns one estimate a key, in ``merged``'s dtype
    (int32 from a run, int64 from ``oracle``)."""
    merged = torch.as_tensor(merged)
    keys = torch.as_tensor(keys, device=merged.device)
    pe, cols = _route(keys, depth, width, merged.shape[0])
    rows = torch.arange(depth, device=merged.device)
    return merged[pe[..., None], rows, cols].amin(-1)


def heavy_hitters(merged, candidate_keys, depth: int, width: int,
                  threshold: int) -> torch.Tensor:
    """The candidates whose CMS estimate is at least ``threshold``, in the
    candidates' order, on ``merged``'s device.  CMS only overestimates, so
    recall is 1 (every true heavy hitter among the candidates is
    returned)."""
    merged = torch.as_tensor(merged)
    keys = torch.as_tensor(candidate_keys, device=merged.device)
    return keys[estimate(merged, keys, depth, width) >= threshold]
