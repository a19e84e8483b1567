"""HISTO -- equi-width histogram building (paper Listing 1 / Table I).

``num_bins`` counters partitioned across M PriPEs: bin b lives in PriPE
b % M at local index b // M.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import DittoSpec


def bin_of_np(keys: np.ndarray, num_bins: int, key_domain: int) -> np.ndarray:
    width = max(key_domain // num_bins, 1)
    return np.minimum(keys // width, num_bins - 1)


def make_spec(num_bins: int, key_domain: int, num_pri: int) -> DittoSpec:
    """Equi-width HISTO spec for a known M (local buffer = ceil(bins / M))."""
    bins_per_pe = -(-num_bins // num_pri)
    width = max(key_domain // num_bins, 1)

    def pre(chunk, num_pri_):
        key = chunk[..., 0]
        b = torch.clamp(key.to(torch.int32) // width, max=num_bins - 1)
        return ((b % num_pri_).to(torch.int32), (b // num_pri_).to(torch.int32),
                torch.ones_like(key, dtype=torch.int32))

    return DittoSpec(
        name="histo", pre=pre,
        init_buffer=lambda n, device: torch.zeros((n, bins_per_pe),
                                                  dtype=torch.int32, device=device),
        combine="add", tuple_bytes=8, ii_pre=1, ii_pe=2)


def oracle(keys: np.ndarray, num_bins: int, key_domain: int,
           num_pri: int) -> np.ndarray:
    """Sequential oracle: merged [num_pri, bins_per_pe] partitioned histogram."""
    b = bin_of_np(keys.astype(np.int64), num_bins, key_domain)
    dst = b % num_pri
    idx = b // num_pri
    out = np.zeros((num_pri, -(-num_bins // num_pri)), np.int64)
    np.add.at(out, (dst, idx), 1)
    return out


def flat_histogram(merged: np.ndarray, num_bins: int) -> np.ndarray:
    """[M, bins_per_pe] partitioned buffers -> flat [num_bins] histogram
    (bin b = merged[b % M, b // M]): data routing gives the final bins
    directly, with no aggregation on the host (paper §II-A)."""
    m, _ = merged.shape
    b = np.arange(num_bins)
    return merged[b % m, b // m]
