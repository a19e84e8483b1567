"""The skew analyzer (paper §V-D, Eq. 2) and implementation selection.

Offline: sample a small fraction of the dataset (the paper samples 0.1%),
histogram the designated PriPE ids and compute the number of SecPEs

    X = sum_i ceil(M * w_i / sum(w) - T) - M        (Eq. 2)

clipped to [0, M-1], with each term floored at 1 (see
``secpes_for_workload``).  Online: no prior information, so X = M-1.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.profiler import workload_hist


def secpes_for_workload(workload: torch.Tensor, tolerance: float) -> int:
    """Eq. 2: X from a sampled per-PriPE workload (float32 arithmetic, as
    in the JAX reference).  A PriPE owns its range even when the sample gave
    it no tuple, so each term is at least 1; with strictly positive sampled
    workloads this is Eq. 2 as printed."""
    m = workload.shape[0]
    w = workload.to(torch.float32)
    total = torch.clamp(w.sum(), min=1.0)
    terms = torch.clamp(torch.ceil(m * w / total - tolerance), min=1.0)
    return int(torch.clamp(terms.sum() - m, 0, m - 1).item())


def analyze_skew(sample_dst: torch.Tensor, num_pri: int, tolerance: float) -> int:
    """Sampled skew analysis -> number of SecPEs (a Python int: X picks the
    generated implementation)."""
    return secpes_for_workload(workload_hist(sample_dst, num_pri), tolerance)


def sample_dataset(keys: np.ndarray, frac: float = 0.001, seed: int = 0,
                   min_samples: int = 4096) -> np.ndarray:
    """Random sample of the dataset for the offline analysis (paper: 0.1%)."""
    rng = np.random.default_rng(seed)
    n = max(min_samples, int(len(keys) * frac))
    n = min(n, len(keys))
    idx = rng.choice(len(keys), size=n, replace=False)
    return keys[idx]


def select_implementation(dst_sample: torch.Tensor, num_pri: int,
                          tolerance: float = 0.01, online: bool = False) -> int:
    """The X of least buffer cost that meets the Eq. 2 guarantee (offline),
    or M-1 for online streams."""
    if online:
        return num_pri - 1
    return analyze_skew(dst_sample, num_pri, tolerance)


def buffer_capacity_fraction(num_pri: int, num_sec: int) -> float:
    """§V-C: with X SecPEs the buffered distinct data is M/(M+X) of the
    budget; X = M-1 still guarantees half."""
    return num_pri / (num_pri + num_sec)
