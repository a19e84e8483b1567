"""Bounded Zipf tuple streams, drawn on the device from the seed.

The law is a frozen copy of ``repro_torch.data.zipf``'s: inverse-CDF
sampling over the ranked key domain, then a seeded permutation of which
keys are popular.  The random source is a ``torch.Generator`` on the
device, so that whole datasets of the paper's size are made in a few
large calls.  ``tests/test_perfbench_frozen.py`` holds the law equal to
the program's: fed the program's uniforms and permutation, ``keys_of``
gives the program's keys.
"""
from __future__ import annotations

import numpy as np


def _zipf_pmf(domain: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    w = ranks ** (-alpha) if alpha > 0 else np.ones_like(ranks)
    return w / w.sum()


def cdf(domain: int, alpha: float) -> np.ndarray:
    """float64 [domain]: the cumulative law of ranks 1..domain."""
    return np.cumsum(_zipf_pmf(domain, alpha))


def keys_of(u, cdf_t, perm):
    """Keys of the uniforms ``u`` (float64 tensor): each one's rank under
    ``cdf_t``, mapped to a key by ``perm`` (int64 tensors)."""
    import torch
    ranks = torch.searchsorted(cdf_t, u, right=True).clamp_(max=len(cdf_t) - 1)
    return perm[ranks]


def zipf_tuples(n: int, domain: int, alpha: float, seed: int, device):
    """int32 [n, 2] tuples <key, value> on ``device``: keys Zipf(alpha) over
    [0, domain) (alpha 0 is uniform), values uniform over [0, 2^31 - 1)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    perm = torch.randperm(domain, generator=gen, device=device)
    keys = keys_of(u, torch.as_tensor(cdf(domain, alpha), device=device), perm)
    del u
    values = torch.randint(0, 2**31 - 1, (n,), generator=gen, device=device)
    return torch.stack([keys, values], 1).to(torch.int32)


def derive(seed: int, *parts: int) -> int:
    """A 62-bit seed for one stream of the run, from the run's seed and
    the stream's coordinates."""
    s = seed % (1 << 126)
    ss = np.random.SeedSequence([s & ((1 << 63) - 1), s >> 63, *parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(2))
