"""Zipf-distributed tuple streams (paper §II-B / §VI-C / §VI-D).

The paper profiles HISTO with 26 M 8-byte tuples under Zipf(alpha) over the
key domain, alpha in {0 (uniform), ..., 3 (extreme)}, and builds the
evolving-skew benchmark (Fig. 9) by re-seeding the generator every interval.

We implement bounded-domain Zipf by inverse-CDF sampling over the ranked key
domain (numpy's ``random.zipf`` is unbounded and useless for a fixed bin
count), plus a per-seed random permutation of the rank->key mapping so that
"which PE is hot" varies with the seed exactly like the paper's Fig. 9 setup.
"""
from __future__ import annotations

import numpy as np


def _zipf_pmf(domain: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    w = ranks ** (-alpha) if alpha > 0 else np.ones_like(ranks)
    return w / w.sum()


def zipf_keys(n: int, domain: int, alpha: float, seed: int = 0,
              permute: bool = True) -> np.ndarray:
    """n int64 keys in [0, domain) with Zipf(alpha) popularity.

    alpha = 0 is uniform.  ``permute`` shuffles which keys are popular
    (rank->key map), seed-dependent, as in the paper's evolving-skew setup.
    """
    rng = np.random.default_rng(seed)
    pmf = _zipf_pmf(domain, alpha)
    cdf = np.cumsum(pmf)
    u = rng.random(n)
    ranks = np.searchsorted(cdf, u, side="right")
    ranks = np.minimum(ranks, domain - 1)
    if permute:
        perm = rng.permutation(domain)
        return perm[ranks].astype(np.int64)
    return ranks.astype(np.int64)


def zipf_tuples(n: int, domain: int, alpha: float, seed: int = 0,
                permute: bool = True) -> np.ndarray:
    """8-byte tuples <key:int32, value:int32> as an [n, 2] int32 array
    (the paper's tuple format throughout)."""
    keys = zipf_keys(n, domain, alpha, seed, permute)
    rng = np.random.default_rng(seed + 1)
    values = rng.integers(0, 2**31 - 1, size=n, dtype=np.int64)
    return np.stack([keys, values], axis=1).astype(np.int32)


def evolving_zipf_tuples(n_total: int, domain: int, alpha: float,
                         interval_tuples: int, seed: int = 0) -> np.ndarray:
    """Fig. 9 workload: every ``interval_tuples`` the generator is re-seeded,
    moving the hot key set while keeping alpha fixed."""
    out = []
    produced, phase = 0, 0
    while produced < n_total:
        take = min(interval_tuples, n_total - produced)
        out.append(zipf_tuples(take, domain, alpha, seed=seed + 1000 * phase))
        produced += take
        phase += 1
    return np.concatenate(out, axis=0)
