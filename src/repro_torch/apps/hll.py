"""HLL -- HyperLogLog cardinality estimation with murmur3 (paper Table I).

2^P registers; register index = low P bits of murmur3(key), register value
= max over the stream of (leading zeros of the remaining 32-P hash bits)
+ 1.  The register file is partitioned across M PriPEs (register r -> PE
r % M, local r // M); combine = ``max``, which is exactly the HLL merge.
``estimate`` turns the merged registers into the cardinality.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.hashes import clz32, murmur3_fmix32, murmur3_fmix32_np
from repro_torch.core.types import DittoSpec


def _rho_np(h: np.ndarray, width: int) -> np.ndarray:
    """Leading-zero count of the top ``width`` bits + 1 (the HLL rho)."""
    out = np.full(h.shape, width + 1, np.int32)
    found = np.zeros(h.shape, bool)
    for b in range(width):
        bit = (h >> np.uint32(width - 1 - b)) & np.uint32(1)
        hit = (bit == 1) & ~found
        out[hit] = b + 1
        found |= hit
    return out


def make_spec(p_bits: int, num_pri: int) -> DittoSpec:
    num_regs = 1 << p_bits
    regs_per_pe = -(-num_regs // num_pri)

    def pre(chunk, num_pri_):
        h = murmur3_fmix32(chunk[..., 0])
        reg = h & (num_regs - 1)
        # rho = leading zeros within the top 32-P bits + 1, from an exact
        # integer clz (clz(0) = 32 gives rho = 33-P when rest == 0); a float
        # log2 would mis-round near powers of two.
        rho = clz32(h >> p_bits) - p_bits + 1
        return ((reg % num_pri_).to(torch.int32),
                (reg // num_pri_).to(torch.int32), rho)

    def init_buffer(num_pe, device):
        return torch.zeros((num_pe, regs_per_pe), dtype=torch.int32, device=device)

    return DittoSpec(name="hll", pre=pre, init_buffer=init_buffer,
                     combine="max", tuple_bytes=8, ii_pre=1, ii_pe=2)


def oracle(keys: np.ndarray, p_bits: int, num_pri: int) -> np.ndarray:
    num_regs = 1 << p_bits
    h = murmur3_fmix32_np(keys)
    reg = (h & np.uint32(num_regs - 1)).astype(np.int64)
    rest = (h >> np.uint32(p_bits)).astype(np.uint32)
    rho = _rho_np(rest, 32 - p_bits)
    out = np.zeros((num_pri, -(-num_regs // num_pri)), np.int32)
    np.maximum.at(out, (reg % num_pri, reg // num_pri), rho)
    return out


def estimate(merged, p_bits: int) -> float:
    """Cardinality estimate from merged partitioned registers [M, 2^P / M]
    (a tensor on any device, or numpy), with the standard small-range
    linear-counting correction.

    The 2^P registers are read to the host and reduced in float64 numpy,
    as the JAX package does: a reduction on the card would sum in another
    order and lose bit-equality for a few KB of work."""
    if isinstance(merged, torch.Tensor):
        merged = merged.cpu().numpy()
    m = 1 << p_bits
    mm = merged.shape[0]
    r = np.arange(m)
    regs = merged[r % mm, r // mm].astype(np.float64)
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    est = alpha * m * m / np.sum(2.0 ** (-regs))
    zeros = int((regs == 0).sum())
    if est <= 2.5 * m and zeros > 0:
        est = m * np.log(m / zeros)
    return float(est)
