"""Hash functions shared by the applications (paper Table I).

HLL and HHD use the 32-bit murmur3 fmix avalanche finalizer, DP a radix
hash.  Each has a torch and a numpy twin that agree bit for bit (the
executor and the oracles must hash identically).

Torch on the CPU has no ``>>`` or ``%`` on uint32, so the torch versions
compute in int64 and mask with ``& 0xFFFFFFFF`` after each multiply: int64
multiplication wraps modulo 2**64, which keeps the low 32 bits exact.  They
return int64 tensors holding the uint32 values.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)


def murmur3_fmix32_np(x: np.ndarray, seed: int = 0) -> np.ndarray:
    h = x.astype(np.uint32) ^ np.uint32(seed)
    h ^= h >> np.uint32(16)
    h = (h * _C1).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * _C2).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h


def murmur3_fmix32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """fmix32 of the low 32 bits of ``x`` -> int64 in [0, 2**32)."""
    h = (x.to(torch.int64) & _MASK) ^ seed
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK
    return h ^ (h >> 16)


def radix_np(x: np.ndarray, bits: int) -> np.ndarray:
    """DP's radix hash: the low ``bits`` bits of the key."""
    return (x.astype(np.uint32) & np.uint32((1 << bits) - 1)).astype(np.int64)


def radix(x: torch.Tensor, bits: int) -> torch.Tensor:
    return (x.to(torch.int64) & ((1 << bits) - 1)).to(torch.int32)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Exact count of leading zeros of 32-bit values held in an int64
    tensor (clz(0) = 32), by binary search on integer compares."""
    n = torch.zeros_like(x, dtype=torch.int32)
    y = x
    for bits, below in ((16, 0x0000FFFF), (8, 0x00FFFFFF), (4, 0x0FFFFFFF),
                        (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        small = y <= below
        n = n + small.to(torch.int32) * bits
        y = torch.where(small, y << bits, y)
    return torch.where(x == 0, 32, n)
