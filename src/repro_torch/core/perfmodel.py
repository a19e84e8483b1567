"""Port-limited analytical performance model.

A PE absorbs one tuple every II_pe cycles and the memory interface feeds W
tuples per cycle (Eq. 1), so a chunk of T tuples whose busiest effective PE
absorbs L tuples takes

    cycles(chunk) = max(T / W, L * II_pe)

in float32, as in the JAX reference.  This is what the throughput monitor
observes and what the Fig. 2 / Fig. 7 / Fig. 9 headlines report.

Every float32 division here has a float32 tensor divisor on the dividend's
device: CUDA divides by a CPU scalar as a multiply by its reciprocal, which
can differ from the reference in the last bit.
"""
from __future__ import annotations

import numpy as np
import torch


def chunk_cycles(chunk_size: int, max_load: torch.Tensor,
                 mem_width_tuples: int, ii_pe: int) -> torch.Tensor:
    """Port-limited cycles to drain one chunk (float32 tensor)."""
    # T / W in float32 is a constant; clamping by it keeps it off the device.
    feed = float(np.float32(chunk_size) / np.float32(mem_width_tuples))
    return torch.clamp(max_load.to(torch.float32) * ii_pe, min=feed)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def throughput(chunk_size, cycles) -> torch.Tensor:
    """Tuples per cycle (float32); cycles below 1 count as 1."""
    cycles = _f32(cycles)
    return _f32(chunk_size, cycles.device) / torch.clamp(cycles, min=1.0)


def uniform_cycles(chunk_size, mem_width_tuples: int) -> torch.Tensor:
    """Cycles to drain a chunk at the full memory rate (float32)."""
    chunk = _f32(chunk_size)
    return chunk / _f32(mem_width_tuples, chunk.device)


def reschedule_overhead_cycles(freq_mhz: float = 200.0, overhead_ms: float = 1.0):
    """Kernel dequeue/enqueue overhead of a SecPE re-schedule, in cycles.
    The paper observes throughput dips when the skew-change interval is
    within an order of magnitude of this overhead (Fig. 9)."""
    return overhead_ms * 1e-3 * freq_mhz * 1e6
