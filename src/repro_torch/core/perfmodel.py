"""Port-limited analytical performance model.

A PE absorbs one tuple every II_pe cycles and the memory interface feeds W
tuples per cycle (Eq. 1), so a chunk of T tuples whose busiest effective PE
absorbs L tuples takes

    cycles(chunk) = max(T / W, L * II_pe)

in float32, as in the JAX reference.  This is what the throughput monitor
observes and what the Fig. 2 / Fig. 7 headlines report.  (The reference's
``throughput``/``uniform_cycles``/``reschedule_overhead_cycles`` serve its
benches, which a later slice ports.)
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
