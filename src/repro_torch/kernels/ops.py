"""Plain tensor ops around the kernels that need no kernel of their own."""
from __future__ import annotations

import torch


def occurrence_rank(eff: torch.Tensor, num_pe: int) -> torch.Tensor:
    """Within-group slot of each tuple for its PE (the mapper's round-robin
    position): ``rank[g, t] = #{s < t : eff[g, s] == eff[g, t]}``.

    eff [G, T] -> int32 [G, T].  The one-hot prefix count of
    ``repro/kernels/ops.occurrence_rank`` per group, with the scan along the
    last axis ([G, num_pe, T]): a CUDA scan over an outer axis is far slower
    (PERF.md, PR 11).  An eff outside [0, num_pe) reads the count of the
    nearest PE; the kernels drop its tuple whatever its slot."""
    pes = torch.arange(num_pe, dtype=eff.dtype, device=eff.device)
    onehot = (eff[:, None, :] == pes[None, :, None]).to(torch.int32)
    excl = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    return excl.gather(1, eff.clamp(0, num_pe - 1).long()[:, None, :])[:, 0]
