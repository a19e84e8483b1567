"""The merger module (paper §IV-B).

At the end of a stream, and on every re-schedule, the SecPE shadow buffers
fold into the PriPE whose local index space they shadow: ``add`` for
counting state (HISTO, HHD), ``max`` for register state (HLL).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import max_identity


def merge_buffers(buffers: torch.Tensor, assignment: torch.Tensor,
                  num_pri: int, combine: str) -> torch.Tensor:
    """Merged [M, *local] PriPE buffers from [M+X, *local] buffers and the
    plan's assignment (-1 = idle SecPE, whose buffer is dropped).  With a
    leading lanes axis (buffers [L, M+X, *local], assignment [L, X]) each
    lane merges on its own -> [L, M, *local].  Does not modify ``buffers``."""
    ax = assignment.dim() - 1               # the PE axis
    pri = buffers.narrow(ax, 0, num_pri)
    sec = buffers.narrow(ax, num_pri, buffers.shape[ax] - num_pri)
    if sec.shape[ax] == 0:
        return pri.clone()
    seg = torch.where(assignment >= 0, assignment, num_pri).long()
    local = sec.shape[ax + 1:]
    lanes = assignment.shape[:-1]
    if lanes:       # lane l folds into its own M + 1 rows
        seg = (seg + torch.arange(lanes.numel(), device=seg.device).view(*lanes, 1)
               * (num_pri + 1)).reshape(-1)
        sec = sec.reshape(-1, *local)
    target = torch.empty((lanes.numel() * (num_pri + 1), *local), dtype=sec.dtype,
                         device=sec.device)
    if combine == "add":
        folded = target.zero_().index_add_(0, seg, sec)
        return pri + folded.view(*lanes, num_pri + 1, *local).narrow(ax, 0, num_pri)
    if combine == "max":
        # A neutral-filled target: a PriPE no SecPE shadows keeps its value.
        index = seg.view(-1, *([1] * len(local))).expand_as(sec)
        folded = target.fill_(max_identity(sec.dtype)).scatter_reduce_(
            0, index, sec, "amax", include_self=True)
        return torch.maximum(pri, folded.view(*lanes, num_pri + 1, *local)
                             .narrow(ax, 0, num_pri))
    raise ValueError(combine)


def reset_sec_buffers(buffers: torch.Tensor, num_pri: int, combine: str,
                      pe_axis: int = 0) -> torch.Tensor:
    """Buffers with the SecPE shadows set to 0 (add) or the max identity
    (max), so a re-assigned SecPE never leaks another PriPE's partial
    state; ``pe_axis`` 1 for buffers with a leading lanes axis.  Does not
    modify ``buffers``."""
    out = buffers.clone()
    out.narrow(pe_axis, num_pri, out.shape[pe_axis] - num_pri).fill_(
        0 if combine == "add" else max_identity(buffers.dtype))
    return out
