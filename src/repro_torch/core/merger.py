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
    plan's assignment (-1 = idle SecPE, whose buffer is dropped).  Does not
    modify ``buffers``."""
    pri = buffers[:num_pri]
    sec = buffers[num_pri:]
    if sec.shape[0] == 0:
        return pri.clone()
    seg = torch.where(assignment >= 0, assignment, num_pri).long()
    target = torch.empty((num_pri + 1, *sec.shape[1:]), dtype=sec.dtype,
                         device=sec.device)
    if combine == "add":
        folded = target.zero_().index_add_(0, seg, sec)
        return pri + folded[:num_pri]
    if combine == "max":
        # A neutral-filled target: a PriPE no SecPE shadows keeps its value.
        index = seg.view(-1, *([1] * (sec.dim() - 1))).expand_as(sec)
        folded = target.fill_(max_identity(sec.dtype)).scatter_reduce_(
            0, index, sec, "amax", include_self=True)
        return torch.maximum(pri, folded[:num_pri])
    raise ValueError(combine)


def reset_sec_buffers(buffers: torch.Tensor, num_pri: int,
                      combine: str) -> torch.Tensor:
    """Buffers with the SecPE shadows set to 0 (add) or the max identity
    (max), so a re-assigned SecPE never leaks another PriPE's partial
    state.  Does not modify ``buffers``."""
    out = buffers.clone()
    out[num_pri:] = 0 if combine == "add" else max_identity(buffers.dtype)
    return out
