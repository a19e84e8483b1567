"""The public op API over the kernels, as ``repro/kernels/ops.py`` has it.

Each op is functional (it returns a fresh tensor) and goes through
``dispatch``, so the tensor's device decides: the plain version on the CPU,
the hand-written kernel on a CUDA device (its ``launches`` counter moves).
There is no ``backend=``/``use_kernel=`` and there are no block sizes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch


def scatter_accumulate(flat_idx: torch.Tensor, value: torch.Tensor, num_bins: int,
                       combine: str = "add") -> torch.Tensor:
    """``value`` [T] folded (add|max) into ``num_bins`` fresh cells at
    ``flat_idx`` [T]; out-of-range indices are dropped, and ``max`` starts
    from zeros.  On the card through ``route_accumulate``."""
    return dispatch.scatter_accumulate(flat_idx, value, num_bins, combine)


def cms_update(eff: torch.Tensor, cols: torch.Tensor, value: torch.Tensor,
               num_pe: int, depth: int, width: int) -> torch.Tensor:
    """Count-min sketch update into a fresh [num_pe, depth, width] sketch of
    ``value``'s dtype: ``out[eff[t], d, cols[t, d]] += value[t]``; eff
    outside [0, num_pe) (padding -1, the sentinel num_pe) is dropped."""
    sketch = torch.zeros((num_pe, depth, width), dtype=value.dtype, device=value.device)
    return dispatch.cms_update(sketch, dispatch.int32_indices(eff, num_pe),
                               dispatch.int32_indices(cols, width), value.contiguous())


def onehot_dispatch(eff: torch.Tensor, slot: torch.Tensor, values: torch.Tensor,
                    num_pe: int, capacity: int) -> torch.Tensor:
    """Pack values [T, D] into [num_pe, capacity, D] slots at (eff, slot)
    [T]; tuples with eff outside [0, num_pe) or slot outside
    [0, capacity) are dropped, duplicate cells sum."""
    return dispatch.onehot_dispatch(eff[None], slot[None], values[None],
                                    num_pe, capacity)[0]


def onehot_combine(eff: torch.Tensor, slot: torch.Tensor, packed: torch.Tensor,
                   gate: torch.Tensor | None = None) -> torch.Tensor:
    """Unpack [num_pe, capacity, D] slots to [T, D] tuple order, scaled by
    ``gate`` [T] (None = 1); a dropped tuple gives a zero row."""
    return dispatch.onehot_combine(eff[None], slot[None], packed[None],
                                   None if gate is None else gate[None])[0]


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention forward q [B, Sq, H, dh], k/v [B, Sk, KV, dh] ->
    [B, Sq, H, dh]: positions by index, causal and sliding ``window``
    masks, GQA by index."""
    return dispatch.flash_attention(q, k, v, causal=causal, window=window)
