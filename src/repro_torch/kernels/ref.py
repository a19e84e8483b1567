"""Plain PyTorch versions of the hand-written kernels.

They carry the semantics of ``repro/kernels/ref.py`` and of the ``jnp``
branch of ``repro/kernels/dispatch.pe_buffer_update``: the wrappers in
``dispatch`` take them for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the CUDA kernels against them.

Torch's ``index_add_`` and ``scatter_reduce_`` raise on an out-of-range
index where a jnp scatter drops it, so every invalid entry is masked to
cell 0 with the neutral value before the scatter.  Both functions fold into
the carried tensor in place, as the CUDA kernels do, and return it.
"""
from __future__ import annotations

import torch


def max_identity(dtype: torch.dtype):
    """Neutral element of ``max`` for ``dtype``."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def pe_buffer_update(buffers: torch.Tensor, eff: torch.Tensor,
                     idx: torch.Tensor, value: torch.Tensor,
                     combine: str) -> torch.Tensor:
    """Fold ``value[t]`` into ``buffers[eff[t], idx[t]]`` in place.

    buffers [num_pe, local]; entries with eff or idx out of range are
    dropped.  ``max`` folds into the carried values, so it is exact for any
    sign."""
    num_pe, local = buffers.shape
    valid = (eff >= 0) & (eff < num_pe) & (idx >= 0) & (idx < local)
    flat = torch.where(valid, eff.long() * local + idx.long(), 0)
    v = value.to(buffers.dtype)
    out = buffers.view(-1)
    if combine == "add":
        out.index_add_(0, flat, torch.where(valid, v, 0))
    elif combine == "max":
        out.scatter_reduce_(0, flat,
                            torch.where(valid, v, max_identity(v.dtype)),
                            "amax", include_self=True)
    else:
        raise ValueError(f"combine must be add|max, got {combine!r}")
    return buffers


def cms_update(sketch: torch.Tensor, eff: torch.Tensor, cols: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
    """Count-min sketch update in place: ``sketch[eff[t], d, cols[t, d]] +=
    value[t]`` for every row d.  sketch [num_pe, depth, width]; tuples with
    eff outside [0, num_pe) (padding, the masked sentinel) or a column
    outside [0, width) are dropped."""
    num_pe, depth, width = sketch.shape
    rows = torch.arange(depth, device=cols.device)
    valid = ((eff >= 0) & (eff < num_pe))[:, None] & (cols >= 0) & (cols < width)
    flat = (eff.long()[:, None] * depth + rows) * width + cols.long()
    flat = torch.where(valid, flat, 0)
    v = torch.where(valid, value.to(sketch.dtype)[:, None], 0)
    sketch.view(-1).index_add_(0, flat.reshape(-1), v.reshape(-1))
    return sketch
