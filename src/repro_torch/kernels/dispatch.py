"""The kernel entry points the executor and the apps call.

The device of the carried tensor decides which realization runs: a tensor
on the CPU takes the plain PyTorch version (``ref``), a tensor on a CUDA
device launches the hand-written kernel or raises.  There is no other
selection: no environment variable, no automatic pick, no fallback.

Both updates fold into the carried tensor IN PLACE and return it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cms_update import cms_update as _cms_cuda
from repro_torch.kernels.route_accumulate import route_accumulate as _route_cuda


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel realization for device {t.device}")


def pe_buffer_update(buffers: torch.Tensor, eff: torch.Tensor,
                     idx: torch.Tensor, value: torch.Tensor,
                     combine: str) -> torch.Tensor:
    """The PriPE/SecPE buffer update: fold ``value[t]`` into
    ``buffers[eff[t], idx[t]]`` in place (add|max) and return ``buffers``.
    buffers [num_pe, local]; out-of-range tuples (padding -1, the masked
    sentinel eff = num_pe) are dropped."""
    if not _on_cuda(buffers):
        return ref.pe_buffer_update(buffers, eff, idx, value, combine)
    return _route_cuda(buffers, eff.to(torch.int32).contiguous(),
                       idx.to(torch.int32).contiguous(),
                       value.to(buffers.dtype).contiguous(), combine)


def scatter_accumulate(flat_idx: torch.Tensor, value: torch.Tensor,
                       num_bins: int, combine: str = "add") -> torch.Tensor:
    """Scatter-accumulate ``value`` into ``num_bins`` fresh cells at
    ``flat_idx`` (the semantics of ``repro.kernels.ref.scatter_accumulate``):
    out-of-range indices are dropped, and ``max`` starts from zeros, so its
    result is floored at 0."""
    out = torch.zeros((1, num_bins), dtype=value.dtype, device=value.device)
    eff = torch.zeros_like(flat_idx, dtype=torch.int32)
    return pe_buffer_update(out, eff, flat_idx, value, combine).view(-1)


def cms_update(sketch: torch.Tensor, eff: torch.Tensor, cols: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
    """Count-min sketch update in place: ``sketch[eff[t], d, cols[t, d]] +=
    value[t]``; sketch [num_pe, depth, width]; eff outside [0, num_pe) is
    dropped.  Returns ``sketch``."""
    if not _on_cuda(sketch):
        return ref.cms_update(sketch, eff, cols, value)
    return _cms_cuda(sketch, eff.to(torch.int32).contiguous(),
                     cols.to(torch.int32).contiguous(),
                     value.to(sketch.dtype).contiguous())
