"""The kernel entry points the executor, the apps and the models call.

The device of the carried tensor decides which realization runs: a tensor
on the CPU takes the plain PyTorch version (``ref``), a tensor on a CUDA
device launches the hand-written kernel or raises.  There is no other
selection: no environment variable, no automatic pick, no fallback.

The two PE updates fold into the carried tensor IN PLACE and return it;
the MoE pack/unpack and attention return new tensors.

Gradients: on the CPU the plain versions are differentiable PyTorch.  On
the card attention differentiates through ``FlashAttention`` (its backward
is the hand-written backward kernel), and the MoE pack and unpack, which
have no backward kernel yet (ROADMAP.md §1), raise when grad mode is on and
a float input requires grad, so that no gradient stops silently at a kernel
launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cms_update import cms_update as _cms_cuda
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.flash_attention import flash_attention as _flash_cuda
from repro_torch.kernels.moe_onehot import onehot_combine as _combine_cuda
from repro_torch.kernels.moe_onehot import onehot_dispatch as _dispatch_cuda
from repro_torch.kernels.route_accumulate import route_accumulate as _route_cuda


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel realization for device {t.device}")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors) -> None:
    if _wants_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel on the card yet (ROADMAP.md §1: MoE "
            "training); call it under torch.no_grad() or on CPU tensors")


def pe_buffer_update(buffers: torch.Tensor, eff: torch.Tensor,
                     idx: torch.Tensor, value: torch.Tensor,
                     combine: str) -> torch.Tensor:
    """The PriPE/SecPE buffer update: fold ``value[t]`` into
    ``buffers[eff[t], idx[t]]`` in place (add|max) and return ``buffers``.
    buffers [num_pe, local]; out-of-range tuples (padding -1, the masked
    sentinel eff = num_pe) are dropped.  On the card the tensors go to the
    kernel as they are (the executor and the apps' PrePEs hand over int32):
    eff and idx int32 and value of the buffers' dtype, contiguous, or the
    kernel wrapper raises."""
    if not _on_cuda(buffers):
        return ref.pe_buffer_update(buffers, eff, idx, value, combine)
    return _route_cuda(buffers, eff, idx, value, combine)


def scatter_accumulate(flat_idx: torch.Tensor, value: torch.Tensor,
                       num_bins: int, combine: str = "add") -> torch.Tensor:
    """Scatter-accumulate ``value`` into ``num_bins`` fresh cells at
    ``flat_idx`` (the semantics of ``repro.kernels.ref.scatter_accumulate``):
    out-of-range indices are dropped, and ``max`` starts from zeros, so its
    result is floored at 0."""
    out = torch.zeros((1, num_bins), dtype=value.dtype, device=value.device)
    if _on_cuda(out):
        # the kernel takes int32 indices: out-of-range ones become -1 before
        # the cast, so that none wraps into range
        ok = (flat_idx >= 0) & (flat_idx < num_bins)
        flat_idx = torch.where(ok, flat_idx, -1).to(torch.int32).contiguous()
        value = value.contiguous()
    eff = torch.zeros_like(flat_idx, dtype=torch.int32)
    return pe_buffer_update(out, eff, flat_idx, value, combine).view(-1)


def cms_update(sketch: torch.Tensor, eff: torch.Tensor, cols: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
    """Count-min sketch update in place: ``sketch[eff[t], d, cols[t, d]] +=
    value[t]``; sketch [num_pe, depth, width]; eff outside [0, num_pe) is
    dropped.  Returns ``sketch``.  On the card the tensors go to the kernel
    as they are (HHD's PrePE hands over int32): eff and cols int32 and
    value of the sketch's dtype, contiguous, or the kernel wrapper raises."""
    if not _on_cuda(sketch):
        return ref.cms_update(sketch, eff, cols, value)
    return _cms_cuda(sketch, eff, cols, value)


def onehot_dispatch(eff: torch.Tensor, slot: torch.Tensor, values: torch.Tensor,
                    num_pe: int, capacity: int) -> torch.Tensor:
    """Pack values [G, T, D] into [G, num_pe, capacity, D] capacity slots at
    (eff, slot) [G, T]; dropped tuples are skipped, duplicate cells sum."""
    if not _on_cuda(values):
        return ref.onehot_dispatch(eff, slot, values, num_pe, capacity)
    _no_backward("onehot_dispatch", values)
    return _dispatch_cuda(eff.to(torch.int32).contiguous(),
                          slot.to(torch.int32).contiguous(), values.contiguous(),
                          num_pe, capacity)


def onehot_combine(eff: torch.Tensor, slot: torch.Tensor, packed: torch.Tensor,
                   gate: torch.Tensor | None = None) -> torch.Tensor:
    """Unpack [G, num_pe, capacity, D] slots to [G, T, D] tuple order, scaled
    by ``gate`` [G, T] (None = 1); dropped tuples give zero rows."""
    if not _on_cuda(packed):
        return ref.onehot_combine(eff, slot, packed, gate)
    _no_backward("onehot_combine", packed, gate)
    if gate is not None:
        gate = gate.to(packed.dtype).contiguous()
    return _combine_cuda(eff.to(torch.int32).contiguous(),
                         slot.to(torch.int32).contiguous(), packed.contiguous(), gate)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention forward q [B, Sq, H, dh], k/v [B, Sk, KV, dh] -> [B, Sq, H, dh]
    with positions by index (causal, sliding ``window``, GQA by index) and
    the scaled scores soft-capped at ``softcap`` (0 = none).  On the card,
    under grad, the backward kernel is its gradient."""
    if not _on_cuda(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal, window, softcap)
    return _flash_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal=causal, window=window, softcap=softcap)
