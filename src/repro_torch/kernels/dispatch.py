"""The kernel entry points the executor, the apps and the models call.

The device of the carried tensor decides which realization runs: a tensor
on the CPU takes the plain PyTorch version (``ref``), a tensor on a CUDA
device launches the hand-written kernel or raises.  There is no other
selection: no environment variable, no automatic pick, no fallback.

The two PE updates fold into the carried tensor IN PLACE and return it;
the MoE pack/unpack and attention return new tensors.

Gradients: on the card attention differentiates through ``FlashAttention``
(its backward is the hand-written backward kernel); on the CPU its plain
version is differentiable PyTorch.  The MoE pack and unpack differentiate
through ``OnehotDispatch`` and ``OnehotCombine`` on both devices: each is
the other's transpose, so their backwards are the same two realizations
(the kernels on the card, the plain versions on the CPU).  Under no_grad
both wrappers call the realization directly.
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


def int32_indices(idx: torch.Tensor, bound: int) -> torch.Tensor:
    """``idx`` as contiguous int32 for a kernel, with entries outside
    [0, bound) set to -1 before the cast, so that none wraps into range."""
    return torch.where((idx >= 0) & (idx < bound), idx, -1).to(torch.int32).contiguous()


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
    ``flat_idx`` (``ref.scatter_accumulate``): out-of-range indices are
    dropped, and ``max`` starts from zeros, so its result is floored at 0.
    On the card, through ``route_accumulate`` on a [1, num_bins] buffer."""
    if not _on_cuda(value):
        return ref.scatter_accumulate(flat_idx, value, num_bins, combine)
    out = torch.zeros((1, num_bins), dtype=value.dtype, device=value.device)
    flat_idx = int32_indices(flat_idx, num_bins)
    eff = torch.zeros_like(flat_idx)
    return _route_cuda(out, eff, flat_idx, value.contiguous(), combine).view(-1)


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


def _dispatch(eff, slot, values, num_pe, capacity):
    if not _on_cuda(values):
        return ref.onehot_dispatch(eff, slot, values, num_pe, capacity)
    return _dispatch_cuda(eff.to(torch.int32).contiguous(),
                          slot.to(torch.int32).contiguous(), values.contiguous(),
                          num_pe, capacity)


def _combine(eff, slot, packed, gate):
    if not _on_cuda(packed):
        return ref.onehot_combine(eff, slot, packed, gate)
    if gate is not None:
        gate = gate.to(packed.dtype).contiguous()
    return _combine_cuda(eff.to(torch.int32).contiguous(),
                         slot.to(torch.int32).contiguous(), packed.contiguous(), gate)


class OnehotDispatch(torch.autograd.Function):
    """``onehot_dispatch`` with its transpose as the gradient:
    ``OnehotDispatch.apply(eff, slot, values, num_pe, capacity)``.  The
    gradient of ``packed`` reaches ``values`` by ``onehot_combine(eff, slot,
    dpacked)`` with gate 1: a dropped tuple's row gets zeros."""

    @staticmethod
    def forward(ctx, eff, slot, values, num_pe, capacity):
        ctx.save_for_backward(eff, slot)
        return _dispatch(eff, slot, values, num_pe, capacity)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dpacked):
        eff, slot = ctx.saved_tensors
        return None, None, _combine(eff, slot, dpacked.contiguous(), None), None, None


class OnehotCombine(torch.autograd.Function):
    """``onehot_combine`` with its gradients:
    ``OnehotCombine.apply(eff, slot, packed, gate)``.  With ``keep`` = eff in
    [0, P) and slot in [0, C):

      * dpacked = onehot_dispatch(eff, slot, gate * dy) (gate None = 1);
      * dgate[g, t] = sum_d dy[g, t, d] * packed[g, eff, slot, d], 0 where
        the tuple was dropped: the rows gathered by ``onehot_combine`` with
        gate 1, then a row dot with dy.

    The backward casts the gate to ``packed``'s dtype and makes dy
    contiguous, as the forward's wrapper does."""

    @staticmethod
    def forward(ctx, eff, slot, packed, gate):
        ctx.save_for_backward(eff, slot, packed, gate)
        return _combine(eff, slot, packed, gate)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        eff, slot, packed, gate = ctx.saved_tensors
        dy = dy.contiguous()
        dpacked = dgate = None
        if ctx.needs_input_grad[2]:
            g = dy if gate is None else dy * gate.to(packed.dtype)[..., None]
            dpacked = _dispatch(eff, slot, g, packed.shape[1], packed.shape[2])
        if gate is not None and ctx.needs_input_grad[3]:
            rows = _combine(eff, slot, packed, None)
            dgate = (dy * rows).sum(-1).to(gate.dtype)
        return None, None, dpacked, dgate


def onehot_dispatch(eff: torch.Tensor, slot: torch.Tensor, values: torch.Tensor,
                    num_pe: int, capacity: int) -> torch.Tensor:
    """Pack values [G, T, D] into [G, num_pe, capacity, D] capacity slots at
    (eff, slot) [G, T]; dropped tuples are skipped, duplicate cells sum.
    Under grad, through ``OnehotDispatch``."""
    if _wants_grad(values):
        return OnehotDispatch.apply(eff, slot, values, num_pe, capacity)
    return _dispatch(eff, slot, values, num_pe, capacity)


def onehot_combine(eff: torch.Tensor, slot: torch.Tensor, packed: torch.Tensor,
                   gate: torch.Tensor | None = None) -> torch.Tensor:
    """Unpack [G, num_pe, capacity, D] slots to [G, T, D] tuple order, scaled
    by ``gate`` [G, T] (None = 1); dropped tuples give zero rows.  Under
    grad, through ``OnehotCombine``."""
    if _wants_grad(packed, gate):
        return OnehotCombine.apply(eff, slot, packed, gate)
    return _combine(eff, slot, packed, gate)


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
