"""Plain PyTorch versions of the hand-written kernels.

They carry the semantics of ``repro/kernels/ref.py`` and of the ``jnp``
branch of ``repro/kernels/dispatch.pe_buffer_update``: the wrappers in
``dispatch`` take them for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the CUDA kernels against them.

Torch's ``index_add_`` and ``scatter_reduce_`` raise on an out-of-range
index where a jnp scatter drops it, so every invalid entry is masked to
cell 0 with the neutral value before the scatter.  The two PE updates fold
into the carried tensor in place, as the CUDA kernels do, and return it.

The MoE pack/unpack pair writes out the JAX package's ``vmap`` over
dispatch groups as a leading group axis G, so one call covers a layer.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30          # the score of a masked key, in the kernels as in Pallas


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


def scatter_accumulate(flat_idx: torch.Tensor, value: torch.Tensor,
                       num_bins: int, combine: str = "add") -> torch.Tensor:
    """Scatter-accumulate ``value`` into ``num_bins`` fresh cells at
    ``flat_idx`` (``repro/kernels/ref.scatter_accumulate``): out-of-range
    indices are dropped, and ``max`` starts from zeros, so its result is
    floored at 0."""
    out = torch.zeros((1, num_bins), dtype=value.dtype, device=value.device)
    eff = torch.zeros_like(flat_idx, dtype=torch.int32)
    return pe_buffer_update(out, eff, flat_idx, value, combine).view(-1)


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


def _capacity_cells(eff: torch.Tensor, slot: torch.Tensor, num_pe: int,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(keep [G, T], flat cell [G, T] into the [G * num_pe * capacity] rows
    of a packed tensor; dropped tuples point at their group's cell 0)."""
    keep = (eff >= 0) & (eff < num_pe) & (slot >= 0) & (slot < capacity)
    cell = torch.where(keep, eff.long() * capacity + slot.long(), 0)
    base = torch.arange(eff.shape[0], device=eff.device)[:, None] * (num_pe * capacity)
    return keep, cell + base


def onehot_dispatch(eff: torch.Tensor, slot: torch.Tensor, values: torch.Tensor,
                    num_pe: int, capacity: int) -> torch.Tensor:
    """Pack tuple rows into per-PE capacity slots:
    ``packed[g, p, c, :] = sum_t [eff[g, t] = p and slot[g, t] = c] * values[g, t, :]``.

    eff, slot [G, T]; values [G, T, D] -> [G, num_pe, capacity, D].  Tuples
    with eff outside [0, num_pe) or slot outside [0, capacity) are dropped;
    duplicate (eff, slot) cells sum."""
    g, t, d = values.shape
    keep, cell = _capacity_cells(eff, slot, num_pe, capacity)
    out = torch.zeros((g * num_pe * capacity, d), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, cell.reshape(-1),
                   torch.where(keep[..., None], values, 0).reshape(-1, d))
    return out.view(g, num_pe, capacity, d)


def onehot_combine(eff: torch.Tensor, slot: torch.Tensor, packed: torch.Tensor,
                   gate: torch.Tensor | None = None) -> torch.Tensor:
    """Unpack capacity slots back to tuple order:
    ``y[g, t, :] = gate[g, t] * packed[g, eff[g, t], slot[g, t], :]``, zeros
    for a dropped tuple.  packed [G, num_pe, capacity, D]; gate [G, T] or
    None (= 1)."""
    g, num_pe, capacity, d = packed.shape
    keep, cell = _capacity_cells(eff, slot, num_pe, capacity)
    rows = packed.reshape(-1, d).index_select(0, cell.reshape(-1))
    out = torch.where(keep[..., None], rows.view(*eff.shape, d), 0)
    if gate is not None:
        out = out * gate[..., None].to(out.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Dense-softmax attention in float32, the semantics of the flash kernel.

    q [B, Sq, H, dh], k/v [B, Sk, KV, dh] -> [B, Sq, H, dh] in q's dtype;
    scale dh^-0.5; query and key positions are their indices; head j reads
    KV head j // (H / KV).  A nonzero ``softcap`` maps the scaled scores s
    to softcap * tanh(s / softcap) before the mask, as the JAX model's
    ``_sdpa_block`` does."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(h // kvh, dim=2)
    vv = v.repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * dh ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    p = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv.float()).to(q.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """The gradients (dq, dk, dv) of ``flash_attention`` at (q, k, v) for
    the output gradient ``do``, by ``torch.autograd.grad`` through it: the
    plain version of the backward kernel.  Each gradient in its input's
    dtype; dk and dv sum over the query heads that share a KV head."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=causal, window=window, softcap=softcap)
        return torch.autograd.grad(out, leaves, do)
