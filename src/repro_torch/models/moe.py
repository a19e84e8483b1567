"""Ditto-MoE: mixture-of-experts with skew-oblivious expert replication.

The PyTorch counterpart of ``repro/models/moe.py``.  Experts are PriPEs; a
skewed router overloads hot experts as Zipf keys overload a PriPE.  Per
layer and per call:

  1. profiler: the global histogram of designated experts over all groups;
  2. scheduler: greedy max-splitting gives X secondary slots to the hottest
     experts (``core.scheduler.schedule_secpes``, paper Fig. 5);
  3. mapper: round-robin redirect of a hot expert's tokens over its slot
     group through the mapping table (``core.mapper``, paper Fig. 4);
  4. dispatch/combine: capacity slotting per dispatch group by occurrence
     rank, through ``kernels.dispatch.onehot_dispatch`` / ``onehot_combine``
     (the hand-written kernels on the card, plain PyTorch on the CPU) --
     the semantics of the JAX package's ``moe_impl="kernel"``, which equal
     those of its ``"onehot"`` and ``"sort"`` realizations; secondary slots
     compute with their primary expert's weights;
  5. merger: the gate-weighted combine sums slot outputs per token.

Dropped tokens pass through the residual (capacity-factor semantics).
``place_slot_weights`` fixes a plan ahead of the call (the paper's SecPE
re-enqueue by the CPU): the expert weights are copied once per slot, and
``moe_apply`` on such params follows that plan instead of the batch's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import mapper as core_mapper
from repro_torch.core import scheduler as core_scheduler
from repro_torch.kernels import dispatch as K
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L
from repro_torch.sharding.policies import P


def moe_params(gen, d_model, d_ff, num_experts, dtype=torch.float32,
               num_shared: int = 0, shared_d_ff: int = 0):
    s = d_model ** -0.5
    p = {
        "router": L.truncnorm(gen, (d_model, num_experts), s, torch.float32),
        "up": L.truncnorm(gen, (num_experts, d_model, d_ff), s, dtype),
        "gate": L.truncnorm(gen, (num_experts, d_model, d_ff), s, dtype),
        "down": L.truncnorm(gen, (num_experts, d_ff, d_model), d_ff ** -0.5, dtype),
    }
    if num_shared:
        p["shared"] = L.mlp_params(gen, d_model, shared_d_ff or d_ff * num_shared,
                                   dtype)
    return p


def moe_pspec(num_shared: int = 0):
    p = {"router": P(None, None),
         "up": P("model", "data", None), "gate": P("model", "data", None),
         "down": P("model", None, "data")}
    if num_shared:
        p["shared"] = L.mlp_pspec()
    return p


# the expert-indexed weights [E, ., .]; an expert-parallel layout (experts
# over 'model') sends each layer's dispatched tokens all-to-all, which the
# dry run charges at the first of them
EXPERT_LEAVES = ("up", "gate", "down")


def moe_contracting(num_shared: int = 0):
    p = {"router": (0,), "up": (1,), "gate": (1,), "down": (1,)}
    if num_shared:
        p["shared"] = L.mlp_contracting()
    return p


def _plan_from_hist(hist: torch.Tensor, num_experts: int, num_sec: int):
    """Paper steps 1-2: histogram -> greedy plan -> mapping table, and the
    expert each of the E + X slots computes with."""
    assignment = core_scheduler.schedule_secpes(hist, num_sec)      # [X]
    plan = core_mapper.apply_schedule(
        core_mapper.init_plan(num_experts, num_sec, hist.device), assignment)
    slot_expert = torch.cat(
        [torch.arange(num_experts, dtype=torch.int32, device=hist.device),
         torch.where(assignment >= 0, assignment, 0).to(torch.int32)])
    return plan, slot_expert


def place_slot_weights(params, assignment: torch.Tensor, num_experts: int,
                       *, pad_to: int = 16, dtype=None):
    """Ditto slot-weight placement: the expert weights copied once per slot
    of the plan ``assignment`` [X] (the expert each secondary slot serves,
    -1 = none), so that a call stops selecting weights per slot.

    Returns a params dict whose ``up``/``gate``/``down`` are replaced by
    ``up_slots`` [S_pad, d, f], ``gate_slots``, ``down_slots`` and
    ``slot_assignment`` (the plan the mapper must follow); S_pad rounds
    E + X up to a multiple of ``pad_to``, and the padding slots hold expert
    0's weights and receive no token."""
    num_sec = int(assignment.shape[0])
    slots = num_experts + num_sec
    s_pad = -(-slots // pad_to) * pad_to
    dev = params["up"].device
    assignment = assignment.to(dev)
    slot_expert = torch.cat([
        torch.arange(num_experts, dtype=torch.int32, device=dev),
        torch.where(assignment >= 0, assignment, 0).to(torch.int32),
        torch.zeros((s_pad - slots,), dtype=torch.int32, device=dev)]).long()
    dt = dtype or params["up"].dtype
    out = dict(params)
    for name in EXPERT_LEAVES:
        out[slot_name(name)] = params[name].index_select(0, slot_expert).to(dt)
        out.pop(name)
    out["slot_assignment"] = assignment.to(torch.int32)
    return out


def slot_name(name: str) -> str:
    """The key of an expert leaf's per-slot copy."""
    return f"{name}_slots"


def slot_weights_contracting(base: dict) -> dict:
    """The contracting dims of ``place_slot_weights``'s output."""
    out = dict(base)
    for name in EXPERT_LEAVES:
        out[slot_name(name)] = out.pop(name)
    return out


def slot_weights_pspec(base_pspec: dict) -> dict:
    """The spec tree of ``place_slot_weights``'s output: the slots over
    'model' as the experts were."""
    out = slot_weights_contracting(base_pspec)
    out["slot_assignment"] = P(None)
    return out


def uniform_capacity(tokens_per_group: int, top_k: int, num_experts: int,
                     capacity_factor: float) -> int:
    """Per-slot-per-group capacity sized for the *uniform* load -- with
    Ditto slots this is safe under skew; without them the hottest expert
    drops tokens."""
    return max(4, int(capacity_factor * tokens_per_group * top_k / num_experts))


def moe_apply(params, x, *, num_experts, top_k, capacity_factor: float = 1.25,
              num_secondary: int = 0, act="silu", compute_dtype=None,
              group_size: int = 512, capacity: Optional[int] = None):
    """x [B, S, D] -> (y [B, S, D], aux) with Ditto skew-oblivious dispatch.

    Tokens regroup into dispatch groups of ``group_size`` tokens; capacity
    is per slot per group, sized for the uniform load unless given.
    ``num_secondary`` = X replica slots (0 = plain MoE).  Params from
    ``place_slot_weights`` carry the plan and the per-slot weights: the
    call follows that plan over their S_pad slots.  aux carries the
    load-balance loss and the Ditto diagnostics of the JAX version."""
    cd = compute_dtype or x.dtype
    b, s, d = x.shape
    t = b * s
    n = min(group_size, t)
    if t % n:
        raise ValueError(f"tokens {t} not divisible by group {n}")
    g = t // n
    if capacity is None:
        capacity = uniform_capacity(n, top_k, num_experts, capacity_factor)
    nk = n * top_k
    placed = "up_slots" in params     # plan-time slot-weight placement
    num_slots = (params["up_slots"].shape[0] if placed
                 else num_experts + num_secondary)

    logits = x.reshape(-1, d).float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)                            # [B*S, E]
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    designated = expert_ids.reshape(g, nk).to(torch.int32)           # [G, n*k]
    gates = gate_vals.reshape(g, nk)

    # 1. global profiler histogram (per-group partials merged)
    hist = torch.bincount(designated.reshape(-1).long(),
                          minlength=num_experts).to(torch.int32)
    if num_secondary > 0:
        if placed:
            # the plan was fixed at placement: the mapper follows it
            plan = core_mapper.apply_schedule(
                core_mapper.init_plan(num_experts, num_secondary, x.device),
                params["slot_assignment"])
        else:
            # 2.-3. one shared plan from this batch's histogram
            plan, slot_expert = _plan_from_hist(hist, num_experts, num_secondary)
        # per-group round-robin redirect
        rank = kernel_ops.occurrence_rank(designated, num_experts)
        eff = core_mapper.redirect(plan, designated, rank)           # [G, n*k]
    else:
        eff = designated
        slot_expert = torch.arange(num_experts, dtype=torch.int32, device=x.device)

    # 4. capacity slotting within (group, slot), by occurrence rank
    slot_rank = kernel_ops.occurrence_rank(eff, num_slots)
    keep = slot_rank < capacity
    xin = x.reshape(g, n, d).to(cd).repeat_interleave(top_k, dim=1)  # [G, nk, D]
    packed = K.onehot_dispatch(eff, slot_rank, xin, num_slots, capacity)

    # expert compute; a secondary slot takes its expert's weights (the
    # JAX version's one-hot einsum over the expert axis selects the same),
    # or the weights were placed per slot ahead of the call
    if placed:
        w_up, w_gate, w_down = (params[f"{name}_slots"].to(cd)
                                for name in ("up", "gate", "down"))
    else:
        idx = slot_expert.long()
        w_up = params["up"].to(cd).index_select(0, idx)
        w_gate = params["gate"].to(cd).index_select(0, idx)
        w_down = params["down"].to(cd).index_select(0, idx)
    h = torch.einsum("gecd,edf->gecf", packed, w_up)
    h = h * F.silu(torch.einsum("gecd,edf->gecf", packed, w_gate))
    out_slots = torch.einsum("gecf,efd->gecd", h, w_down)            # [G,S_,C,D]

    # 5. gate-weighted combine (implicit 'add' merge over slots and k)
    y = K.onehot_combine(eff, slot_rank, out_slots.contiguous(), gates.to(cd))
    y = y.reshape(g, n, top_k, d).sum(dim=2).reshape(b, s, d)

    if "shared" in params:
        y = y + L.mlp(params["shared"], x, act=act, compute_dtype=cd)

    me = probs.mean(dim=0)
    ce = hist.float() / hist.sum().clamp(min=1)
    aux = {
        "lb_loss": num_experts * torch.sum(me * ce),
        "drop_frac": 1.0 - keep.float().mean(),
        "max_designated_load": hist.max(),
        "max_slot_load": torch.bincount(eff.reshape(-1).long(),
                                        minlength=num_slots).max().to(torch.int32),
    }
    return y, aux
