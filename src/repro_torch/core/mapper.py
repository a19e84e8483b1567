"""The mapper module (paper §IV-C2, Fig. 4).

A mapping table of M rows and X+1 columns plus a counter of M entries
executes the SecPE scheduling plan; a tuple for PriPE p goes round robin to
the first counter[p] entries of row p.

JAX gathers clamp an out-of-range index, and the executor's masked sentinel
``dst = M`` reaches ``base[dst]`` and ``table[dst, slot]``.  Torch raises
there, so these gathers clamp explicitly; the executor overwrites the
effective PE of every masked tuple afterwards, so only that result has to
agree.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import RoutePlan


def init_plan(num_pri: int, num_sec: int, device) -> RoutePlan:
    """Row p filled with p and a counter of one: every tuple routes to its
    designated PriPE."""
    table = torch.arange(num_pri, dtype=torch.int32, device=device)[:, None]
    return RoutePlan(
        assignment=torch.full((num_sec,), -1, dtype=torch.int32, device=device),
        table=table.repeat(1, num_sec + 1),
        counter=torch.ones((num_pri,), dtype=torch.int32, device=device))


def apply_schedule(plan: RoutePlan, assignment: torch.Tensor) -> RoutePlan:
    """Mapping-table update (Fig. 4b) from the scheduler's pairs
    "SecPE j -> PriPE assignment[j]" (-1 = unassigned).

    The FPGA (and the JAX reference) writes the pairs one at a time: SecPE
    M+j goes to the next free slot of its row.  That slot is 1 plus the
    number of earlier SecPEs of the same row, so all pairs are written at
    once; unassigned pairs go to a spare column that is cut off.  An
    ``assignment`` [L, X] (a leading lanes axis) gives one plan a lane."""
    num_pri, num_sec = plan.num_pri, plan.num_sec
    device = plan.table.device
    lanes = assignment.shape[:-1]
    fresh = init_plan(num_pri, num_sec, device)
    if num_sec == 0:
        return RoutePlan(**{f: getattr(fresh, f).expand(*lanes, *getattr(fresh, f).shape)
                            .contiguous() for f in ("assignment", "table", "counter")})
    assignment = assignment.to(torch.int32)
    valid = assignment >= 0
    rows = torch.arange(num_pri, dtype=torch.int32, device=device)
    onehot = (assignment[..., None] == rows).to(torch.int32)         # [..., X, M]
    earlier = torch.cumsum(onehot, dim=-2) - onehot
    p = assignment.clamp(min=0).long()
    slot = 1 + earlier.gather(-1, p[..., None])[..., 0]
    spare = num_sec + 1
    table = torch.cat([fresh.table, fresh.table[:, :1]], dim=1)      # [M, X+2]
    sec_ids = num_pri + torch.arange(num_sec, dtype=torch.int32, device=device)
    if lanes:       # scatter each lane's pairs into its own copy of the table
        cell = torch.where(valid, p, 0) * (spare + 1) + torch.where(valid, slot.long(), spare)
        table = table.expand(*lanes, *table.shape).reshape(*lanes, -1).scatter(
            -1, cell, sec_ids.expand(*lanes, num_sec)).view(*lanes, num_pri, spare + 1)
    else:
        table = table.index_put(
            (torch.where(valid, p, 0), torch.where(valid, slot.long(), spare)),
            sec_ids)
    return RoutePlan(assignment=assignment, table=table[..., :spare].contiguous(),
                     counter=fresh.counter + onehot.sum(dim=-2, dtype=torch.int32))


def occurrence_rank(dst: torch.Tensor, num_pri: int,
                    base: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Round-robin position of each tuple within its PriPE's stream:
    rank = base[p] + #{j < i : dst[j] == p}.  Returns (rank, new_base).
    A dst outside [0, M) counts for no PriPE; its rank is meaningless.
    ``dst`` [L, T] and ``base`` [L, M] (a leading lanes axis) rank each
    lane on its own."""
    rows = torch.arange(num_pri, dtype=dst.dtype, device=dst.device)
    onehot = (dst[..., None] == rows).to(torch.int32)                # [..., T, M]
    incl = torch.cumsum(onehot, dim=-2, dtype=torch.int32)
    excl = incl - onehot
    d = dst.clamp(0, num_pri - 1).long()
    rank = base.gather(-1, d) + excl.gather(-1, d[..., None])[..., 0]
    return rank, base + incl[..., -1, :]


def redirect(plan: RoutePlan, dst: torch.Tensor,
             rank: torch.Tensor) -> torch.Tensor:
    """Workload redirecting (Fig. 4c): eff = table[dst, rank mod counter[dst]].
    A plan with a leading lanes axis (table [L, M, X+1]) routes ``dst``
    [L, T] lane by lane; a plan without one routes a ``dst`` of any shape."""
    d = dst.clamp(0, plan.num_pri - 1).long()
    if plan.table.dim() == 2:
        slot = torch.remainder(rank, plan.counter[d])
        return plan.table[d, slot.long()]
    lane = torch.arange(d.shape[0], device=d.device)[:, None]
    slot = torch.remainder(rank, plan.counter[lane, d])
    return plan.table[lane, d, slot.long()]
