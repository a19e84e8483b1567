"""SecPE scheduling-plan generation (paper §IV-C3, Fig. 5).

The profiler gives a SecPE to the PriPE whose workload is maximal, assumes
that PriPE's work is then shared evenly with its SecPEs, and repeats until
every SecPE is scheduled.  The serial greedy is a Python loop over X <= M-1
small tensor ops; ``w / shares`` stays in float32 and ``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does, so ties break the same
way as in the JAX reference.
"""
from __future__ import annotations

import numpy as np
import torch


def schedule_secpes(workload: torch.Tensor, num_sec: int, *,
                    min_load=None) -> torch.Tensor:
    """Greedy max-load splitting -> int32[X], assignment[j] = the PriPE
    SecPE j shadows.  With ``min_load``, grants to PriPEs whose workload is
    below that floor become -1 (idle SecPE).  A ``workload`` [L, M] (a
    leading lanes axis) schedules each lane on its own -> int32[L, X]."""
    m = workload.shape[-1]
    device = workload.device
    if num_sec == 0:
        return torch.zeros((*workload.shape[:-1], 0), dtype=torch.int32, device=device)
    w = workload.to(torch.float32)
    shares = torch.ones_like(w)
    rows = torch.arange(m, device=device)
    picks = []
    for _ in range(num_sec):
        p = torch.argmax(w / shares, dim=-1)
        shares = shares + (rows == p[..., None])
        picks.append(p)
    assignment = torch.stack(picks, dim=-1).to(torch.int32)
    if min_load is not None:
        hot = w.gather(-1, assignment.long()) >= min_load
        assignment = torch.where(hot, assignment, -1)
    return assignment


def post_plan_max_load(workload: torch.Tensor,
                       assignment: torch.Tensor) -> torch.Tensor:
    """Max effective per-PE load once PriPE p's work is divided by
    1 + (its attached SecPEs); per lane for [L, M] and [L, X]."""
    m = workload.shape[-1]
    rows = torch.arange(m, device=workload.device)
    shares = 1.0 + (assignment[..., None] == rows).to(torch.float32).sum(dim=-2)
    return torch.amax(workload.to(torch.float32) / shares, dim=-1)


def plan_summary(workload, assignment) -> dict:
    """Host-side summary of one plan (numpy only): ``n_granted``
    (assignments != -1), ``max_load_before`` (hottest raw workload) and
    ``max_load_after`` (hottest workload / (1 + attached SecPEs))."""
    w = np.asarray(workload, np.float32)
    a = np.asarray(assignment, np.int64)
    granted = a[a >= 0]
    shares = np.ones(len(w), np.float32)
    np.add.at(shares, granted, 1.0)
    return {
        "n_granted": int(len(granted)),
        "max_load_before": float(w.max()) if len(w) else 0.0,
        "max_load_after": float((w / shares).max()) if len(w) else 0.0,
    }


# Eq. 2 lifted to admission time (a copy of the JAX package's pure-numpy
# functions, used by ``obs.skew``)

def admission_score(backlog, occupancy) -> np.ndarray:
    """Per-tenant Eq. 2 effective load at admission time.

    ``schedule_secpes`` is the paper's balancing move inside the engine:
    the hottest PriPE gets the next helper, with effective load
    ``workload / (1 + shares)``.  The admission controller is the same
    move pointed the other way -- the next free primary slot goes to the
    COLDEST tenant, where a tenant's effective load is the work it has
    already parked on the engine:

        eff_t = occupancy_t + backlog_t / (1 + occupancy_t)

    ``occupancy_t`` (slots the tenant already holds) dominates so one
    tenant's storm cannot FIFO-hog the slot table, and the queued
    backlog is divided across the tenant's resident slots exactly like
    Eq. 2 divides a PriPE's workload across its attached SecPEs.

    Args:
      backlog:   int/float[T] per-tenant queued tuples (or any work
        proxy) not yet resident in a slot.
      occupancy: int/float[T] per-tenant primary slots currently held.

    Returns:
      float64[T] scores; LOWER admits first.  Pure numpy: admission
      runs on the request path of the network service, so it never
      touches the device.
    """
    b = np.asarray(backlog, np.float64)
    o = np.asarray(occupancy, np.float64)
    if b.shape != o.shape:
        raise ValueError(f"backlog shape {b.shape} != occupancy "
                         f"shape {o.shape}")
    return o + b / (1.0 + o)


def plan_admission(backlog, occupancy, free_slots: int,
                   pending) -> np.ndarray:
    """Greedy Eq. 2 admission plan: which pending opens get the free
    slots, and in what order.

    Mirrors the serial greedy of ``schedule_secpes``: each round picks
    the argmin of ``admission_score`` among tenants with a pending open
    (first-arrived wins ties, preserving FIFO among equals), charges
    that tenant one slot of occupancy, and recomputes.  Never admits
    more than ``free_slots`` (capacity is a hard bound).

    Args:
      backlog:    int/float[T] per-tenant queued work (see
        ``admission_score``).
      occupancy:  int/float[T] per-tenant slots held; mutated copies are
        used internally, the input is untouched.
      free_slots: number of primary slots currently free.
      pending:    int[K] tenant index of each queued open request, in
        arrival order.

    Returns:
      int64[A] indices into ``pending`` in admission order, A =
      min(K, free_slots).
    """
    occ = np.asarray(occupancy, np.float64).copy()
    b = np.asarray(backlog, np.float64)
    pend = np.asarray(pending, np.int64)
    if len(pend) and (pend.min() < 0 or pend.max() >= len(occ)):
        raise ValueError(f"pending tenant ids must be in [0, {len(occ)}); "
                         f"got range [{pend.min()}, {pend.max()}]")
    todo = list(range(len(pend)))
    admitted: list = []
    for _ in range(max(0, int(free_slots))):
        if not todo:
            break
        scores = admission_score(b, occ)
        # argmin over the still-pending entries; np.argmin returns the
        # FIRST minimum, i.e. the earliest arrival among score ties.
        k = int(np.argmin(scores[pend[todo]]))
        i = todo.pop(k)
        occ[pend[i]] += 1.0
        admitted.append(i)
    return np.asarray(admitted, np.int64)
