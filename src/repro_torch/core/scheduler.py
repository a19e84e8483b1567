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
    below that floor become -1 (idle SecPE)."""
    m = workload.shape[0]
    device = workload.device
    if num_sec == 0:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    w = workload.to(torch.float32)
    shares = torch.ones((m,), dtype=torch.float32, device=device)
    picks = []
    for _ in range(num_sec):
        p = torch.argmax(w / shares)
        shares = shares.index_add(0, p[None], torch.ones((1,), dtype=torch.float32,
                                                         device=device))
        picks.append(p)
    assignment = torch.stack(picks).to(torch.int32)
    if min_load is not None:
        hot = w[assignment.long()] >= min_load
        assignment = torch.where(hot, assignment, -1)
    return assignment


def post_plan_max_load(workload: torch.Tensor,
                       assignment: torch.Tensor) -> torch.Tensor:
    """Max effective per-PE load once PriPE p's work is divided by
    1 + (its attached SecPEs)."""
    m = workload.shape[0]
    rows = torch.arange(m, device=workload.device)
    shares = 1.0 + (assignment[:, None] == rows[None, :]).to(torch.float32).sum(dim=0)
    return torch.max(workload.to(torch.float32) / shares)


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
