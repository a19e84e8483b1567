"""The runtime profiler (paper §IV-C3).

Two duties: histogram the designated PriPE ids over a profiling window to
generate the SecPE plan, and monitor the modeled throughput to ask for a
re-schedule when the distribution changed.  All arithmetic stays in float32,
as in the JAX reference, so the re-schedule decisions agree.
"""
from __future__ import annotations

import dataclasses

import torch


def workload_hist(dst: torch.Tensor, num_pri: int) -> torch.Tensor:
    """int32[M] count of the tuples designated to each PriPE.  Ids outside
    [0, M) (the executor's masked sentinel M) are dropped.  ``dst`` [L, T]
    (a leading lanes axis) gives one histogram a lane, [L, M]."""
    valid = (dst >= 0) & (dst < num_pri)
    d = torch.where(valid, dst, num_pri).long()
    lanes = dst.shape[:-1]
    if lanes:       # lane l counts into its own M + 1 cells
        d = d + torch.arange(lanes.numel(), device=dst.device).view(*lanes, 1) * (num_pri + 1)
    hist = torch.zeros((lanes.numel() * (num_pri + 1),), dtype=torch.int32,
                       device=dst.device)
    hist.index_add_(0, d.reshape(-1), torch.ones((d.numel(),), dtype=torch.int32,
                                                 device=dst.device))
    return hist.view(*lanes, num_pri + 1)[..., :num_pri]


def partial_hists(dst: torch.Tensor, num_pri: int, num_lanes: int) -> torch.Tensor:
    """The paper's N independent hist instances: lane i counts tuples
    i, i+N, i+2N, ...  Shape [N, M]."""
    t = dst.shape[0]
    if t % num_lanes:
        raise ValueError("chunk must be a multiple of the lane count")
    lanes = torch.arange(t, device=dst.device) % num_lanes
    out = torch.zeros((num_lanes * num_pri,), dtype=torch.int32, device=dst.device)
    out.index_add_(0, lanes * num_pri + dst.long(),
                   torch.ones((t,), dtype=torch.int32, device=dst.device))
    return out.view(num_lanes, num_pri)


def merge_partials(partials: torch.Tensor) -> torch.Tensor:
    """Merge the N partial results into the global histogram."""
    return partials.sum(dim=0, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class MonitorState:
    """Throughput monitor: the post-plan reference cycles/chunk and an EMA of
    the observed modeled cycles/chunk (float32 scalars)."""

    ref_cycles: torch.Tensor
    ema_cycles: torch.Tensor

    @staticmethod
    def fresh(device) -> "MonitorState":
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return MonitorState(ref_cycles=zero, ema_cycles=zero.clone())


def monitor_update(state: MonitorState, cycles: torch.Tensor,
                   alpha: float = 0.5) -> MonitorState:
    ema = torch.where(state.ema_cycles == 0.0, cycles,
                      alpha * cycles + (1 - alpha) * state.ema_cycles)
    return MonitorState(ref_cycles=state.ref_cycles, ema_cycles=ema)


def should_reschedule(state: MonitorState, threshold: float) -> torch.Tensor:
    """True when throughput (1/cycles) dropped below threshold * reference;
    threshold = 0 disables re-scheduling."""
    degraded = state.ema_cycles * threshold > state.ref_cycles
    return (state.ref_cycles > 0.0) & degraded & (threshold > 0.0)
