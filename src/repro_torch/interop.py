"""Carry the JAX package's runtime state into the port, through numpy.

Ditto has no weights: its parameters are the ``RoutePlan`` (a static or
tuned plan) and the ``ExecState`` (a stream's state mid-flight, as a
checkpoint holds it).  Convert the JAX pytrees to numpy on their side (for
example ``jax.tree.map(np.asarray, dataclasses.asdict(state))``) and build
the port's dataclasses here, so both packages can start from the same plan
or the same mid-stream state.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.executor import ExecState
from repro_torch.core.profiler import MonitorState
from repro_torch.core.types import RoutePlan, resolve_device


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def plan_from_numpy(assignment, table, counter, device="cuda") -> RoutePlan:
    """A ``RoutePlan`` from numpy copies of the plan's three arrays."""
    device = resolve_device(device)
    return RoutePlan(assignment=_tensor(assignment, np.int32, device),
                     table=_tensor(table, np.int32, device),
                     counter=_tensor(counter, np.int32, device))


def state_from_numpy(arrays: Mapping, device="cuda") -> ExecState:
    """An ``ExecState`` from a nested dict of numpy arrays with the field
    names of ``ExecState`` (``plan`` and ``monitor`` nested in turn)."""
    device = resolve_device(device)
    plan, mon = arrays["plan"], arrays["monitor"]
    return ExecState(
        buffers=torch.as_tensor(np.array(arrays["buffers"]), device=device),
        plan=plan_from_numpy(plan["assignment"], plan["table"], plan["counter"],
                             device),
        rr_base=_tensor(arrays["rr_base"], np.int32, device),
        mode=_tensor(arrays["mode"], np.int32, device),
        profile_hist=_tensor(arrays["profile_hist"], np.int32, device),
        chunks_in_mode=_tensor(arrays["chunks_in_mode"], np.int32, device),
        monitor=MonitorState(ref_cycles=_tensor(mon["ref_cycles"], np.float32, device),
                             ema_cycles=_tensor(mon["ema_cycles"], np.float32, device)),
        reschedules=_tensor(arrays["reschedules"], np.int32, device))


def state_to_numpy(state: ExecState) -> dict:
    """The inverse of ``state_from_numpy``: a nested dict of numpy arrays."""
    return {f.name: (state_to_numpy(v) if dataclasses.is_dataclass(v)
                     else v.detach().cpu().numpy())
            for f in dataclasses.fields(state)
            for v in (getattr(state, f.name),)}
