"""Core datatypes of the skew-oblivious data-routing architecture (Ditto).

The PyTorch counterpart of ``repro/core/types.py``.  The paper's three PE
classes: PrePEs turn tuples into <dst, value> form (the app's ``pre``), M
PriPEs (ids 0..M-1) each own a distinct partition of the state, and X
SecPEs (ids M..M+X-1) are scheduled at run time to shadow overloaded PriPEs
in the same local index space.  Pytrees become frozen dataclasses of
tensors, and every tensor lives on the device the caller names.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

PROFILE_MODE = 0
RUN_MODE = 1


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` without a CUDA device
    raises: the port never drops to the CPU on its own; pass
    ``device="cpu"`` to run there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """SecPE scheduling plan and the mapper state that executes it (Fig. 4).

    assignment: int32[X], the PriPE that SecPE M+j shadows, or -1 (idle).
    table: int32[M, X+1]; row p holds PriPE p followed by its SecPEs, the
      unused slots hold p itself.
    counter: int32[M], the number of valid entries of each row.
    A lanes-stacked plan (``executor.stack_plans``) has a leading [L] axis
    on all three.
    """

    assignment: torch.Tensor
    table: torch.Tensor
    counter: torch.Tensor

    @property
    def num_pri(self) -> int:
        return self.table.shape[-2]

    @property
    def num_sec(self) -> int:
        return self.assignment.shape[-1]


@dataclasses.dataclass(frozen=True)
class DittoSpec:
    """Application specification (the paper's Listing 2).

    pre: (tuples [T, ...], M) -> (dst [T] in [0, M), idx, value [T]).
    init_buffer: (num_pe, device) -> buffers [num_pe, *local] (a tensor, or
      a frozen dataclass of tensors with a leading PE axis).
    combine: 'add' | 'max', the PE update and the SecPE merge.
    pe_update: optional custom (buffers, eff, idx, value) -> buffers; it may
      fold into ``buffers`` in place.
    merge: optional custom (buffers, plan) -> merged, for a non-decomposable
      application (the paper's data partitioning), whose buffers may be a
      frozen dataclass of tensors.  Without it the executor folds the SecPE
      shadows into their PriPEs by ``combine``.  A spec with its own merge
      keeps per-PE regions that lanes cannot share, so its ``pe_update``
      also takes lanes-stacked buffers [L, num_pe, ...] with eff, idx and
      value [L, T, ...]; every other spec sees the lanes as more PEs.
    """

    name: str
    pre: Callable[[torch.Tensor, int], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    init_buffer: Callable[[int, torch.device], torch.Tensor]
    combine: str = "add"
    pe_update: Optional[Callable[..., torch.Tensor]] = None
    merge: Optional[Callable[..., object]] = None
    tuple_bytes: int = 8
    ii_pre: int = 1
    ii_pe: int = 2

    def __post_init__(self):
        if self.combine not in ("add", "max"):
            raise ValueError(f"combine must be add|max, got {self.combine}")


@dataclasses.dataclass(frozen=True)
class ExecStats:
    """Per-chunk statistics of the streaming executor; a run stacks them on
    a leading chunk axis."""

    max_load: torch.Tensor        # int32  max tuples absorbed by one effective PE
    modeled_cycles: torch.Tensor  # float32  port-limited cycle model of the chunk
    mode: torch.Tensor            # int32  0 = PROFILE, 1 = RUN
    rescheduled: torch.Tensor     # bool  True if a re-schedule fired this chunk
    workload: torch.Tensor        # int32[M]  per-PriPE designated workload
