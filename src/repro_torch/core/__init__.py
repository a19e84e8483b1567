"""Ditto core in PyTorch: types, mapper, profiler, scheduler, merger,
perfmodel, executor, analyzer and the framework front-end."""
from repro_torch.core.executor import (ExecState, ResumableExecutor,
                                       init_state, make_executor,
                                       make_resumable_executor,
                                       make_static_plan, with_plan)
from repro_torch.core.framework import Ditto, GeneratedImpl, tune_pe_counts
from repro_torch.core.types import (PROFILE_MODE, RUN_MODE, DittoSpec,
                                    ExecStats, RoutePlan)

__all__ = [
    "DittoSpec", "RoutePlan", "ExecStats", "PROFILE_MODE", "RUN_MODE",
    "Ditto", "GeneratedImpl", "tune_pe_counts", "ExecState",
    "ResumableExecutor", "init_state", "make_executor",
    "make_resumable_executor", "make_static_plan", "with_plan",
]
