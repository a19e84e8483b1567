"""Ditto core in PyTorch: types, mapper, profiler, scheduler, merger,
perfmodel, executor, analyzer, the framework front-end, the replicated
static-dispatch baseline, the router, and the multi-device layer (a mesh
of devices, the PE-sharded routed executor, the lane-sharded executor)."""
from repro_torch.core.analyzer import (analyze_skew, buffer_capacity_fraction,
                                       secpes_for_workload, select_implementation)
from repro_torch.core.baseline import (make_replicated_executor,
                                       replica_buffer_bytes,
                                       routed_buffer_bytes)
from repro_torch.core.distributed import (Mesh, ShardedLaneExecutor,
                                          make_distributed_executor,
                                          make_lane_sharded_executor, make_mesh,
                                          run_stream)
from repro_torch.core.executor import (ExecState, ResumableExecutor,
                                       init_state, make_executor,
                                       make_multistream_executor,
                                       make_resumable_executor,
                                       make_static_plan, put_lanes,
                                       stack_plans, stack_states, take_lanes,
                                       with_plan)
from repro_torch.core.framework import Ditto, GeneratedImpl, tune_pe_counts
from repro_torch.core.mapper import apply_schedule, init_plan, occurrence_rank, redirect
from repro_torch.core.merger import merge_buffers
from repro_torch.core.profiler import workload_hist
from repro_torch.core.router import decode_filter, route_all_to_all, route_dense
from repro_torch.core.scheduler import post_plan_max_load, schedule_secpes
from repro_torch.core.types import (PROFILE_MODE, RUN_MODE, DittoSpec,
                                    ExecStats, RoutePlan)

__all__ = [
    "DittoSpec", "RoutePlan", "ExecStats", "PROFILE_MODE", "RUN_MODE",
    "Ditto", "GeneratedImpl", "tune_pe_counts", "ExecState",
    "ResumableExecutor", "init_state", "make_executor",
    "make_resumable_executor", "make_static_plan", "with_plan",
    "make_multistream_executor", "stack_plans", "stack_states", "take_lanes",
    "put_lanes",
    "make_replicated_executor", "replica_buffer_bytes", "routed_buffer_bytes",
    "decode_filter", "route_dense", "route_all_to_all",
    "Mesh", "make_mesh", "make_distributed_executor", "run_stream",
    "ShardedLaneExecutor", "make_lane_sharded_executor",
    "schedule_secpes", "post_plan_max_load", "analyze_skew", "secpes_for_workload",
    "select_implementation", "buffer_capacity_fraction", "apply_schedule",
    "init_plan", "occurrence_rank", "redirect", "merge_buffers", "workload_hist",
]
