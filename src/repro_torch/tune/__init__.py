"""Perfmodel-guided autotuner over (M, X, chunk size).

Public API:
  autotune, autotune_from_workload, TunedPlan   -- repro_torch.tune.tuner
  SearchSpace, Candidate, default_space         -- repro_torch.tune.space
"""
from repro_torch.tune.space import Candidate, SearchSpace, default_space
from repro_torch.tune.tuner import (TunedPlan, autotune, autotune_from_workload,
                                    predict_cycles_per_tuple,
                                    static_plan_from_hist)

__all__ = [
    "Candidate", "SearchSpace", "default_space",
    "TunedPlan", "autotune", "autotune_from_workload",
    "predict_cycles_per_tuple", "static_plan_from_hist",
]
