"""TrainState: what the training loop carries from step to step, in the
layout of ``repro/train/state.py`` (its fields in that order, the
optimizer states as the same named tuples), so that a checkpoint of either
package restores in the other."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models.zoo import Model
from repro_torch.optim.adamw import Optimizer


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor       # () int32
    params: Any
    opt_state: Any
    comp_state: Optional[Any] = None   # gradient-compression error feedback


def init_train_state(model: Model, optimizer: Optimizer, gen: torch.Generator,
                     comp_state=None) -> TrainState:
    params = model.init_params(gen)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=model.device),
                      params=params, opt_state=optimizer.init(params),
                      comp_state=comp_state)
