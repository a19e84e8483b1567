"""TrainState: what the training loop carries from step to step, in the
layout of ``repro/train/state.py`` (its fields in that order, the
optimizer states as the same named tuples), so that a checkpoint of either
package restores in the other.  ``train_state_pspec`` is its spec tree and
``abstract_train_state`` its shape-only (``meta``) stand-in, the dry run's."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.zoo import Model, build
from repro_torch.optim.adamw import Optimizer
from repro_torch.sharding.policies import P


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


def train_state_pspec(model: Model, optimizer: Optimizer,
                      compress: bool = False) -> TrainState:
    pspec = model.params_pspec()
    return TrainState(step=P(), params=pspec, opt_state=optimizer.state_pspec(pspec),
                      comp_state=pspec if compress else None)


def abstract_train_state(model: Model, optimizer: Optimizer,
                         compress: bool = False) -> TrainState:
    """The TrainState of ``model`` on ``meta``: shapes and dtypes, no
    allocation, whatever the model's own device."""
    from repro_torch.optim.compression import init_compression
    shape_model = model if model.device == L.META else build(model.cfg, "meta")
    params = shape_model.init_params(L.ShapeOnly())
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=L.META),
                      params=params, opt_state=optimizer.init(params),
                      comp_state=init_compression(params).error if compress else None)
