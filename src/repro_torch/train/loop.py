"""The training loop: the PyTorch counterpart of ``repro/train/loop.py``.

``make_train_step`` builds the (state, batch) -> (state, metrics) step:
the model's loss, its gradients by autograd (on the card through the
flash attention backward kernel), clipping, optional int8 compression with
error feedback, the optimizer's update.  ``train`` drives it: batches in,
resumption from the newest checkpoint, checkpoints, a clean exit on
SIGTERM and step-time telemetry (``train.ft``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.models.zoo import Model
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.train import ft
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.tree import tree_map


def make_train_step(model: Model, optimizer: Optimizer, *, clip_norm: float = 1.0,
                    compress_grads: bool = False) -> Callable:
    """The step: a new TrainState (new tensors; the old state is left as it
    was) and the metrics (loss, xent, lb_loss, grad_norm, step) as
    detached tensors."""

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = tree_map(lambda p: p.detach().requires_grad_(), state.params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(params, batch)
            loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        comp_state = state.comp_state
        if compress_grads:
            grads, cs = C.compress_decompress(grads, C.CompressionState(error=comp_state))
            comp_state = cs.error
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params,
                                                  state.step)
            new_params = apply_updates(state.params, updates)
        new_state = TrainState(step=state.step + 1, params=new_params,
                               opt_state=opt_state, comp_state=comp_state)
        metrics = {k: v.detach() for k, v in
                   dict(metrics, loss=loss, grad_norm=gnorm,
                        step=state.step.to(torch.float32)).items()}
        return new_state, metrics

    return train_step


def make_eval_step(model: Model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss_fn(params, batch)
        return dict(metrics, loss=loss)
    return eval_step


def train(model: Model, optimizer: Optimizer, data_iter, *, num_steps: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100, keep: int = 3,
          seed: int = 0, log_every: int = 10, clip_norm: float = 1.0,
          compress_grads: bool = False, hooks: Optional[list] = None) -> TrainState:
    """Run steps up to ``num_steps``.  Resumes from the newest checkpoint
    when ``ckpt_dir`` has one (the port's CheckpointManager, which also
    reads the JAX package's); checkpoints every ``ckpt_every`` steps and at
    the end; on SIGTERM checkpoints and returns (ft.PreemptionGuard)."""
    step_fn = make_train_step(model, optimizer, clip_norm=clip_norm,
                              compress_grads=compress_grads)

    def fresh():
        state = init_train_state(model, optimizer, model.generator(seed))
        if compress_grads:
            state.comp_state = C.init_compression(state.params).error
        return state

    manager = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
    state = None
    if manager is not None and manager.latest_step() is not None:
        state = manager.restore(fresh(), device=model.device)
    if state is None:
        state = fresh()

    guard = ft.PreemptionGuard()
    telem = ft.StepTelemetry()
    start = int(state.step)
    try:
        for i, batch in zip(range(start, num_steps), data_iter):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if log_every and (i % log_every == 0 or i == num_steps - 1):
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {i:6d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f}", flush=True)
            telem.record(time.perf_counter() - t0)
            for h in (hooks or []):
                h(i, state, metrics)
            if manager is not None and (i + 1) % ckpt_every == 0:
                manager.save(int(state.step), state)
            if guard.preempted:
                print(f"preemption signal at step {i}; checkpointing and "
                      "exiting cleanly", flush=True)
                break
        if manager is not None:
            manager.save(int(state.step), state, block=True)
            manager.close()
    finally:
        guard.uninstall()
    return state

