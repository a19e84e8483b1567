"""AdamW, plus an 8-bit-moment variant (per-row blockwise quantization):
the PyTorch counterpart of ``repro/optim/adamw.py``.

The same functional API over trees of tensors (nested dicts):

    opt = adamw(schedule)               # or adamw8bit(schedule)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

``step`` is the int32 step tensor of the train state; the learning rate and
the bias corrections are float32 tensors computed from it, as in JAX.  The
8-bit variant stores both moments as int8 with one float32 scale per
trailing row (scale shape = leaf.shape[:-1]); ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the codes equal JAX's on equal inputs.
``state_pspec`` maps a params spec tree to the state's: the moments shard
as their params, the 8-bit scales with the last entry dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.sharding.policies import P
from repro_torch.tree import tree_leaves, tree_map, tree_unzip

Params = Any


class AdamWState(NamedTuple):
    mu: Params
    nu: Params


class AdamW8bitState(NamedTuple):
    mu_q: Params        # int8, same shapes as params
    mu_scale: Params    # float32, shape[:-1]
    nu_q: Params
    nu_scale: Params


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[..., Any]   # (grads, state, params, step) -> (updates, state)
    state_pspec: Callable[[Any], Any]  # params spec tree -> state spec tree
    name: str = "adamw"


def clip_by_global_norm(grads, max_norm: float):
    """grads scaled so that their global L2 norm is at most ``max_norm``, and
    that norm (float32; the leaves sum in the tree's order)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _bias_correction(decay: float, step: torch.Tensor) -> torch.Tensor:
    """1 - decay ** (step + 1) in float32."""
    t = (torch.as_tensor(step) + 1).to(torch.float32)
    return 1.0 - torch.pow(torch.tensor(decay, dtype=torch.float32, device=t.device), t)


# ------------------------------------------------------------- fp32 moments

def adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(mu=tree_map(z, params), nu=tree_map(z, params))

    def update(grads, state: AdamWState, params, step):
        g32 = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, g32)
        lr = schedule(step)
        c1, c2 = _bias_correction(b1, step), _bias_correction(b2, step)

        def upd(m, v, p):
            return -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                          + weight_decay * p.float())

        return tree_map(upd, mu, nu, params), AdamWState(mu=mu, nu=nu)

    def state_pspec(params_pspec):
        return AdamWState(mu=params_pspec, nu=params_pspec)

    return Optimizer(init=init, update=update, state_pspec=state_pspec, name="adamw")


# ------------------------------------------------------------- int8 moments

_Q = 127.0


def _quantize(x):
    """Per-trailing-row symmetric int8: x [.., d] -> (int8 [.., d],
    float32 scale [..])."""
    scale = torch.amax(torch.abs(x), dim=-1) / _Q
    q = torch.round(x / torch.clamp(scale, min=1e-30)[..., None])
    return q.to(torch.int8), scale.to(torch.float32)


def _dequantize(q, scale):
    return q.to(torch.float32) * scale[..., None]


def adamw8bit(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        qz = lambda p: torch.zeros(p.shape, dtype=torch.int8, device=p.device)
        sz = lambda p: torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
        return AdamW8bitState(mu_q=tree_map(qz, params), mu_scale=tree_map(sz, params),
                              nu_q=tree_map(qz, params), nu_scale=tree_map(sz, params))

    def update(grads, state: AdamW8bitState, params, step):
        lr = schedule(step)
        c1, c2 = _bias_correction(b1, step), _bias_correction(b2, step)

        def upd(g, mq, ms, vq, vs, p):
            g = g.float()
            m = b1 * _dequantize(mq, ms) + (1 - b1) * g
            v = b2 * _dequantize(vq, vs) + (1 - b2) * g * g
            u = -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                       + weight_decay * p.float())
            return (u, *_quantize(m), *_quantize(v))

        out = tree_map(upd, grads, state.mu_q, state.mu_scale, state.nu_q,
                       state.nu_scale, params)
        u, mq, ms, vq, vs = tree_unzip(out, 5)
        return u, AdamW8bitState(mu_q=mq, mu_scale=ms, nu_q=vq, nu_scale=vs)

    def state_pspec(params_pspec):
        scales = tree_map(lambda s: P(*s[:-1]), params_pspec)
        return AdamW8bitState(mu_q=params_pspec, mu_scale=scales,
                              nu_q=params_pspec, nu_scale=scales)

    return Optimizer(init=init, update=update, state_pspec=state_pspec,
                     name="adamw8bit")


def make_optimizer(name: str, schedule, **kw) -> Optimizer:
    return {"adamw": adamw, "adamw8bit": adamw8bit}[name](schedule, **kw)
