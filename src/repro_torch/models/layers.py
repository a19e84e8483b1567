"""Shared layers (plain functions on tensors; params are nested dicts).

The PyTorch counterpart of ``repro/models/layers.py``.  Initializers take
an explicit ``torch.Generator`` and make their tensors on its device; a
``ShapeOnly`` in its place makes ``meta`` tensors, the dry run's stand-ins
of JAX's ``ShapeDtypeStruct``s (no generator lives on ``meta``).  Every
``*_params`` initializer has a ``*_pspec`` twin returning the same tree of
``sharding.P`` specs ('model' = TP, 'data' = FSDP parameter sharding, batch
is ('pod','data'); see sharding/policies.py), and one with weights has a
``*_contracting`` twin giving each weight leaf the dims its forward
product contracts, in one layer's layout (a leaf sharded over 'model' on
such a dim leaves partial sums to all-reduce).  The port computes on one
device, so JAX's activation anchors have no counterpart: the specs serve
the dry run (launch/dryrun.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.policies import P

META = torch.device("meta")


class ShapeOnly:
    """Stands where an initializer takes a generator: its tensors are made
    on ``meta``, with their shapes and dtypes and no values."""
    device = META


def truncnorm(gen: torch.Generator, shape, scale, dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], cast to ``dtype``, times scale."""
    if gen.device == META:
        return torch.empty(shape, dtype=dtype, device=META)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.to(dtype) * scale


def dense_params(gen, d_in, d_out, dtype=torch.float32, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": truncnorm(gen, (d_in, d_out), scale, dtype)}


def dense_pspec(in_axis, out_axis):
    return {"w": P(in_axis, out_axis)}


def dense_contracting():
    return {"w": (0,)}


def dense(params, x, compute_dtype=None):
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    return x @ w


def rmsnorm_params(d, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_pspec():
    return {"scale": P(None)}


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * params["scale"]).to(dt)


def embed_params(gen, vocab, d, dtype=torch.float32):
    return {"emb": truncnorm(gen, (vocab, d), 1.0, dtype)}


def embed_pspec():
    # vocab over 'model' (TP unembedding), d_model over 'data' (FSDP)
    return {"emb": P("model", "data")}


def embed_contracting():
    # the lookup is a one-hot product over the vocab rows
    return {"emb": (0,)}


def embed_lookup(params, tokens, compute_dtype):
    return params["emb"][tokens.long()].to(compute_dtype)


def unembed(params, x, compute_dtype, vocab: int = 0):
    """Tied unembedding; rows of a table padded past ``vocab`` are masked
    to -1e30 so softmax and argmax never see them."""
    emb = params["emb"]
    logits = x.to(compute_dtype) @ emb.to(compute_dtype).T
    rows = emb.shape[0]
    if vocab and rows > vocab:
        pad = torch.arange(rows, device=logits.device) >= vocab
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=logits.device), logits)
    return logits


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def act_fn(name: str):
    # jax.nn.gelu approximates with tanh by default
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------- MLP (gated)
def mlp_params(gen, d, d_ff, dtype=torch.float32, gated=True):
    p = {"up": dense_params(gen, d, d_ff, dtype),
         "down": dense_params(gen, d_ff, d, dtype, scale=d_ff ** -0.5)}
    if gated:
        p["gate"] = dense_params(gen, d, d_ff, dtype)
    return p


def mlp_pspec(gated=True):
    p = {"up": dense_pspec("data", "model"), "down": dense_pspec("model", "data")}
    if gated:
        p["gate"] = dense_pspec("data", "model")
    return p


def mlp_contracting(gated=True):
    p = {"up": dense_contracting(), "down": dense_contracting()}
    if gated:
        p["gate"] = dense_contracting()
    return p


def mlp(params, x, act="silu", compute_dtype=None):
    h = dense(params["up"], x, compute_dtype)
    if "gate" in params:
        h = h * act_fn(act)(dense(params["gate"], x, compute_dtype))
    else:
        h = act_fn(act)(h)
    return dense(params["down"], h, compute_dtype)


# ---------------------------------------------------------------- RoPE
def rope_cos_sin(positions, dim: int, theta: float, dtype=torch.float32):
    """positions [...] -> cos, sin [..., dim // 2]."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x [..., S, n, dim]; cos/sin [..., S, dim // 2], broadcast over heads."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- LayerNorm
def layernorm_params(d, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_pspec():
    return {"scale": P(None), "bias": P(None)}


def layernorm(params, x, eps=1e-5):
    """LayerNorm computed in float32 and cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


# ------------------------------------------------------------ cross-entropy
def softmax_xent(logits, targets, vocab: int):
    """Mean next-token cross-entropy in float32: the log-sum-exp over the
    vocab axis (padded rows, masked to -1e30, add nothing) minus the gold
    logit.  ``vocab`` is unused, as in the JAX package."""
    del vocab
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - gold).mean()
