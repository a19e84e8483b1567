"""Carry the JAX package's runtime state into the port, through numpy.

Ditto's executor has no weights: its parameters are the ``RoutePlan`` (a
static or tuned plan) and the ``ExecState`` (a stream's state mid-flight,
as a checkpoint holds it, DP's output regions included).  The language models do: their params pytree
has one layout in both packages.  Convert the JAX pytrees to numpy on
their side (for example ``jax.tree.map(np.asarray, params)``) and build the
port's objects here, so both packages can start from the same plan, the
same mid-stream state or the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.apps.dp import DPBuffers
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


def dp_buffers_from_numpy(out, cursor, dst_part, device="cuda") -> DPBuffers:
    """DP's ``DPBuffers`` from numpy copies of its three arrays (a JAX
    ``DPBuffers`` unpacks into them in this order)."""
    device = resolve_device(device)
    return DPBuffers(out=_tensor(out, np.int32, device),
                     cursor=_tensor(cursor, np.int32, device),
                     dst_part=_tensor(dst_part, np.int32, device))


def state_from_numpy(arrays: Mapping, device="cuda") -> ExecState:
    """An ``ExecState`` from a nested dict of numpy arrays with the field
    names of ``ExecState`` (``plan`` and ``monitor`` nested in turn).  The
    buffers are one array, or DP's dict of ``out``, ``cursor`` and
    ``dst_part``."""
    device = resolve_device(device)
    plan, mon, buffers = arrays["plan"], arrays["monitor"], arrays["buffers"]
    return ExecState(
        buffers=(dp_buffers_from_numpy(**buffers, device=device)
                 if isinstance(buffers, Mapping)
                 else torch.as_tensor(np.array(buffers), device=device)),
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
    """The inverse of ``state_from_numpy``: a nested dict of numpy arrays
    (dataclass buffers, DP's, become a dict of their fields)."""
    return {f.name: (state_to_numpy(v) if dataclasses.is_dataclass(v)
                     else v.detach().cpu().numpy())
            for f in dataclasses.fields(state)
            for v in (getattr(state, f.name),)}


def _leaf_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy-torch bridge
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def tree_from_numpy(tree, device) -> dict:
    """A nested dict of numpy arrays as tensors on ``device`` (bfloat16
    leaves stay bfloat16); no check of its layout."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_tensor(tree, device)


def lm_params_from_numpy(cfg, tree: Mapping, device="cuda") -> dict:
    """The port's LM params from a nested dict of numpy arrays in the JAX
    package's layout (``repro.models.transformer.init_params``; attention,
    MLA and mamba mixers, dense and MoE FFNs and FFN-less layers, the VLM's
    ``patch_proj``, ``place_slot_weights``' trees).  Leaves keep their
    dtypes.  Raises if the tree does not fit ``cfg``: the block keys of its
    layer pattern (no ``norm2`` or ``ffn`` for a ``none`` FFN), every block
    leaf stacked over ``cfg.num_periods``, the embedding table's shape, and
    a ``patch_proj`` of [patch_embed_dim, d_model] exactly when the config
    has patches."""
    device = resolve_device(device)
    params = tree_from_numpy(tree, device)
    keys = {f"{j}.{part}" for j, fk in enumerate(cfg.ffn_pattern)
            for part in (("norm1", "mixer") if fk == "none"
                         else ("norm1", "mixer", "norm2", "ffn"))}
    blocks = params.get("blocks", {})
    if set(blocks) != keys:
        raise ValueError(f"{cfg.name}: block keys {sorted(blocks)} are not "
                         f"{sorted(keys)}")
    stacked = [t for t in _leaves(blocks) if t.shape[:1] != (cfg.num_periods,)]
    if stacked:
        raise ValueError(f"{cfg.name}: block leaves must be stacked over "
                         f"{cfg.num_periods} periods, got {stacked[0].shape}")
    emb = params["embed"]["emb"].shape
    if emb != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"{cfg.name}: embedding {tuple(emb)} is not "
                         f"{(cfg.padded_vocab, cfg.d_model)}")
    want = (cfg.patch_embed_dim, cfg.d_model) if cfg.num_patches else None
    got = tuple(params["patch_proj"]["w"].shape) if "patch_proj" in params else None
    if got != want:
        raise ValueError(f"{cfg.name}: patch_proj {got} is not {want}")
    return params


def whisper_params_from_numpy(cfg, tree: Mapping, device="cuda") -> dict:
    """Whisper's params (``repro.models.whisper.init_params`` layout: the
    ``encoder`` and ``decoder`` trees stacked over their layers, ``embed``,
    ``pos_dec``, ``enc_norm`` and ``dec_norm``) from a nested dict of numpy
    arrays.  Leaves keep their dtypes.  Raises if the tree does not fit
    ``cfg``: its top-level keys, every encoder leaf stacked over
    ``cfg.encoder_layers`` and decoder leaf over ``cfg.num_layers``, and the
    embedding and position tables' shapes."""
    device = resolve_device(device)
    params = tree_from_numpy(tree, device)
    keys = {"embed", "pos_dec", "encoder", "enc_norm", "decoder", "dec_norm"}
    if set(params) != keys:
        raise ValueError(f"{cfg.name}: keys {sorted(params)} are not {sorted(keys)}")
    for part, layers in (("encoder", cfg.encoder_layers), ("decoder", cfg.num_layers)):
        bad = [t for t in _leaves(params[part]) if t.shape[:1] != (layers,)]
        if bad:
            raise ValueError(f"{cfg.name}: {part} leaves must be stacked over "
                             f"{layers} layers, got {tuple(bad[0].shape)}")
    for name, got, want in (
            ("embedding", params["embed"]["emb"].shape, (cfg.padded_vocab, cfg.d_model)),
            ("pos_dec", params["pos_dec"].shape, (cfg.max_positions, cfg.d_model))):
        if tuple(got) != want:
            raise ValueError(f"{cfg.name}: {name} {tuple(got)} is not {want}")
    return params


def whisper_cache_from_numpy(self_k, self_v, cross_k, cross_v, device="cuda"):
    """The port's ``WhisperCache`` from numpy copies of a JAX one's leaves:
    the self-attention ``KVCache`` k and v [layers, B, max_len, KV, dh] and
    the cross-attention K and V [layers, B, F, KV, dh]."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.whisper import WhisperCache
    device = resolve_device(device)
    k, v, ck, cv = (_leaf_tensor(a, device) for a in (self_k, self_v, cross_k, cross_v))
    if k.shape != v.shape or ck.shape != cv.shape or k.shape[:2] != ck.shape[:2]:
        raise ValueError(f"cache leaves disagree: self {tuple(k.shape)} / "
                         f"{tuple(v.shape)}, cross {tuple(ck.shape)} / {tuple(cv.shape)}")
    return WhisperCache(self_kv=KVCache(k=k, v=v), cross_k=ck, cross_v=cv)


def _leaves(tree):
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]
