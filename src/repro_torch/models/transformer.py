"""Decoder-only LM assembly over layer *periods* (the repeating mixer x FFN
pattern of ``ArchConfig``), in the parameter layout of
``repro/models/transformer.py``: every leaf of ``params["blocks"]`` and of
the cache is stacked over periods on a leading axis.  A Python loop over
periods takes the place of the JAX ``lax.scan``.

It covers the mixer kinds ``attn``, ``attn_local``, ``attn_nocausal``,
``mla`` and ``mamba`` and the FFN kinds ``dense``, ``moe`` and ``none``
(a layer without ``norm2`` and ``ffn``): the dense, MoE, SSM, hybrid and
VLM families, the last with its patch embeddings prepended to the tokens'
(``patch_proj``).  The encoder-decoder family (whisper) is in
``whisper.py``.

Activation checkpointing (``cfg.remat``) wraps each period of a forward
that autograd records, as the JAX version's ``jax.checkpoint`` does:
``full`` keeps each period's input and recomputes its forward in the
backward; ``dots`` also keeps the outputs of products with no batch dims
(``DOTS``); ``none`` keeps everything.  A forward that is not recorded
(prefill, serving) runs as it would under ``none``.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.sharding.policies import P
from repro_torch.tree import tree_leaves, tree_map, tree_unzip

ATTN_KINDS = ("attn", "attn_local", "attn_nocausal")
MIXER_KINDS = (*ATTN_KINDS, "mla", "mamba")
FFN_KINDS = ("dense", "moe", "none")


def _check_kinds(cfg: ArchConfig):
    for mk, fk in zip(cfg.block_pattern, cfg.ffn_pattern):
        if mk not in MIXER_KINDS:
            raise ValueError(f"mixer kind {mk!r}")
        if fk not in FFN_KINDS:
            raise ValueError(f"ffn kind {fk!r}")


def take(tree, i: int):
    """The ``i``-th entry of every leaf of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree, n: int) -> tuple:
    """The ``n`` entries of every leaf of a stacked dict tree, as ``n``
    trees (views).  One ``unbind`` a leaf: its backward stacks the ``n``
    gradients once, where ``take`` a period would add a zero-filled
    gradient of the whole stack into the leaf's each period: traffic
    quadratic in the depth (PERF.md §5)."""
    return tree_unzip(tree_map(lambda t: t.unbind(0), tree), n)


def tree_to(tree, device):
    """A copy of a params or cache tree on ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ------------------------------------------------------------------ params

def _mixer_params(cfg: ArchConfig, kind: str, gen: torch.Generator):
    if kind == "mamba":
        return M.mamba2_params(gen, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                               cfg.d_state, cfg.pdtype)
    if kind == "mla":
        return MLA.mla_params(gen, cfg.d_model, cfg.num_heads, cfg.kv_lora_rank,
                              cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                              cfg.pdtype)
    return A.attn_params(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.pdtype)


def period_params(cfg: ArchConfig, gen: torch.Generator):
    """Parameters of ONE period (stacked over periods by init_params)."""
    p = {}
    for j, (mk, fk) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
        p[f"{j}.norm1"] = L.rmsnorm_params(cfg.d_model, gen.device)
        p[f"{j}.mixer"] = _mixer_params(cfg, mk, gen)
        if fk == "none":            # pure-mamba blocks (mamba2-780m: d_ff=0)
            continue
        p[f"{j}.norm2"] = L.rmsnorm_params(cfg.d_model, gen.device)
        if fk == "dense":
            p[f"{j}.ffn"] = L.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.pdtype,
                                         gated=cfg.mlp_gated)
        else:
            p[f"{j}.ffn"] = MOE.moe_params(gen, cfg.d_model, cfg.moe_d_ff,
                                           cfg.num_experts, cfg.pdtype,
                                           cfg.num_shared_experts, cfg.shared_d_ff)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator):
    """Random weights on the generator's device, from its state."""
    _check_kinds(cfg)
    p = {"embed": L.embed_params(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype),
         "blocks": _stack([period_params(cfg, gen) for _ in range(cfg.num_periods)]),
         "final_norm": L.rmsnorm_params(cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_params(gen, cfg.d_model, cfg.vocab, cfg.pdtype)
    if cfg.num_patches:
        p["patch_proj"] = L.dense_params(gen, cfg.patch_embed_dim, cfg.d_model,
                                         cfg.pdtype)
    return p


def _stacked(spec_tree):
    """Specs of leaves stacked over periods (or layers): a leading None."""
    return tree_map(lambda spec: P(None, *spec), spec_tree)


def _mixer_pspec(kind: str):
    if kind == "mamba":
        return M.mamba2_pspec()
    if kind == "mla":
        return MLA.mla_pspec()
    return A.attn_pspec()


def period_pspec(cfg: ArchConfig):
    """The spec tree of ``period_params``."""
    _check_kinds(cfg)
    p = {}
    for j, (mk, fk) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
        p[f"{j}.norm1"] = L.rmsnorm_pspec()
        p[f"{j}.mixer"] = _mixer_pspec(mk)
        if fk == "none":
            continue
        p[f"{j}.norm2"] = L.rmsnorm_pspec()
        p[f"{j}.ffn"] = (L.mlp_pspec(gated=cfg.mlp_gated) if fk == "dense"
                         else MOE.moe_pspec(cfg.num_shared_experts))
    return p


def params_pspec(cfg: ArchConfig):
    """The spec tree of ``init_params``."""
    p = {"embed": L.embed_pspec(), "blocks": _stacked(period_pspec(cfg)),
         "final_norm": L.rmsnorm_pspec()}
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_pspec("data", "model")
    if cfg.num_patches:
        p["patch_proj"] = L.dense_pspec(None, "data")
    return p


def params_contracting(cfg: ArchConfig):
    """The contracting dims of ``init_params``'s weight leaves (layers.py),
    the blocks' in one period's layout."""
    _check_kinds(cfg)
    blocks = {}
    for j, (mk, fk) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
        blocks[f"{j}.mixer"] = (M.mamba2_contracting() if mk == "mamba" else
                                MLA.mla_contracting() if mk == "mla" else A.attn_contracting())
        if fk != "none":
            blocks[f"{j}.ffn"] = (L.mlp_contracting(gated=cfg.mlp_gated) if fk == "dense"
                                  else MOE.moe_contracting(cfg.num_shared_experts))
    p = {"embed": L.embed_contracting(), "blocks": blocks}
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_contracting()
    if cfg.num_patches:
        p["patch_proj"] = L.dense_contracting()
    return p


# ----------------------------------------------------------------- forward

def _apply_mixer(cfg: ArchConfig, kind: str, pp, x):
    cd = cfg.cdtype
    if kind == "mamba":
        # the prefill starts from a zero state and drops the final one, as
        # the JAX version's _period_forward does
        y, _ = M.mamba2_forward(pp, x, d_inner=cfg.d_inner, num_heads=cfg.ssm_heads,
                                d_state=cfg.d_state, chunk=cfg.ssm_chunk,
                                compute_dtype=cd)
        return y
    if kind == "mla":
        return MLA.mla_attention(
            pp, x, num_heads=cfg.num_heads, qk_nope=cfg.qk_nope_dim,
            qk_rope=cfg.qk_rope_dim, v_head=cfg.v_head_dim,
            rope_theta=cfg.rope_theta, compute_dtype=cd)
    return A.attention(
        pp, x, num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        causal=(kind != "attn_nocausal"),
        window=cfg.window if kind == "attn_local" else None,
        softcap_val=cfg.attn_softcap, compute_dtype=cd, rope=cfg.use_rope)


def _apply_ffn(cfg: ArchConfig, kind: str, pp, x):
    cd = cfg.cdtype
    if kind == "dense":
        return L.mlp(pp, x, act=cfg.act, compute_dtype=cd), None
    return MOE.moe_apply(
        pp, x, num_experts=cfg.num_experts, top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor, num_secondary=cfg.ditto_secondary,
        act=cfg.act, compute_dtype=cd, group_size=cfg.moe_group_size)


def _logits(cfg: ArchConfig, params, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (L.unembed(params["embed"], x, cfg.cdtype, cfg.vocab)
              if cfg.tie_embeddings else L.dense(params["unembed"], x, cfg.cdtype))
    return L.softcap(logits, cfg.logit_softcap)


def _period_forward(cfg: ArchConfig, pp, x):
    """One period's layers: x [B, S, D] -> (x, the period's load-balance
    loss, or None without an MoE layer)."""
    lb = None
    for j, (mk, fk) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
        h = L.rmsnorm(pp[f"{j}.norm1"], x, cfg.norm_eps)
        x = x + _apply_mixer(cfg, mk, pp[f"{j}.mixer"], h)
        if fk == "none":
            continue
        h = L.rmsnorm(pp[f"{j}.norm2"], x, cfg.norm_eps)
        y, aux = _apply_ffn(cfg, fk, pp[f"{j}.ffn"], h)
        x = x + y
        if aux is not None:
            lb = aux["lb_loss"] if lb is None else lb + aux["lb_loss"]
    return x, lb


# the products with no batch dims, whose outputs remat="dots" keeps (JAX's
# dots_with_no_batch_dims_saveable): x @ w is an mm (or addmm), and an
# einsum with no batch dims (the attention and MLA projections) a bmm over
# a batch of one
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, func, *args, **kwargs):
    del ctx, kwargs
    if func in DOTS or (func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def recorded(*trees) -> bool:
    """Whether autograd records a forward of these inputs (tensors or
    params trees): grad mode is on and one of their leaves requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(trees))


def remat(body, mode: str, record: bool):
    """``body`` under activation checkpointing ``mode`` (none|full|dots)
    where ``record``, else ``body`` itself.  Non-reentrant checkpointing;
    the forward draws no random numbers, so no RNG state is kept."""
    if mode == "none" or not record:
        return body
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _keep_dots)
    return functools.partial(checkpoint, body, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def forward(cfg: ArchConfig, params, tokens, *, patches=None):
    """tokens [B, S] (+ patches [B, P, patch_embed_dim] for the VLM) ->
    (logits [B, P + S, V], {"lb_loss"}): the full causal forward of
    prefill and training.  The VLM's projected patches come first in the
    sequence, and the logits keep their positions.  Each period runs
    under ``cfg.remat`` when autograd records the forward."""
    _check_kinds(cfg)
    x = L.embed_lookup(params["embed"], tokens, cfg.cdtype)
    if cfg.num_patches:
        if patches is None:
            raise ValueError(f"{cfg.name}: the forward takes patches "
                             f"{(tokens.shape[0], cfg.num_patches, cfg.patch_embed_dim)}")
        x = torch.cat([L.dense(params["patch_proj"], patches, cfg.cdtype), x], dim=1)
    body = remat(functools.partial(_period_forward, cfg), cfg.remat,
                 recorded(x, params["blocks"]))
    lb_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for pp in unstack(params["blocks"], cfg.num_periods):
        x, lb = body(pp, x)
        if lb is not None:
            lb_loss = lb_loss + lb
    return _logits(cfg, params, x), {"lb_loss": lb_loss}


# ------------------------------------------------------------------ decode

def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict[str, Any]:
    """Per-period caches, {str(j): KVCache | MLACache | MambaCache} with
    leaves [num_periods, batch, ...]; local layers keep only their window,
    MLA layers the latent and the rope key, mamba layers their SSM state
    and conv tail (no length)."""
    _check_kinds(cfg)
    n = cfg.num_periods * batch
    caches = {}
    for j, mk in enumerate(cfg.block_pattern):
        if mk == "mla":
            c = MLA.init_mla_cache(n, max_len, cfg.kv_lora_rank, cfg.qk_rope_dim,
                                   cfg.cdtype, device)
        elif mk == "mamba":
            c = M.init_mamba_cache(n, cfg.d_inner, cfg.ssm_heads, cfg.d_state,
                                   cfg.cdtype, device)
        else:
            ln = min(max_len, cfg.window) if mk == "attn_local" else max_len
            c = A.init_kv_cache(n, ln, cfg.num_kv_heads, cfg.head_dim, cfg.cdtype,
                                device)
        caches[str(j)] = type(c)(*(t.view(cfg.num_periods, batch, *t.shape[1:])
                                   for t in c))
    return caches


def cache_pspec(cfg: ArchConfig):
    """The spec tree of ``init_cache``."""
    _check_kinds(cfg)
    caches = {}
    for j, mk in enumerate(cfg.block_pattern):
        caches[str(j)] = (MLA.mla_cache_pspec() if mk == "mla" else
                          M.mamba_cache_pspec() if mk == "mamba" else A.kv_cache_pspec())
    return _stacked(caches)


def decode_step(cfg: ArchConfig, params, tokens, cache, cache_len):
    """One-token decode: tokens [B, 1] -> (logits [B, 1, V], cache).

    ``cache_len`` (int, 0-d or [B] tensor) is the number of valid positions
    already in the cache; the new K/V (latent, SSM state) are written into
    ``cache`` in place."""
    cd = cfg.cdtype
    x = L.embed_lookup(params["embed"], tokens, cd)
    for i in range(cfg.num_periods):
        pp = take(params["blocks"], i)
        for j, (mk, fk) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern)):
            h = L.rmsnorm(pp[f"{j}.norm1"], x, cfg.norm_eps)
            if mk == "mamba":
                y, _ = M.mamba2_decode(
                    pp[f"{j}.mixer"], h, take(cache[str(j)], i), d_inner=cfg.d_inner,
                    num_heads=cfg.ssm_heads, d_state=cfg.d_state, compute_dtype=cd)
            elif mk == "mla":
                y, _ = MLA.mla_decode(
                    pp[f"{j}.mixer"], h, take(cache[str(j)], i), cache_len,
                    num_heads=cfg.num_heads, qk_nope=cfg.qk_nope_dim,
                    qk_rope=cfg.qk_rope_dim, v_head=cfg.v_head_dim,
                    rope_theta=cfg.rope_theta, compute_dtype=cd)
            else:
                y, _ = A.attention_decode(
                    pp[f"{j}.mixer"], h, take(cache[str(j)], i), cache_len,
                    num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    window=cfg.window if mk == "attn_local" else None,
                    softcap_val=cfg.attn_softcap, compute_dtype=cd,
                    rope=cfg.use_rope, ring=(mk == "attn_local"))
            x = x + y
            if fk == "none":
                continue
            h = L.rmsnorm(pp[f"{j}.norm2"], x, cfg.norm_eps)
            y, _ = _apply_ffn(cfg, fk, pp[f"{j}.ffn"], h)
            x = x + y
    return _logits(cfg, params, x), cache
