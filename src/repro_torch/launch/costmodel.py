"""Analytic per-cell cost model: FLOPs and HBM traffic for the roofline,
the counterpart of ``repro/launch/costmodel.py``.

The numerators are exact matmul counts derived from the model math (the
standard way frameworks compute MFU); nothing here is measured.  A
training step is the forward x 3 (backward = 2x the forward's matmuls),
one forward more under remat="full" (the backward recomputes each
period), + ~10 FLOPs a parameter for the optimizer, as in JAX.  One
deliberate difference counts the port's own work: the MoE pack and unpack
are copies (``onehot_dispatch`` / ``onehot_combine``), not one-hot
einsums: 0 FLOPs, JAX's moe_impl="sort" branch.

Conventions: multiply-add = 2 FLOPs; `ctx` = average attended context.
A cell's shape is a name of SHAPES or such a dict, so a measured step's
own shape (chip_smoke.py phase H) can be counted too.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.configs.base import ArchConfig, shape_spec


def _avg_causal_ctx(s: int, window: int = 0) -> float:
    """Average #keys a causal query attends: (S+1)/2, or windowed."""
    if window and window < s:
        # positions < window attend i+1; the rest attend `window`
        return (window * (window + 1) / 2 + (s - window) * window) / s
    return (s + 1) / 2


def _attn_flops_tok(cfg: ArchConfig, ctx: float) -> float:
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    proj = 2 * d * h * hd + 2 * 2 * d * kv * hd + 2 * h * hd * d
    sdpa = 2 * h * hd * ctx * 2          # scores + AV
    return proj + sdpa


def _mla_flops_tok(cfg: ArchConfig, ctx: float, decode: bool) -> float:
    h, d = cfg.num_heads, cfg.d_model
    r, nq, nr, vh = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    wq = 2 * d * h * (nq + nr)
    wdkv = 2 * d * (r + nr)
    wo = 2 * h * vh * d
    if decode:                            # absorbed path (mla.mla_decode)
        return (wq + wdkv + wo + 2 * h * nq * r
                + 2 * h * (r + nr) * ctx + 2 * h * r * ctx
                + 2 * r * h * vh)
    expand = 2 * r * h * nq + 2 * r * h * vh
    sdpa = 2 * h * (nq + nr) * ctx + 2 * h * vh * ctx
    return wq + wdkv + expand + wo + sdpa


def _mamba_flops_tok(cfg: ArchConfig, decode: bool) -> float:
    d, di, n, hh = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.ssm_heads
    proj = 2 * d * (2 * di + 2 * n + hh) + 2 * di * d   # in_proj + out_proj
    conv = 2 * 4 * (di + 2 * n)
    if decode:
        ssd = 6 * di * n                 # state decay+rank1 update+readout
    else:
        q = cfg.ssm_chunk
        ssd = 2 * q * n + 2 * q * di + 4 * n * di       # intra + states
    return proj + conv + ssd


def _moe_flops_tok(cfg: ArchConfig) -> float:
    d, e, k, ffm = (cfg.d_model, cfg.num_experts, cfg.top_k, cfg.moe_d_ff)
    slots = e + cfg.ditto_secondary
    router = 2 * d * e
    # expert compute runs on CAPACITY slots (GShard dispatch), i.e. the
    # padded k*cf*(1+X/E) tokens-per-token equivalent; the pack and unpack
    # are copies (0 FLOPs)
    expert = 2 * 3 * d * ffm * k * cfg.capacity_factor * (slots / e)
    shared = 0.0
    if cfg.num_shared_experts:
        shared = 2 * 3 * d * (cfg.shared_d_ff or ffm * cfg.num_shared_experts)
    return router + expert + shared


def _dense_ffn_flops_tok(cfg: ArchConfig) -> float:
    mats = 3 if cfg.mlp_gated else 2
    return 2 * cfg.d_model * cfg.d_ff * mats


def forward_flops_per_token(cfg: ArchConfig, kind: str, seq: int) -> float:
    """Layer-stack forward FLOPs per (decoder) token + unembed."""
    decode = kind == "decode"
    total = 0.0
    for mk, fk in zip(cfg.block_pattern, cfg.ffn_pattern):
        if mk in ("attn", "attn_local", "attn_nocausal"):
            if decode:
                ctx = float(seq)
                if mk == "attn_local":
                    ctx = float(min(seq, cfg.window))
            elif mk == "attn_nocausal":
                ctx = float(seq)
            else:
                ctx = _avg_causal_ctx(seq, cfg.window if mk == "attn_local" else 0)
            total += _attn_flops_tok(cfg, ctx)
        elif mk == "mla":
            ctx = float(seq) if decode else _avg_causal_ctx(seq)
            total += _mla_flops_tok(cfg, ctx, decode)
        elif mk == "mamba":
            total += _mamba_flops_tok(cfg, decode)
        if fk == "dense":
            total += _dense_ffn_flops_tok(cfg)
        elif fk == "moe":
            total += _moe_flops_tok(cfg)
    total *= cfg.num_periods
    total += 2 * cfg.d_model * cfg.vocab          # unembed
    return total


def _whisper_forward_flops(cfg: ArchConfig, batch: int, seq: int,
                           decode: bool) -> float:
    """Whisper: encoder over F frames + decoder self+cross+mlp over S."""
    f = cfg.encoder_len
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    mlp = 2 * d * cfg.d_ff * 2                    # non-gated
    enc_tok = _attn_flops_tok(cfg, float(f)) + mlp
    enc = 0.0 if decode else cfg.encoder_layers * enc_tok * f * batch
    ctx_self = float(seq) if decode else _avg_causal_ctx(seq)
    # cross-attn: K/V of memory precomputed once per request; at decode we
    # charge only q/o proj + sdpa against F
    cross = (2 * d * h * hd + 2 * h * hd * d + 2 * h * hd * f * 2)
    dec_tok = (_attn_flops_tok(cfg, ctx_self) + cross + mlp)
    n_tok = batch * (1 if decode else seq)
    dec = cfg.num_layers * dec_tok * n_tok
    unembed = 2 * d * cfg.vocab * n_tok
    return enc + dec + unembed


def cell_flops(cfg: ArchConfig, shape) -> Dict[str, float]:
    """Global FLOPs for one cell: {'forward', 'total'} (total folds in
    backward x2, remat="full"'s recomputed forward x1, and ~10 FLOPs/param
    optimizer; remat="dots" recomputes all but the products, which the
    count leaves out, as JAX's does)."""
    spec = shape_spec(shape)
    seq, gb, kind = spec["seq_len"], spec["global_batch"], spec["kind"]
    if cfg.family == "encdec":
        fwd = _whisper_forward_flops(cfg, gb, seq, kind == "decode")
    else:
        st = seq - cfg.num_patches if cfg.num_patches else seq
        n_tok = gb * (1 if kind == "decode" else st)
        fwd = forward_flops_per_token(cfg, kind, seq) * n_tok
    if kind != "train":
        return {"forward": fwd, "total": fwd}
    from repro_torch.models.zoo import param_count
    remat = 1.0 if cfg.remat == "full" else 0.0
    return {"forward": fwd, "total": fwd * (3.0 + remat) + 10.0 * param_count(cfg)}


# ------------------------------------------------------------- HBM traffic

def cell_bytes(cfg: ArchConfig, shape) -> Dict[str, float]:
    """Global HBM traffic estimate (bytes) -- coarse but explicit:

    decode : params (serve dtype) + full cache read + token write
    prefill: params + activation r/w (c_act*d bytes/tok/layer) + logits
    train  : ~9 param-size passes (fwd/bwd/remat reads, grad write, opt
             m/v r+w, param r+w) + 3 activation passes + fp32 logits,
             JAX's estimate as it is (one remat read under every ``remat``)

    The decode cache is sized from the port's own ``init_cache`` on meta.
    """
    from repro_torch.models import layers as L
    from repro_torch.models import zoo as Z
    from repro_torch.tree import tree_leaves
    spec = shape_spec(shape)
    seq, gb, kind = spec["seq_len"], spec["global_batch"], spec["kind"]
    n_params = Z.param_count(cfg)
    act_width = 2 * (2 * cfg.d_model
                     + max(cfg.d_ff, cfg.moe_d_ff * cfg.top_k,
                           cfg.num_heads * cfg.head_dim, cfg.d_inner))

    if kind == "decode":
        model = Z.build(cfg, "meta")
        params = model.init_params(L.ShapeOnly()) if cfg.family == "encdec" else None
        cache = model.init_cache(params, gb, seq)
        cache_bytes = sum(math.prod(t.shape) * t.element_size()
                          for t in tree_leaves(cache))
        return {"total": 2 * n_params + cache_bytes
                + gb * cfg.num_layers * act_width}

    st = seq - cfg.num_patches if cfg.num_patches else seq
    n_tok = gb * st
    act = n_tok * cfg.num_layers * act_width
    logits = n_tok * cfg.vocab * (4 if kind == "train" else 2)
    if kind == "prefill":
        return {"total": 2 * n_params + act + logits}
    return {"total": 9 * 4 * n_params + 3 * act + 3 * logits}
