"""Multi-head Latent Attention (DeepSeek-V2), the mixer of deepseek-v2-lite.

The PyTorch counterpart of ``repro/models/mla.py``.
Keys and values are compressed into a per-token latent c_kv (kv_lora_rank)
plus one shared RoPE key (qk_rope_dim); the decode cache holds only
(c_kv, k_rope).  Prefill expands K/V per head and goes through
``dispatch.flash_attention`` (the hand-written kernel on a CUDA tensor,
its plain version on a CPU tensor), V zero-padded to the qk head dim so
that one call serves both.  Decode is the absorbed form (q through W_uk,
the output through W_uv) over the latent cache, in plain PyTorch, as the
JAX package computes it outside Pallas.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch as K
from repro_torch.models import layers as L
from repro_torch.sharding.policies import P


def mla_params(gen, d_model, num_heads, kv_lora, qk_nope, qk_rope, v_head,
               dtype=torch.float32):
    s = d_model ** -0.5
    return {
        "wq": L.truncnorm(gen, (d_model, num_heads, qk_nope + qk_rope), s, dtype),
        "wdkv": L.truncnorm(gen, (d_model, kv_lora + qk_rope), s, dtype),
        "kv_norm": L.rmsnorm_params(kv_lora, gen.device),
        "wuk": L.truncnorm(gen, (kv_lora, num_heads, qk_nope), kv_lora ** -0.5, dtype),
        "wuv": L.truncnorm(gen, (kv_lora, num_heads, v_head), kv_lora ** -0.5, dtype),
        "wo": L.truncnorm(gen, (num_heads, v_head, d_model),
                          (num_heads * v_head) ** -0.5, dtype),
    }


def mla_pspec():
    return {"wq": P("data", "model", None), "wdkv": P("data", None),
            "kv_norm": L.rmsnorm_pspec(),
            "wuk": P(None, "model", None), "wuv": P(None, "model", None),
            "wo": P("model", None, "data")}


def mla_contracting():
    return {"wq": (0,), "wdkv": (0,), "wuk": (0,), "wuv": (0,), "wo": (0, 1)}


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # [B, max_len, kv_lora]
    k_rope: torch.Tensor  # [B, max_len, qk_rope]


def init_mla_cache(batch, max_len, kv_lora, qk_rope, dtype, device):
    return MLACache(
        c_kv=torch.zeros((batch, max_len, kv_lora), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, max_len, qk_rope), dtype=dtype, device=device))


def mla_cache_pspec():
    # seq over 'model', as attention.kv_cache_pspec
    return MLACache(c_kv=P(("pod", "data"), "model", None),
                    k_rope=P(("pod", "data"), "model", None))


def _project_latent(params, x, qk_rope, rope_theta, positions, cd):
    """x -> (c_kv normalized [B, S, R], k_rope roped [B, S, rope])."""
    dkv = torch.einsum("bsd,dr->bsr", x.to(cd), params["wdkv"].to(cd))
    c_kv, k_rope = dkv[..., :-qk_rope], dkv[..., -qk_rope:]
    c_kv = L.rmsnorm(params["kv_norm"], c_kv)
    ck, sk = L.rope_cos_sin(positions, qk_rope, rope_theta)
    k_rope = L.apply_rope(k_rope[:, :, None, :], ck, sk)[:, :, 0, :]
    return c_kv, k_rope


def mla_attention(params, x, *, num_heads, qk_nope, qk_rope, v_head,
                  rope_theta=10000.0, compute_dtype=None):
    """Prefill over positions 0..S-1: x [B, S, D] -> [B, S, D], per-head K/V
    expanded from the latent, causal attention through
    ``dispatch.flash_attention`` at head dim qk_nope + qk_rope (its scale
    dh^-0.5 is JAX's (qk_nope + qk_rope)^-0.5)."""
    del num_heads      # the weights carry it
    cd = compute_dtype or x.dtype
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    q = torch.einsum("bsd,dhk->bshk", x.to(cd), params["wq"].to(cd))
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    cq, sq = L.rope_cos_sin(positions, qk_rope, rope_theta)
    q_rope = L.apply_rope(q_rope, cq, sq)

    c_kv, k_rope = _project_latent(params, x, qk_rope, rope_theta, positions, cd)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["wuk"].to(cd))
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["wuv"].to(cd))
    # the shared rope key broadcast to every head, concatenated into one
    # head dim (torch.cat makes k contiguous, as the kernel needs)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], qk_rope)],
                  dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    # V padded up to the qk head dim; its padding columns are sliced off
    vp = F.pad(v, (0, qq.shape[-1] - v_head))
    out = K.flash_attention(qq, k, vp, causal=True)[..., :v_head]
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cd))


def mla_decode(params, x, cache: MLACache, cache_len, *, num_heads, qk_nope,
               qk_rope, v_head, rope_theta=10000.0, compute_dtype=None):
    """Absorbed one-token decode over the latent cache: x [B, 1, D];
    ``cache_len`` (an int, a 0-d tensor, or a [B] tensor of per-slot
    lengths) tokens decoded so far.

        score_h(t) = <W_uk_h^T q_nope_h, c_kv_t> + <q_rope, k_rope_t>
        out_h      = W_uv_h^T (sum_t p_h(t) c_kv_t)

    Writes the new latent into ``cache`` IN PLACE (the JAX version returns a
    new cache) and returns (out [B, 1, D], cache)."""
    del num_heads, v_head
    cd = compute_dtype or x.dtype
    b = x.shape[0]
    max_len = cache.c_kv.shape[1]
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    vec = cache_len.dim() == 1          # per-slot positions ([B], the engine)
    pos = cache_len[:, None] if vec else cache_len.reshape(1)
    q = torch.einsum("bsd,dhk->bshk", x.to(cd), params["wq"].to(cd))
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    cq, sq = L.rope_cos_sin(pos, qk_rope, rope_theta)
    if not vec:     # [1, rope/2] -> [1, 1, rope/2]: broadcast over the batch
        cq, sq = cq[None], sq[None]
    q_rope = L.apply_rope(q_rope, cq, sq)[:, 0]                      # [B, H, rope]
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["wuk"].to(cd))

    c_new, kr_new = _project_latent(params, x, qk_rope, rope_theta, pos, cd)
    if vec:
        # .at[rows, cache_len].set drops a row whose length is past the
        # cache: such a row rewrites its last cell with what it holds
        ok = (cache_len < max_len)[:, None]
        rows = torch.arange(b, device=x.device)
        w = cache_len.clamp(max=max_len - 1).long()
        for buf, new in ((cache.c_kv, c_new), (cache.k_rope, kr_new)):
            buf[rows, w] = torch.where(ok, new[:, 0].to(buf.dtype), buf[rows, w])
    else:
        # dynamic_update_slice clamps the start into the cache
        w = cache_len.clamp(max=max_len - 1).long().reshape(1)
        cache.c_kv.index_copy_(1, w, c_new.to(cache.c_kv.dtype))
        cache.k_rope.index_copy_(1, w, kr_new.to(cache.k_rope.dtype))

    c_all, kr_all = cache.c_kv.to(cd), cache.k_rope.to(cd)
    scores = (torch.einsum("bhr,btr->bht", q_abs, c_all)
              + torch.einsum("bhk,btk->bht", q_rope, kr_all))
    scores = scores.float() * (qk_nope + qk_rope) ** -0.5
    t_idx = torch.arange(max_len, device=x.device)
    cl = cache_len[:, None, None] if vec else cache_len
    scores = torch.where(t_idx[None, None, :] <= cl, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,btr->bhr", p.to(cd), c_all)
    out = torch.einsum("bhr,rhk->bhk", ctx, params["wuv"].to(cd))
    y = torch.einsum("bhk,hkd->bd", out, params["wo"].to(cd))
    return y[:, None, :], cache
