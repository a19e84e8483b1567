"""Attention: GQA + RoPE + optional sliding window and attention-logit
soft-capping, a full-sequence path and a KV-cache decode path.

The PyTorch counterpart of ``repro/models/attention.py``, self- and
cross-attention (``kv_override``: whisper's decoder reads the encoder's
memory).  Layout: activations [B, S, D], heads [B, S, H, dh].  The full-sequence
``attention`` goes through ``dispatch.flash_attention``, so the tensor's
device decides: the hand-written flash kernel on a CUDA tensor, its plain
version on a CPU tensor (tests/test_torch_attention.py holds that against
the JAX package's ``sdpa_chunked``).  Both soft-cap the scaled scores
inside the kernel, as the JAX model does in ``sdpa_chunked``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import dispatch as K
from repro_torch.models import layers as L
from repro_torch.sharding.policies import P

NEG_INF = -1e30
FAR = 2**30          # position of a key that is never valid


def attn_params(gen, d_model, num_heads, num_kv, head_dim, dtype=torch.float32):
    s = d_model ** -0.5
    return {
        "wq": L.truncnorm(gen, (d_model, num_heads, head_dim), s, dtype),
        "wk": L.truncnorm(gen, (d_model, num_kv, head_dim), s, dtype),
        "wv": L.truncnorm(gen, (d_model, num_kv, head_dim), s, dtype),
        "wo": L.truncnorm(gen, (num_heads, head_dim, d_model),
                          (num_heads * head_dim) ** -0.5, dtype),
    }


def attn_pspec():
    return {"wq": P("data", "model", None), "wk": P("data", "model", None),
            "wv": P("data", "model", None), "wo": P("model", None, "data")}


def attn_contracting():
    return {"wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1)}


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, max_len, num_kv, head_dim]
    v: torch.Tensor  # [B, max_len, num_kv, head_dim]


def init_kv_cache(batch, max_len, num_kv, head_dim, dtype, device):
    shape = (batch, max_len, num_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def kv_cache_pspec():
    # seq over 'model': kv-head counts (4/8) rarely divide a TP axis, and
    # the decode caches are the big decode-side buffers
    return KVCache(k=P(("pod", "data"), "model", None, None),
                   v=P(("pod", "data"), "model", None, None))


def sdpa_decode(q, k, v, *, q_pos, k_pos, window=None, softcap_val=0.0):
    """One-token attention: q [B,1,H,dh], k/v [B,S,kv,dh] -> [B,1,H,dh],
    grouped so that no head-repeated cache is made.  q_pos [1]|[B] and
    k_pos [S]|[B,S]: per-slot positions for mixed-progress slots."""
    b, _, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k).float() * dh ** -0.5
    s = L.softcap(s, softcap_val)
    kp = k_pos if k_pos.dim() == 2 else k_pos[None, :]     # [B|1, S]
    qp = q_pos[:, None]                                   # [B|1, 1]
    keep = kp <= qp
    if window:
        keep &= kp > qp - window
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    return out.reshape(b, 1, h, dh)


def _project(x, w, cd):
    return torch.einsum("bsd,dhk->bshk", x.to(cd), w.to(cd))


def attention(params, x, *, num_heads, num_kv, head_dim, rope_theta=10000.0,
              causal=True, window=None, softcap_val=0.0, compute_dtype=None,
              rope=True, kv_override=None):
    """Full-sequence attention (training, prefill) over query positions
    0..S-1.

    x: [B, S, D] -> [B, S, D] through ``dispatch.flash_attention``, whose
    masks take positions as indices and which soft-caps the scaled scores
    at ``softcap_val`` (0 = none).  ``kv_override`` = (src [B, Sk, D],
    k_positions [Sk]) projects K and V from ``src`` (cross-attention; the
    positions only rotate K under ``rope``)."""
    cd = compute_dtype or x.dtype
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    src, k_pos = (x, positions) if kv_override is None else kv_override
    q = _project(x, params["wq"], cd)
    k = _project(src, params["wk"], cd)
    v = _project(src, params["wv"], cd)
    if rope:
        cos, sin = L.rope_cos_sin(positions, head_dim, rope_theta)
        q = L.apply_rope(q, cos, sin)
        cos, sin = L.rope_cos_sin(k_pos, head_dim, rope_theta)
        k = L.apply_rope(k, cos, sin)
    out = K.flash_attention(q, k, v, causal=causal, window=window or 0,
                            softcap=softcap_val)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cd))


def _write_kv(params, x, cache: KVCache, cache_len, cd, cos, sin, ring: bool):
    """Project x's K and V (rotated by cos/sin unless they are None) and
    write them into ``cache`` at ``cache_len`` (modulo its length when
    ``ring``), in place."""
    b = x.shape[0]
    max_len = cache.k.shape[1]
    k_new = _project(x, params["wk"], cd)
    v_new = _project(x, params["wv"], cd)
    if cos is not None:
        k_new = L.apply_rope(k_new, cos, sin)
    write = torch.remainder(cache_len, max_len) if ring else cache_len
    if cache_len.dim() == 1:
        # .at[rows, write].set drops a row whose write is past the cache:
        # such a row rewrites its last cell with what it holds
        ok = (write < max_len)[:, None, None]
        rows = torch.arange(b, device=x.device)
        w = write.clamp(max=max_len - 1).long()
        for buf, new in ((cache.k, k_new), (cache.v, v_new)):
            buf[rows, w] = torch.where(ok, new[:, 0].to(buf.dtype), buf[rows, w])
    else:
        # dynamic_update_slice clamps the start into the cache
        w = write.clamp(max=max_len - 1).long()
        cache.k.index_copy_(1, w.reshape(1), k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, w.reshape(1), v_new.to(cache.v.dtype))


def attention_decode(params, x, cache: KVCache, cache_len, *, num_heads,
                     num_kv, head_dim, rope_theta=10000.0, window=None,
                     softcap_val=0.0, compute_dtype=None, rope=True, ring=False,
                     update_cache=True):
    """One-token decode: x [B, 1, D]; ``cache_len`` (an int, a 0-d tensor, or
    a [B] tensor of per-slot lengths) tokens decoded so far, the new
    token's absolute position.

    Writes the new K/V into ``cache`` IN PLACE (the JAX version returns a
    new cache; the port saves the copy) and returns (out [B,1,D], cache).
    ring=True keeps the cache as a ring buffer over absolute positions
    (sliding-window layers keep only ``window`` slots).
    update_cache=False reads only (cross-attention): the first
    ``cache_len`` cells are valid and nothing is written."""
    cd = compute_dtype or x.dtype
    max_len = cache.k.shape[1]
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    vec = cache_len.dim() == 1
    pos = cache_len[:, None] if vec else cache_len.reshape(1)
    q = _project(x, params["wq"], cd)
    cos = sin = None
    if rope:
        cos, sin = L.rope_cos_sin(pos, head_dim, rope_theta)
        if not vec:     # [1, dh/2] -> [1, 1, dh/2]: broadcast over the batch
            cos, sin = cos[None], sin[None]
        q = L.apply_rope(q, cos, sin)
    if update_cache:
        _write_kv(params, x, cache, cache_len, cd, cos, sin, ring)
    slots = torch.arange(max_len, dtype=torch.int32, device=x.device)
    valid_len = cache_len + 1 if update_cache else cache_len
    vl = valid_len[:, None] if vec else valid_len
    if ring:
        # slot i holds the largest absolute position p <= cache_len with
        # p == i (mod max_len); negative p = never written
        last = vl - 1
        k_pos = last - torch.remainder(last - slots, max_len)
        k_pos = torch.where(k_pos >= 0, k_pos, FAR)
    else:
        k_pos = torch.where(slots < vl, slots, FAR)
    q_pos = pos[:, 0] if vec else pos
    out = sdpa_decode(q, cache.k.to(cd), cache.v.to(cd), q_pos=q_pos,
                      k_pos=k_pos, window=window, softcap_val=softcap_val)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cd))
    return y, cache
