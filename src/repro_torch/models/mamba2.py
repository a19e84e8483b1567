"""Mamba-2 (SSD, state-space duality; arXiv:2405.21060) -- mamba2-780m and
the Jamba hybrid's mamba layers.

The PyTorch counterpart of ``repro/models/mamba2.py``, in its parameter
layout.  Chunked SSD forward: the sequence is split into chunks of length
Q; within a chunk the dual (attention-like) quadratic form gives the
intra-chunk output; the chunk-boundary states follow a linear recurrence
with a per-head scalar decay, a Python loop over the K chunks where the
JAX version scans.  Decode is the pure recurrence on a [B, H, P, N] state,
O(1) a token, written into the cache IN PLACE (as the attention and MLA
decodes write theirs).  One B/C group (ngroups = 1, Mamba-2's default).

The JAX package has no Pallas kernel for the SSD, so this is plain PyTorch
on either device, with JAX's float32 islands: ``dt``, ``a``, the cumulative
decay, the SSD contractions and the decode state update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding.policies import P

CONV_K = 4  # depthwise causal conv kernel width (Mamba default)


def mamba2_params(gen, d_model, d_inner, num_heads, d_state, dtype=torch.float32):
    conv_ch = d_inner + 2 * d_state
    dev = gen.device
    return {
        # order: [z | x | B | C | dt]
        "in_proj": L.truncnorm(
            gen, (d_model, 2 * d_inner + 2 * d_state + num_heads), d_model ** -0.5,
            dtype),
        "conv_w": L.truncnorm(gen, (CONV_K, conv_ch), conv_ch ** -0.5, dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.zeros((num_heads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((num_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((num_heads,), dtype=torch.float32, device=dev),
        "norm": L.rmsnorm_params(d_inner, dev),
        "out_proj": L.truncnorm(gen, (d_inner, d_model), d_inner ** -0.5, dtype),
    }


def mamba2_pspec():
    return {"in_proj": P("data", "model"), "conv_w": P(None, "model"),
            "conv_b": P("model"), "a_log": P("model"), "d_skip": P("model"),
            "dt_bias": P("model"), "norm": L.rmsnorm_pspec(),
            "out_proj": P("model", "data")}


def mamba2_contracting():
    # the conv is depthwise and the rest per channel: nothing contracted
    return {"in_proj": (0,), "conv_w": (), "conv_b": (), "a_log": (), "d_skip": (),
            "dt_bias": (), "out_proj": (0,)}


class MambaCache(NamedTuple):
    state: torch.Tensor  # [B, H, P, N] SSM state
    conv: torch.Tensor   # [B, CONV_K-1, d_inner + 2*d_state] conv tail


def init_mamba_cache(batch, d_inner, num_heads, d_state, dtype, device):
    head_dim = d_inner // num_heads
    return MambaCache(
        state=torch.zeros((batch, num_heads, head_dim, d_state), dtype=dtype,
                          device=device),
        conv=torch.zeros((batch, CONV_K - 1, d_inner + 2 * d_state), dtype=dtype,
                         device=device))


def mamba_cache_pspec():
    return MambaCache(state=P(("pod", "data"), "model", None, None),
                      conv=P(("pod", "data"), None, "model"))


def _split_proj(proj, d_inner, d_state, num_heads):
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    b = proj[..., 2 * d_inner:2 * d_inner + d_state]
    c = proj[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = proj[..., -num_heads:]
    return z, x, b, c, dt


def _causal_conv(u, w, bias):
    """Depthwise causal conv over seq: u [B,S,C], w [K,C] -> [B,S,C],
    accumulated in u's dtype as the JAX version does."""
    k, s = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + up[:, i:i + s, :] * w[i]
    return out + bias


def _project(params, xin, cd):
    return xin.to(cd) @ params["in_proj"].to(cd)


def _gated_out(params, y, z, cd):
    y = L.rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"].to(cd)


def mamba2_forward(params, xin, *, d_inner, num_heads, d_state, chunk=256,
                   compute_dtype=None, initial_state=None):
    """Full-sequence SSD. xin [B, S, D] -> ([B, S, D], final state
    [B, H, P, N] in the compute dtype)."""
    cd = compute_dtype or xin.dtype
    b, s, _ = xin.shape
    hd = d_inner // num_heads
    f32 = torch.float32
    z, x, bb, cc, dt = _split_proj(_project(params, xin, cd), d_inner, d_state,
                                   num_heads)
    xbc = F.silu(_causal_conv(torch.cat([x, bb, cc], dim=-1),
                              params["conv_w"].to(cd), params["conv_b"].to(cd)))
    x, bb, cc = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + d_state],
                 xbc[..., d_inner + d_state:])
    dt = F.softplus(dt.float() + params["dt_bias"])                  # [B,S,H]
    a = -torch.exp(params["a_log"])                                   # [H]
    da = dt * a                                                       # [B,S,H] (<=0)

    # pad to a chunk multiple
    s_p = -(-s // chunk) * chunk
    pad = s_p - s
    k = s_p // chunk

    def chunked(t, *tail):
        return F.pad(t, (0, 0, 0, pad)).reshape(b, k, chunk, *tail)

    x = chunked(x, num_heads, hd)                                     # [B,K,Q,H,P]
    bb, cc = chunked(bb, d_state), chunked(cc, d_state)               # [B,K,Q,N]
    dt_c, da_c = chunked(dt, num_heads), chunked(da, num_heads)       # [B,K,Q,H]
    xf, bf, cf = x.float(), bb.float(), cc.float()

    cum = torch.cumsum(da_c, dim=2)                                   # [B,K,Q,H]
    # intra-chunk dual form: L[i,j] = exp(cum_i - cum_j) * dt_j for i >= j;
    # above the diagonal cum_i - cum_j >= 0 may overflow exp, so it is set
    # to -inf first (exp -> 0, and exp's backward multiplies by that 0),
    # never multiplied by a 0/1 mask (inf * 0).  Only the difference is masked in place (the
    # subtraction's backward keeps no tensor); exp's output is kept for its
    # backward, so the products after it make new tensors
    upper = torch.ones((chunk, chunk), dtype=torch.bool, device=xin.device).triu(1)
    lmat = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :])       # [B,K,i,j,H]
                     .masked_fill_(upper[:, :, None], float("-inf")))
    lmat = lmat * dt_c[:, :, None, :, :]
    cb = torch.einsum("bkin,bkjn->bkij", cc, bb)                      # [B,K,Q,Q] in cd
    # y_intra[i] = sum_j cb[i,j] L[i,j] x[j]: the product with cb first, then
    # a batched matmul over j (one 3-operand einsum may form [B,K,Q,Q,H,P])
    lmat = lmat * cb.to(f32)[..., None]
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", lmat, xf)
    del lmat

    # chunk states: S_k = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum) * dt_c          # [B,K,Q,H]
    s_chunk = torch.einsum("bkjn,bkjhp->bkhnp", bf,
                           xf * decay_to_end[..., None])              # [B,K,H,N,P]

    # inter-chunk recurrence over the K chunks; s_enter[:, c] is the state
    # entering chunk c
    chunk_decay = torch.exp(cum[:, :, -1, :])                         # [B,K,H]
    state = (initial_state.transpose(2, 3).to(f32) if initial_state is not None
             else torch.zeros((b, num_heads, d_state, hd), dtype=f32,
                              device=xin.device))
    s_enter = []
    for c in range(k):
        s_enter.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    s_enter = torch.stack(s_enter, dim=1)                             # [B,K,H,N,P]

    y_inter = torch.einsum("bkin,bkhnp->bkihp", cf, s_enter) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s_p, num_heads, hd)[:, :s]
    y = y + x.reshape(b, s_p, num_heads, hd)[:, :s] * params["d_skip"][:, None]
    y = y.reshape(b, s, d_inner).to(cd)
    out = _gated_out(params, y, z, cd)
    return out, state.transpose(2, 3).to(cd)                          # [B,H,P,N]


def mamba2_decode(params, xin, cache: MambaCache, *, d_inner, num_heads,
                  d_state, compute_dtype=None):
    """One-token recurrence. xin [B, 1, D] -> ([B, 1, D], cache).

    Writes the new SSM state and conv tail into ``cache`` IN PLACE (the JAX
    version returns a new cache)."""
    cd = compute_dtype or xin.dtype
    b = xin.shape[0]
    hd = d_inner // num_heads
    f32 = torch.float32
    z, x, bb, cc, dt = _split_proj(_project(params, xin, cd)[:, 0], d_inner, d_state,
                                   num_heads)

    # rolling depthwise conv on [x|B|C]
    window = torch.cat([cache.conv.to(cd), torch.cat([x, bb, cc], dim=-1)[:, None]],
                       dim=1)                                         # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"].to(cd))
    xbc = F.silu(conv_out + params["conv_b"].to(cd))
    x, bb, cc = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + d_state],
                 xbc[..., d_inner + d_state:])

    dt = F.softplus(dt.float() + params["dt_bias"])                  # [B,H]
    dec = torch.exp(dt * -torch.exp(params["a_log"]))                # [B,H]
    xh = x.reshape(b, num_heads, hd).float()
    st = cache.state.float() * dec[..., None, None] + (
        dt[..., None, None] * xh[..., None] * bb[:, None, None, :].float())
    y = torch.einsum("bhpn,bn->bhp", st, cc.to(f32))
    y = y + xh * params["d_skip"][:, None]
    y = y.reshape(b, d_inner).to(cd)
    out = _gated_out(params, y, z, cd)
    cache.state.copy_(st)
    cache.conv.copy_(window[:, 1:])
    return out[:, None, :], cache
