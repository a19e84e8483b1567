"""Whisper-style encoder-decoder backbone (the ``encdec`` family), the
PyTorch counterpart of ``repro/models/whisper.py``.

The conv frontend is a stub: the caller hands ``encode`` precomputed frame
embeddings [B, frames, d_model] (``frontends.random_frames``).  The encoder
is a non-causal transformer over the frames; the decoder a causal one with
cross-attention to the encoder's memory after each self-attention.  No
RoPE: sinusoidal positions are added to the frames, learned ones
(``pos_dec``) to the tokens.  LayerNorms, a non-gated GELU MLP and tied
embeddings.

The parameter layout is the JAX package's: every leaf of ``encoder`` and
``decoder`` is stacked over layers on a leading axis, and a Python loop
over layers takes the place of ``lax.scan``.  Every attention of the
encoder and of the teacher-forced decoder goes through
``dispatch.flash_attention`` (the cross-attention with Sq != Sk).
``decode_step`` writes the self-attention cache in place.  Under a
recorded forward, ``cfg.remat`` other than ``none`` checkpoints each
encoder and decoder layer whole: the JAX version checkpoints ``dots`` as
``full`` here too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import _stack, _stacked, recorded, remat, take, unstack
from repro_torch.sharding.policies import P


def _sinusoid(length: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / dim))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_params(cfg: ArchConfig, gen):
    return A.attn_params(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.pdtype)


def _enc_layer(cfg: ArchConfig, gen):
    dev = gen.device
    return {"norm1": L.layernorm_params(cfg.d_model, dev),
            "attn": _attn_params(cfg, gen),
            "norm2": L.layernorm_params(cfg.d_model, dev),
            "ffn": L.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, gated=False)}


def _dec_layer(cfg: ArchConfig, gen):
    dev = gen.device
    return {"norm1": L.layernorm_params(cfg.d_model, dev),
            "self_attn": _attn_params(cfg, gen),
            "norm_x": L.layernorm_params(cfg.d_model, dev),
            "cross_attn": _attn_params(cfg, gen),
            "norm2": L.layernorm_params(cfg.d_model, dev),
            "ffn": L.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, gated=False)}


def init_params(cfg: ArchConfig, gen: torch.Generator):
    """Random weights on the generator's device, from its state."""
    dev = gen.device
    return {
        "embed": L.embed_params(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype),
        "pos_dec": L.truncnorm(gen, (cfg.max_positions, cfg.d_model), 0.01, cfg.pdtype),
        "encoder": _stack([_enc_layer(cfg, gen) for _ in range(cfg.encoder_layers)]),
        "enc_norm": L.layernorm_params(cfg.d_model, dev),
        "decoder": _stack([_dec_layer(cfg, gen) for _ in range(cfg.num_layers)]),
        "dec_norm": L.layernorm_params(cfg.d_model, dev),
    }


def params_pspec(cfg: ArchConfig):
    """The spec tree of ``init_params``."""
    del cfg
    enc = {"norm1": L.layernorm_pspec(), "attn": A.attn_pspec(),
           "norm2": L.layernorm_pspec(), "ffn": L.mlp_pspec(gated=False)}
    dec = {"norm1": L.layernorm_pspec(), "self_attn": A.attn_pspec(),
           "norm_x": L.layernorm_pspec(), "cross_attn": A.attn_pspec(),
           "norm2": L.layernorm_pspec(), "ffn": L.mlp_pspec(gated=False)}
    return {"embed": L.embed_pspec(), "pos_dec": P(None, "data"),
            "encoder": _stacked(enc), "enc_norm": L.layernorm_pspec(),
            "decoder": _stacked(dec), "dec_norm": L.layernorm_pspec()}


def params_contracting(cfg: ArchConfig):
    """The contracting dims of ``init_params``'s weight leaves (layers.py),
    the stacks' in one layer's layout."""
    del cfg
    ffn = L.mlp_contracting(gated=False)
    return {"embed": L.embed_contracting(),
            "encoder": {"attn": A.attn_contracting(), "ffn": ffn},
            "decoder": {"self_attn": A.attn_contracting(),
                        "cross_attn": A.attn_contracting(), "ffn": ffn}}


# the param subtrees a decode step does not read: the encoder ran at
# admission, and the cache holds the memory's cross-attention K/V
DECODE_UNREAD = (("encoder",), ("enc_norm",), ("decoder", "cross_attn", "wk"),
                 ("decoder", "cross_attn", "wv"))


def _attend(cfg: ArchConfig, pp, x, causal: bool, kv_override=None):
    return A.attention(pp, x, num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                       head_dim=cfg.head_dim, causal=causal, rope=False,
                       compute_dtype=cfg.cdtype, kv_override=kv_override)


def _layer_remat(cfg: ArchConfig) -> str:
    return "none" if cfg.remat == "none" else "full"


def encode(cfg: ArchConfig, params, frames):
    """frames [B, F, D] (precomputed stub embeddings) -> memory [B, F, D]."""
    cd = cfg.cdtype
    f = frames.shape[1]
    x = frames.to(cd) + _sinusoid(f, cfg.d_model, frames.device).to(cd)[None]

    def layer(pp, x):
        h = L.layernorm(pp["norm1"], x, cfg.norm_eps)
        x = x + _attend(cfg, pp["attn"], h, causal=False)
        h = L.layernorm(pp["norm2"], x, cfg.norm_eps)
        return x + L.mlp(pp["ffn"], h, act="gelu", compute_dtype=cd)

    layer = remat(layer, _layer_remat(cfg), recorded(x, params["encoder"]))
    for pp in unstack(params["encoder"], cfg.encoder_layers):
        x = layer(pp, x)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


def decode_train(cfg: ArchConfig, params, tokens, memory):
    """Teacher-forced decoder: tokens [B, S], memory [B, F, D] ->
    logits [B, S, V]."""
    cd = cfg.cdtype
    s = tokens.shape[1]
    mem_pos = torch.arange(memory.shape[1], dtype=torch.int32, device=memory.device)
    x = L.embed_lookup(params["embed"], tokens, cd) + params["pos_dec"][:s].to(cd)[None]

    def layer(pp, x, memory):
        h = L.layernorm(pp["norm1"], x, cfg.norm_eps)
        x = x + _attend(cfg, pp["self_attn"], h, causal=True)
        h = L.layernorm(pp["norm_x"], x, cfg.norm_eps)
        x = x + _attend(cfg, pp["cross_attn"], h, causal=False,
                        kv_override=(memory, mem_pos))
        h = L.layernorm(pp["norm2"], x, cfg.norm_eps)
        return x + L.mlp(pp["ffn"], h, act="gelu", compute_dtype=cd)

    layer = remat(layer, _layer_remat(cfg), recorded(x, memory, params["decoder"]))
    for pp in unstack(params["decoder"], cfg.num_layers):
        x = layer(pp, x, memory)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cd, cfg.vocab)


class WhisperCache(NamedTuple):
    self_kv: A.KVCache     # leaves [layers, B, max_len, KV, dh]
    cross_k: torch.Tensor  # [layers, B, F, KV, dh], projected from the memory
    cross_v: torch.Tensor


def init_cache(cfg: ArchConfig, params, batch: int, max_len: int, memory=None,
               device=None) -> WhisperCache:
    """An empty self-attention cache and the cross-attention K/V projected
    once from ``memory`` [B, F, D] (zeros [B, encoder_len, D] when None, as
    in the JAX package).  Every leaf is [layers, B, ...], so slot i of a
    batch is a view on axis 1."""
    cd = cfg.cdtype
    device = device if device is not None else params["embed"]["emb"].device
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    self_kv = A.KVCache(k=torch.zeros(shape, dtype=cd, device=device),
                        v=torch.zeros(shape, dtype=cd, device=device))
    if memory is None:
        memory = torch.zeros((batch, cfg.encoder_len, cfg.d_model), dtype=cd, device=device)
    cross = params["decoder"]["cross_attn"]
    mem = memory.to(cd)
    ck = torch.einsum("bsd,ldhk->lbshk", mem, cross["wk"].to(cd))
    cv = torch.einsum("bsd,ldhk->lbshk", mem, cross["wv"].to(cd))
    return WhisperCache(self_kv=self_kv, cross_k=ck, cross_v=cv)


def cache_pspec(cfg: ArchConfig):
    """The spec tree of ``init_cache``."""
    del cfg
    cross = P(None, ("pod", "data"), None, "model", None)
    return WhisperCache(self_kv=_stacked(A.kv_cache_pspec()), cross_k=cross, cross_v=cross)


def decode_step(cfg: ArchConfig, params, tokens, cache: WhisperCache, cache_len):
    """One decoder token: tokens [B, 1] -> (logits [B, 1, V], cache).

    ``cache_len`` (int, 0-d or [B] tensor) tokens are in the self-attention
    cache; the new token's K/V are written there in place, and the
    cross-attention reads all of the memory's K/V."""
    cd = cfg.cdtype
    cl = torch.as_tensor(cache_len, dtype=torch.int64, device=tokens.device)
    pe = params["pos_dec"][cl.reshape(-1)].to(cd)
    pe = pe[:, None, :] if cl.dim() else pe[None]     # [B, 1, D] | [1, 1, D]
    x = L.embed_lookup(params["embed"], tokens, cd) + pe
    frames = cache.cross_k.shape[2]
    for i in range(cfg.num_layers):
        pp = take(params["decoder"], i)
        h = L.layernorm(pp["norm1"], x, cfg.norm_eps)
        y, _ = A.attention_decode(pp["self_attn"], h, take(cache.self_kv, i), cache_len,
                                  num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                                  head_dim=cfg.head_dim, rope=False, compute_dtype=cd)
        x = x + y
        h = L.layernorm(pp["norm_x"], x, cfg.norm_eps)
        y, _ = A.attention_decode(pp["cross_attn"], h,
                                  A.KVCache(k=cache.cross_k[i], v=cache.cross_v[i]),
                                  frames, num_heads=cfg.num_heads,
                                  num_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
                                  rope=False, compute_dtype=cd, update_cache=False)
        x = x + y
        h = L.layernorm(pp["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(pp["ffn"], h, act="gelu", compute_dtype=cd)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cd, cfg.vocab), cache
