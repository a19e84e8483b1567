"""Modality frontend STUBS, as in ``repro/models/frontends.py``.

The audio and VLM configs specify the transformer BACKBONE only; the
modality frontend (whisper's two conv layers, phi-3-vision's CLIP tower) is
stubbed: the caller hands the backbone *precomputed* frame or patch
embeddings.  These helpers hold the stub shapes, and random generators for
smoke runs, from a ``torch.Generator`` on the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig


def audio_frames_shape(cfg: ArchConfig, batch: int):
    """Whisper conv-frontend output: [B, frames, d_model]."""
    return (batch, cfg.encoder_len, cfg.d_model)


def vision_patches_shape(cfg: ArchConfig, batch: int):
    """CLIP patch-embedding output: [B, patches, patch_embed_dim]."""
    return (batch, cfg.num_patches, cfg.patch_embed_dim)


def _normal(shape, gen: torch.Generator, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)


def random_frames(cfg: ArchConfig, gen: torch.Generator, batch: int):
    return _normal(audio_frames_shape(cfg, batch), gen, cfg.cdtype)


def random_patches(cfg: ArchConfig, gen: torch.Generator, batch: int):
    return _normal(vision_patches_shape(cfg, batch), gen, cfg.cdtype)
