"""The model zoo: one API over the architectures the port runs.

``build(cfg, device=...)`` returns a ``Model`` whose members are plain
functions, the inference half of ``repro.models.zoo.Model`` for the
decoder-only families: dense, MoE (attention and MLA mixers), SSM and
hybrid (Mamba-2 mixers), and the VLM with its stub patch frontend.
Training, the encoder-decoder family (whisper) and the sharding specs come
in later slices (ROADMAP.md §1).

Batch layouts (dicts of tensors on the model's device):
  prefill {"tokens" [B, S] int, ("patches" [B, P, patch_embed_dim])}
  decode  {"tokens" [B, 1] int, "cache" tree, "cache_len" int | () | [B]}

The VLM's prefill logits keep the patch positions ([B, P + S, V]), as the
JAX package's ``prefill_fn`` does; the VLM serves text only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as T


DECODER_ONLY = ("dense", "moe", "ssm", "hybrid", "vlm")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable[[torch.Generator], Any]     # weights from a generator
    prefill_fn: Callable[[Any, Dict[str, Any]], Any]  # -> logits
    decode_fn: Callable[[Any, Dict[str, Any]], Any]   # -> (logits, cache)
    init_cache: Callable[..., Any]                    # (params, batch, max_len)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(seed)


def build(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` ("cuda" raises without a CUDA
    device; pass "cpu" to run the plain PyTorch path)."""
    if cfg.family not in DECODER_ONLY:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP.md §1)")
    device = resolve_device(device)

    def init_params(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        return T.init_params(cfg, gen)

    def prefill_fn(params, batch):
        logits, _ = T.forward(cfg, params, batch["tokens"],
                              patches=batch.get("patches"))
        return logits

    def decode_fn(params, batch):
        return T.decode_step(cfg, params, batch["tokens"], batch["cache"],
                             batch["cache_len"])

    def init_cache(params, batch, max_len):
        del params
        return T.init_cache(cfg, batch, max_len, device)

    return Model(cfg=cfg, device=device, init_params=init_params,
                 prefill_fn=prefill_fn, decode_fn=decode_fn, init_cache=init_cache)
