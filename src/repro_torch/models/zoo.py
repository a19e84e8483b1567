"""The model zoo: one API over the architectures the port runs.

``build(cfg, device=...)`` returns a ``Model`` whose members are plain
functions, as ``repro.models.zoo.Model`` has them, for every family: the
decoder-only ones (dense, MoE with attention and MLA mixers, SSM, hybrid,
and the VLM with its stub patch frontend) and the encoder-decoder whisper.
The sharding specs come with the dry-run slice (ROADMAP.md §1).

Batch layouts (dicts of tensors on the model's device):
  train   {"tokens" [B, S] int, "labels" [B, S] int, ("patches"|"frames")}
  prefill the same without "labels"
  decode  {"tokens" [B, 1] int, "cache" tree, "cache_len" int | () | [B]}

The VLM's prefill logits keep the patch positions ([B, P + S, V]), as the
JAX package's ``prefill_fn`` does, and its loss drops them; the VLM serves
text only.  Whisper's frames are [B, encoder_len, d_model].
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W

LB_LOSS_WEIGHT = 0.01  # MoE load-balance auxiliary weight


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable[[torch.Generator], Any]     # weights from a generator
    loss_fn: Callable[[Any, Dict[str, Any]], Any]     # -> (loss, metrics)
    prefill_fn: Callable[[Any, Dict[str, Any]], Any]  # -> logits
    decode_fn: Callable[[Any, Dict[str, Any]], Any]   # -> (logits, cache)
    init_cache: Callable[..., Any]                    # (params, batch, max_len)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(seed)


def build(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` ("cuda" raises without a CUDA
    device; pass "cpu" to run the plain PyTorch path)."""
    device = resolve_device(device)

    def check(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")

    if cfg.family == "encdec":
        return _build_whisper(cfg, device, check)
    return _build_decoder_only(cfg, device, check)


def _build_decoder_only(cfg: ArchConfig, device, check) -> Model:
    def init_params(gen: torch.Generator):
        check(gen)
        return T.init_params(cfg, gen)

    def loss_fn(params, batch):
        logits, aux = T.forward(cfg, params, batch["tokens"],
                                patches=batch.get("patches"))
        if cfg.num_patches:
            logits = logits[:, cfg.num_patches:, :]
        xent = L.softmax_xent(logits, batch["labels"], cfg.vocab)
        loss = xent + LB_LOSS_WEIGHT * aux["lb_loss"]
        return loss, {"xent": xent, "lb_loss": aux["lb_loss"]}

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

    return Model(cfg=cfg, device=device, init_params=init_params, loss_fn=loss_fn,
                 prefill_fn=prefill_fn, decode_fn=decode_fn, init_cache=init_cache)


def _build_whisper(cfg: ArchConfig, device, check) -> Model:
    def init_params(gen: torch.Generator):
        check(gen)
        return W.init_params(cfg, gen)

    def prefill_fn(params, batch):
        memory = W.encode(cfg, params, batch["frames"])
        return W.decode_train(cfg, params, batch["tokens"], memory)

    def loss_fn(params, batch):
        xent = L.softmax_xent(prefill_fn(params, batch), batch["labels"], cfg.vocab)
        return xent, {"xent": xent,
                      "lb_loss": torch.zeros((), dtype=torch.float32, device=xent.device)}

    def decode_fn(params, batch):
        return W.decode_step(cfg, params, batch["tokens"], batch["cache"],
                             batch["cache_len"])

    def init_cache(params, batch, max_len, memory=None):
        return W.init_cache(cfg, params, batch, max_len, memory=memory, device=device)

    return Model(cfg=cfg, device=device, init_params=init_params, loss_fn=loss_fn,
                 prefill_fn=prefill_fn, decode_fn=decode_fn, init_cache=init_cache)
