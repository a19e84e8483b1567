"""The model zoo: one API over the architectures the port runs.

``build(cfg, device=...)`` returns a ``Model`` whose members are plain
functions, as ``repro.models.zoo.Model`` has them, for every family: the
decoder-only ones (dense, MoE with attention and MLA mixers, SSM, hybrid,
and the VLM with its stub patch frontend) and the encoder-decoder whisper.
``params_pspec`` and ``cache_pspec`` give their sharding spec trees,
``params_contracting`` each weight's contracted dims and
``decode_unread`` the param subtrees a decode step does not read.

``build(cfg, device="meta")`` is the shape-only model of the dry run: its
``init_params(layers.ShapeOnly())`` and ``init_cache`` make ``meta``
tensors, what ``jax.eval_shape`` gives the JAX package, and allocate
nothing.  ``input_specs``, ``batch_pspec``, ``param_count``,
``active_param_count`` and ``model_flops`` are the JAX package's, on them.

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
import functools
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, shape_spec
from repro_torch.core.types import resolve_device
from repro_torch.models import frontends as F
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.sharding.policies import P
from repro_torch.tree import tree_leaves

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
    params_pspec: Callable[[], Any]
    cache_pspec: Callable[[], Any]
    params_contracting: Callable[[], Any]
    decode_unread: tuple = ()                         # param paths, as prefixes

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device, seeded (a ``ShapeOnly`` on
        ``meta``)."""
        if self.device == L.META:
            return L.ShapeOnly()
        return torch.Generator(device=self.device).manual_seed(seed)


def build(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` ("cuda" raises without a CUDA
    device; pass "cpu" to run the plain PyTorch path, "meta" for shapes
    only)."""
    device = L.META if str(device) == "meta" else resolve_device(device)

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
                 prefill_fn=prefill_fn, decode_fn=decode_fn, init_cache=init_cache,
                 params_pspec=lambda: T.params_pspec(cfg),
                 cache_pspec=lambda: T.cache_pspec(cfg),
                 params_contracting=lambda: T.params_contracting(cfg))


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
                 prefill_fn=prefill_fn, decode_fn=decode_fn, init_cache=init_cache,
                 params_pspec=lambda: W.params_pspec(cfg),
                 cache_pspec=lambda: W.cache_pspec(cfg),
                 params_contracting=lambda: W.params_contracting(cfg),
                 decode_unread=W.DECODE_UNREAD)


# -------------------------------------------------------------- input specs

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=L.META)


def input_specs(cfg: ArchConfig, shape, model: Optional[Model] = None) -> Dict[str, Any]:
    """Meta stand-ins for every model input of one (arch x shape) cell: no
    allocation.  ``shape`` names a cell of SHAPES or is such a dict.

    For decode kinds the returned dict holds the cache tree that
    ``init_cache`` makes on ``meta`` (whisper's from shape-only params)."""
    spec = shape_spec(shape)
    seq, gb, kind = spec["seq_len"], spec["global_batch"], spec["kind"]
    i32 = torch.int32

    if kind in ("train", "prefill"):
        if cfg.family == "encdec":
            batch = {"frames": _meta(F.audio_frames_shape(cfg, gb), cfg.cdtype),
                     "tokens": _meta((gb, seq), i32)}
            if kind == "train":
                batch["labels"] = _meta((gb, seq), i32)
            return batch
        st = seq - cfg.num_patches if cfg.num_patches else seq
        batch = {"tokens": _meta((gb, st), i32)}
        if cfg.num_patches:
            batch["patches"] = _meta(F.vision_patches_shape(cfg, gb), cfg.cdtype)
        if kind == "train":
            batch["labels"] = _meta((gb, st), i32)
        return batch

    # decode: one new token against a seq-length cache
    if model is None or model.device != L.META:
        model = build(cfg, "meta")
    params = model.init_params(L.ShapeOnly()) if cfg.family == "encdec" else None
    return {"tokens": _meta((gb, 1), i32), "cache": model.init_cache(params, gb, seq),
            "cache_len": _meta((), i32)}


def batch_pspec(cfg: ArchConfig, shape, model: Optional[Model] = None):
    """The spec tree matching input_specs: batch over ('pod','data'), the
    cache per the model's cache_pspec, scalars replicated."""
    kind = shape_spec(shape)["kind"]
    out: Dict[str, Any] = {}
    if kind in ("train", "prefill"):
        if cfg.family == "encdec":
            out["frames"] = P(("pod", "data"), None, None)
        out["tokens"] = P(("pod", "data"), None)
        if cfg.num_patches:
            out["patches"] = P(("pod", "data"), None, None)
        if kind == "train":
            out["labels"] = P(("pod", "data"), None)
        return out
    model = model or build(cfg, "meta")
    return {"tokens": P(("pod", "data"), None), "cache": model.cache_pspec(),
            "cache_len": P()}


# ----------------------------------------------------------- param counting

@functools.lru_cache(maxsize=None)
def param_count(cfg: ArchConfig) -> int:
    """Exact parameter count from the shape-only params (no allocation;
    remembered a config)."""
    params = build(cfg, "meta").init_params(L.ShapeOnly())
    return sum(math.prod(t.shape) for t in tree_leaves(params))


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token: MoE routed experts count top_k/num_experts
    of their weights (the 6*N_active*D convention)."""
    total = param_count(cfg)
    if cfg.num_experts and cfg.top_k:
        moe_layers = sum(1 for f in cfg.ffn_pattern if f == "moe") * cfg.num_periods
        routed = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts * moe_layers
        inactive = routed * (1.0 - cfg.top_k / cfg.num_experts)
        return int(total - inactive)
    return total


def model_flops(cfg: ArchConfig, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), the 'useful
    compute' of a cell.  D = tokens the cell processes: B*S for train and
    prefill (train counts fwd+bwd via the 6x), B*1 for decode."""
    spec = shape_spec(shape)
    n = active_param_count(cfg)
    if spec["kind"] == "train":
        return 6.0 * n * spec["global_batch"] * spec["seq_len"]
    if spec["kind"] == "prefill":
        return 2.0 * n * spec["global_batch"] * spec["seq_len"]
    return 2.0 * n * spec["global_batch"]
