"""Architecture configuration schema of the port's language models.

The fields of ``repro/configs/base.py::ArchConfig`` that the port's
families read (attention, MLA and Mamba-2 mixers; dense, MoE and no FFN;
the VLM's patch frontend; whisper's encoder and learned decoder positions;
the trainer's peak learning rate and optimizer), with torch dtypes behind
``cdtype`` and ``pdtype``.  ``moe_impl`` is gone: its three values compute one function
in the JAX package, and the port has one realization (the tensor's device
picks plain PyTorch or the CUDA kernels).  So are the attention chunk
sizes: the port's attention is one kernel.  ``remat`` is JAX's activation
checkpointing of a training forward (``none``, ``full``, ``dots``; ``full``
by default), which ``transformer.forward`` and whisper's ``encode`` and
``decode_train`` apply.  ``SHAPES`` holds the dry run's four cell shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
REMAT = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encdec|vlm
    num_layers: int
    d_model: int
    vocab: int
    # repeating period: layer i uses pattern[i % len(pattern)]
    block_pattern: Tuple[str, ...] = ("attn",)  # attn|attn_local|attn_nocausal|mla|mamba
    ffn_pattern: Tuple[str, ...] = ("dense",)   # dense|moe|none
    # attention geometry
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    rope_theta: float = 10000.0
    use_rope: bool = True
    window: int = 4096                # local-attention window (attn_local)
    attn_softcap: float = 0.0         # gemma2 attention-logit capping
    logit_softcap: float = 0.0        # gemma2 final-logit capping
    # MLA geometry (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE (+ Ditto expert replication)
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    ditto_secondary: int = 0          # X secondary expert slots (0 = off)
    moe_group_size: int = 512
    # SSM (mamba2)
    d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_len: int = 0              # e.g. 1500 audio frames
    max_positions: int = 65536        # learned-position table (whisper dec)
    # VLM stub frontend (phi-3-vision)
    num_patches: int = 0
    patch_embed_dim: int = 0
    # numerics
    norm_eps: float = 1e-5
    act: str = "silu"
    mlp_gated: bool = True
    vocab_pad_to: int = 0             # pad embedding rows to a multiple
    tie_embeddings: bool = True
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # training
    max_lr: float = 3e-4
    optimizer: str = "adamw"          # adamw|adamw8bit
    remat: str = "full"               # none|full|dots
    # which serve shapes make sense (sub-quadratic archs only for long ctx)
    supports_long_context: bool = False

    def __post_init__(self):
        if len(self.block_pattern) != len(self.ffn_pattern):
            raise ValueError("mixer and ffn patterns must have equal period")
        if self.num_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: layers {self.num_layers} not a "
                             f"multiple of the period {len(self.block_pattern)}")
        if self.remat not in REMAT:
            raise ValueError(f"{self.name}: remat {self.remat!r} not one of {REMAT}")

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad_to:
            return self.vocab
        m = self.vocab_pad_to
        return -(-self.vocab // m) * m

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def moe_capacity(self) -> int:
        """Tokens a slot takes per dispatch group under uniform load."""
        from repro_torch.models.moe import uniform_capacity
        return uniform_capacity(self.moe_group_size, self.top_k,
                                self.num_experts, self.capacity_factor)

    def has(self, kind: str) -> bool:
        """Whether ``kind`` is one of the block or FFN kinds of the stack."""
        return kind in self.block_pattern or kind in self.ffn_pattern


# The four input shapes of the LM-family cells, as in
# ``repro/configs/base.py``: one training, one prefill and two decode shapes.
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def shape_spec(shape) -> dict:
    """The cell shape ``shape`` names in SHAPES, or ``shape`` itself when it
    is already such a dict ({"kind", "seq_len", "global_batch"}): the dry
    run and the cost model also take shapes of their own, such as a
    measured step's."""
    return SHAPES[shape] if isinstance(shape, str) else shape
