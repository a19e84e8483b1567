"""mamba2-780m [ssm]: 48L, d_model=1536, attention-free SSD blocks,
d_state=128, vocab=50280, d_ff=0 (pure mamba stack, no MLP).
Sub-quadratic: decode keeps an O(1) state a layer.  [arXiv:2405.21060]
A copy of the JAX package's config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, vocab=50280,
    block_pattern=("mamba",), ffn_pattern=("none",),
    d_ff=0,
    d_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True, norm_eps=1e-5,
    supports_long_context=True,
)

REDUCED = ArchConfig(
    name="mamba2-780m-reduced", family="ssm",
    num_layers=2, d_model=64, vocab=256,
    block_pattern=("mamba",), ffn_pattern=("none",),
    d_ff=0,
    d_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
    compute_dtype="float32",
    supports_long_context=True,
)
