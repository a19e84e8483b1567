"""starcoder2-15b [dense]: 40L, d_model=6144, 48H GQA kv=4, d_ff=24576,
vocab=49152; GQA + RoPE, a non-gated GELU MLP.  [arXiv:2402.19173]  A copy
of the JAX package's config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152, rope_theta=100000.0,
    block_pattern=("attn",), ffn_pattern=("dense",),
    act="gelu", mlp_gated=False, tie_embeddings=True, norm_eps=1e-5,
)

REDUCED = ArchConfig(
    name="starcoder2-15b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab=256, act="gelu", mlp_gated=False, compute_dtype="float32",
    block_pattern=("attn",), ffn_pattern=("dense",),
)
