"""yi-6b [dense]: 32L, d_model=4096, 32H GQA kv=4, d_ff=11008, vocab=64000;
llama-architecture GQA.  [arXiv:2403.04652]  A copy of the JAX package's
config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=5000000.0,
    block_pattern=("attn",), ffn_pattern=("dense",),
    tie_embeddings=True, norm_eps=1e-5,
)

REDUCED = ArchConfig(
    name="yi-6b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, compute_dtype="float32",
    block_pattern=("attn",), ffn_pattern=("dense",),
)
