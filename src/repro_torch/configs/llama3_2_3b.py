"""llama3.2-3b [dense]: 28L, d_model=3072, 24H GQA kv=8, d_ff=8192,
vocab=128256.  [hf:meta-llama/Llama-3.2-3B]  A copy of the JAX package's
config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, rope_theta=500000.0,
    block_pattern=("attn",), ffn_pattern=("dense",),
    tie_embeddings=True, norm_eps=1e-5,
)

REDUCED = ArchConfig(
    name="llama3.2-3b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, compute_dtype="float32",
    block_pattern=("attn",), ffn_pattern=("dense",),
)
