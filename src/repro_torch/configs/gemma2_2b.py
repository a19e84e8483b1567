"""gemma2-2b [dense]: 26L, d_model=2304, 8H GQA kv=4, d_ff=9216,
vocab=256000; local/global alternating attention + logit softcaps.
[arXiv:2408.00118]  A copy of the JAX package's config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000,
    block_pattern=("attn_local", "attn"), ffn_pattern=("dense", "dense"),
    window=4096, attn_softcap=50.0, logit_softcap=30.0,
    act="gelu_tanh", tie_embeddings=True, norm_eps=1e-6,
)

REDUCED = ArchConfig(
    name="gemma2-2b-reduced", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, window=8, attn_softcap=50.0, logit_softcap=30.0,
    act="gelu_tanh", compute_dtype="float32",
    block_pattern=("attn_local", "attn"), ffn_pattern=("dense", "dense"),
)
