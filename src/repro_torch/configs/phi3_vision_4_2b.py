"""phi-3-vision-4.2b [vlm]: phi3-mini backbone 32L, d_model=3072, 32H MHA
(kv=32), d_ff=8192, vocab=32064 + CLIP patch frontend STUB (the caller
hands the backbone precomputed patch embeddings; ``models.frontends``).
[hf:microsoft/Phi-3-vision]  A copy of the JAX package's config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
    num_patches=1024, patch_embed_dim=1024,
    block_pattern=("attn",), ffn_pattern=("dense",),
    tie_embeddings=True, norm_eps=1e-5,
)

REDUCED = ArchConfig(
    name="phi-3-vision-reduced", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, num_patches=8, patch_embed_dim=32,
    compute_dtype="float32",
    block_pattern=("attn",), ffn_pattern=("dense",),
)
