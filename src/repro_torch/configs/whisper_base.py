"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H (kv=8), d_ff=2048,
vocab=51865; enc-dec with a stubbed conv frontend (precomputed 1500-frame
embeddings).  [arXiv:2212.04356]  A copy of the JAX package's config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    num_layers=6, encoder_layers=6, encoder_len=1500,
    d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865,
    use_rope=False, act="gelu", tie_embeddings=True,
    block_pattern=("attn",), ffn_pattern=("dense",),
    norm_eps=1e-5,
)

REDUCED = ArchConfig(
    name="whisper-base-reduced", family="encdec",
    num_layers=2, encoder_layers=2, encoder_len=32,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, max_positions=128,
    use_rope=False, act="gelu", compute_dtype="float32",
    block_pattern=("attn",), ffn_pattern=("dense",),
)
