"""jamba-1.5-large-398b [hybrid]: 72L, d_model=8192, 64H GQA kv=8,
d_ff=24576, vocab=65536; Mamba+attention 1:7 interleave (one attention
layer per 8-layer period, position 4, as in Jamba), MoE 16e top-2 on every
other layer.  Ditto skew-oblivious expert replication ON.
[arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large]  A copy of the JAX
package's config.

Parameter accounting (~398B total, ~94B active):
  36 MoE layers x 16e x 3 x 8192 x 24576  = 348.4B
  36 dense-FFN layers x 3 x 8192 x 24576  =  21.7B
  63 mamba mixers  x ~0.41B               =  25.8B
   9 attention mixers x ~0.15B            =   1.4B
  embed 65536 x 8192 (tied)               =   0.5B
"""
from repro_torch.configs.base import ArchConfig

_BLOCKS = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
           "mamba")
_FFNS = ("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe")

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    block_pattern=_BLOCKS, ffn_pattern=_FFNS,
    num_experts=16, top_k=2, moe_d_ff=24576,
    ditto_secondary=4, capacity_factor=1.25, moe_group_size=512,
    d_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True, norm_eps=1e-6,
    supports_long_context=True,
    optimizer="adamw8bit",
)

REDUCED = ArchConfig(
    name="jamba-1.5-large-reduced", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    block_pattern=_BLOCKS, ffn_pattern=_FFNS,
    num_experts=4, top_k=2, moe_d_ff=32,
    ditto_secondary=2, moe_group_size=64,
    d_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
    compute_dtype="float32",
    supports_long_context=True,
    optimizer="adamw8bit",
)
