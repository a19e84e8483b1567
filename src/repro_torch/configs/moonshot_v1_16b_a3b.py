"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [moe]: 48L, d_model=2048,
16H GQA kv=16, expert d_ff=1408, vocab=163840; 64 routed experts top-6
(+2 shared), 3B active.  Ditto expert replication ON.
[hf:moonshotai/Moonlight-16B-A3B]  A copy of the JAX package's config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=11264, vocab=163840,
    block_pattern=("attn",), ffn_pattern=("moe",),
    num_experts=64, top_k=6, moe_d_ff=1408,
    num_shared_experts=2, shared_d_ff=2816,
    ditto_secondary=8, capacity_factor=1.25, moe_group_size=512,
    tie_embeddings=True, norm_eps=1e-5, rope_theta=50000.0,
)

REDUCED = ArchConfig(
    name="moonshot-reduced", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    block_pattern=("attn",), ffn_pattern=("moe",),
    num_experts=8, top_k=2, moe_d_ff=32, num_shared_experts=1,
    shared_d_ff=64, ditto_secondary=4, moe_group_size=64,
    compute_dtype="float32",
)
