"""deepseek-v2-lite-16b [moe]: 27L, d_model=2048, 16H MLA (kv_lora=512),
expert d_ff=1408, vocab=102400; 2 shared + 64 routed experts top-6.
Ditto skew-oblivious expert replication ON.
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]  A copy of the JAX
package's config: 2 shared + 64 routed, top-6, MLA kv_lora 512 / qk_nope
128 / qk_rope 64 / v_head 128 (160 routed experts belong to full V2)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16,
    num_kv_heads=16, head_dim=128,          # (unused by MLA; kept for report)
    d_ff=10944,                              # dense FFN of layer 0 (deepseek)
    vocab=102400,
    block_pattern=("mla",), ffn_pattern=("moe",),
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    num_experts=64, top_k=6, moe_d_ff=1408,
    num_shared_experts=2, shared_d_ff=2816,
    ditto_secondary=8, capacity_factor=1.25, moe_group_size=512,
    tie_embeddings=True, norm_eps=1e-6,
)

REDUCED = ArchConfig(
    name="deepseek-v2-lite-reduced", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    block_pattern=("mla",), ffn_pattern=("moe",),
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    num_experts=8, top_k=2, moe_d_ff=32, num_shared_experts=1,
    shared_d_ff=64, ditto_secondary=4, moe_group_size=64,
    compute_dtype="float32",
)
