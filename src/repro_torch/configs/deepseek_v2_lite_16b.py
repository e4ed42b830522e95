"""DeepSeek-V2-Lite (16B) — MLA (kv_lora=512) + fine-grained MoE.

[arXiv:2405.04434; hf] 27L d_model=2048 16H expert_ff=1408 vocab=102400.
Config note (also in DESIGN.md §4): the assignment header says "64e top-6"
while its descriptor says "160 routed"; the public V2-Lite checkpoint has
64 routed + 2 shared (160 belongs to full V2), so we follow the header.
"""

from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, experts_per_token=6, num_shared=2,
                  d_expert=1408),
    first_k_dense=1,
    dense_layer_ff=10_944,
    rope_theta=10_000.0,
    max_seq_len=163_840,
    source="[arXiv:2405.04434; hf]",
)
