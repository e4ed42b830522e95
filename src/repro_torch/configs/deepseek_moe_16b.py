"""DeepSeekMoE-16B — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf] 28L d_model=2048 16H (MHA: kv=16) expert_ff=1408
vocab=102400; first layer dense (d_ff 10944, public config).
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    moe=MoEConfig(num_experts=64, experts_per_token=6, num_shared=2,
                  d_expert=1408),
    first_k_dense=1,
    dense_layer_ff=10_944,
    rope_theta=10_000.0,
    max_seq_len=4096,
    source="[arXiv:2401.06066; hf]",
)
