"""Qwen3-0.6B — dense GQA with per-head QK-RMSNorm, head_dim 128.

[hf:Qwen/Qwen3-8B; hf] 28L d_model=1024 16H (kv=8) d_ff=3072 vocab=151936.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
