"""Hymba-1.5B — hybrid blocks: attention + Mamba heads in parallel.

[arXiv:2411.13676; hf] 32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Attention is sliding-window (1024) in every block; the SSM
branch carries global context (the paper keeps 3 full-attention layers —
we window all of them and note the simplification in DESIGN.md).
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    window_size=1024,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    rope_theta=10_000.0,
    max_seq_len=8192,
    source="[arXiv:2411.13676; hf]",
)
