"""Yi-34B — llama-architecture dense transformer with GQA.

[arXiv:2403.04652; hf] 60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    max_seq_len=4096,
    source="[arXiv:2403.04652; hf]",
)
