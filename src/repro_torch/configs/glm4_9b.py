"""GLM-4-9B — dense, aggressive GQA (kv=2), RoPE.

[hf:THUDM/glm-4-9b; hf] 40L d_model=4096 32H (kv=2) d_ff=13696 vocab=151552.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=151_552,
    rope_theta=10_000.0,
    max_seq_len=131_072,
    source="[hf:THUDM/glm-4-9b; hf]",
)
