"""Gemma 3 4B — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified] 34L d_model=2560 8H (kv=4)
d_ff=10240 vocab=262144; sliding window 1024 on local layers, every 6th
layer global (theta 1M global / 10k local).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10_240,
    vocab_size=262_144,
    window_size=1024,
    global_layer_every=6,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    max_seq_len=131_072,
    tie_embeddings=True,
    source="[hf:google/gemma-3-1b-pt; unverified]",
)
