"""Llama-3.2-Vision-11B — text decoder with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 40L d_model=4096 32H
(kv=8) d_ff=14336 vocab=128256; every 5th layer cross-attends to vision
tokens. The ViT frontend is a stub: input_specs() provides projected patch
embeddings (B, 1601, d_model).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    cross_attn_every=5,
    vision_tokens=1601,
    rope_theta=500_000.0,
    max_seq_len=131_072,
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)
