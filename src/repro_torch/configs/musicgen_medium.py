"""MusicGen-medium — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf] 48L d_model=1536 24H (MHA) d_ff=6144 vocab=2048.
The EnCodec frontend is a stub: input_specs() feeds precomputed frame
embeddings (B, S, d_model); the backbone + small audio-token LM head are
what we model (per the assignment's [audio] note).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    embed_inputs=False,
    rope_theta=10_000.0,
    max_seq_len=4096,
    source="[arXiv:2306.05284; hf]",
)
