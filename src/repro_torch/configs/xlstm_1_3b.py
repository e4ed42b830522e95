"""xLSTM-1.3B — mLSTM (matrix memory) + sLSTM blocks, 7:1 ratio.

[arXiv:2405.04517; unverified] 48L d_model=2048 4 heads, d_ff=0 (the
up/down projections live inside the xLSTM blocks), vocab=50304; every 8th
block is an sLSTM (scalar memory, true recurrence), the rest mLSTM
(chunked-parallel linear attention form).
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    xlstm_slstm_every=8,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    max_seq_len=524_288,
    source="[arXiv:2405.04517; unverified]",
)
