"""Decoder LM of the port for serving and training (see lm.py): every
block kind of the reference (dense, local, global, MoE over GQA or MLA;
hybrid attention + Mamba; cross-attention; xLSTM's mLSTM and sLSTM)."""

from .lm import DecoderLM, layer_runs, lm_loss  # noqa: F401
