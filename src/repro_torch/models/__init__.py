"""Decoder LM of the port for serving (see lm.py): dense, local, global and
MoE blocks over GQA or MLA attention."""

from .lm import DecoderLM, layer_runs  # noqa: F401
