"""Decoder LM of the port for serving (see lm.py): dense, local and global
GQA blocks."""

from .lm import DecoderLM, layer_runs  # noqa: F401
