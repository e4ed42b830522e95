"""Async atomic checkpointing of the port's training state."""

from .checkpointer import Checkpointer, latest_step  # noqa: F401
