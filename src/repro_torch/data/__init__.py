"""Data pipelines of the port (deterministic, resumable, host-sharded)."""

from .pipeline import DataConfig, make_source  # noqa: F401
