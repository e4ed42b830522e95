"""Optimizers and schedules of the port (plain torch, no torch.optim)."""

from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from . import schedule  # noqa: F401
