"""Tier configuration (see :mod:`repro_torch.tiering`); a copy of
``repro/tiering/types.py``.

``TierConfig`` lives here (not in :mod:`repro_torch.core.types`) for the
same layering reason ``QuantState`` lives in :mod:`repro_torch.quant`: the
store sits below :mod:`repro_torch.core` and must be able to read the
config without an import cycle.  :class:`repro_torch.core.types.DQFConfig`
re-exposes it as its ``tier`` field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["TierConfig"]


def _is_pow2(v: int) -> bool:
    return v >= 1 and (v & (v - 1)) == 0


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Disk-resident Full Index configuration.

    ``mode="none"`` keeps the seed behaviour: every code (and float32 row)
    table lives in device memory.  With ``"host"`` the quantized codes and
    the float32 rows spill to mmap-backed block files; only a bounded
    device block cache (plus the Hot Index, codebooks and graph adjacency)
    stays resident, and cold-path gathers fault through a host fetch.
    """

    mode: str = "none"          # "none" | "host"
    dir: Optional[str] = None   # spill directory (None → per-store tempdir)
    block_rows: int = 64        # rows per block (power of two)
    cache_blocks: int = 0       # device arena slots; 0 → derive from frac
    cache_frac: float = 0.25    # arena size as a fraction of total blocks
    prefetch: bool = True       # async beam-frontier prefetch worker
    # Halve the caches' row-touch tallies every N maintain() passes so
    # ``relayout_tier`` clusters around recent traffic, not all-time
    # counts (0 = never decay, the pre-decay behaviour).
    tally_decay_every: int = 64
    # Host-fetch fault handling: a failed mmap read is retried up to
    # ``fetch_retries`` times with jittered exponential backoff starting
    # at ``fetch_backoff_s``; exhausted retries fall back to sentinel
    # rows and mark the affected queries degraded instead of killing the
    # jitted tick (0 retries = fail to sentinel on the first error).
    fetch_retries: int = 3
    fetch_backoff_s: float = 0.002

    def __post_init__(self):
        if self.mode not in ("none", "host"):
            raise ValueError(f"tier mode must be none|host, got {self.mode}")
        if not _is_pow2(self.block_rows):
            raise ValueError(
                f"block_rows must be a power of two, got {self.block_rows}")
        if self.cache_blocks < 0:
            raise ValueError("cache_blocks must be >= 0")
        if not (0.0 < self.cache_frac <= 1.0):
            raise ValueError("cache_frac must be in (0, 1]")
        if self.tally_decay_every < 0:
            raise ValueError("tally_decay_every must be >= 0")
        if self.fetch_retries < 0:
            raise ValueError("fetch_retries must be >= 0")
        if self.fetch_backoff_s < 0:
            raise ValueError("fetch_backoff_s must be >= 0")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"
