"""Tiered storage: a disk-resident Full Index behind a device block cache.

A port of ``repro/tiering``.  Quantized codes (and the float32 rows the
exact rerank reads) spill to mmap-backed block files
(:mod:`~repro_torch.tiering.blockfile`, a numpy copy of the reference's);
a bounded device arena with clock eviction, pins and hit/miss/evict
counters (:mod:`~repro_torch.tiering.cache`) keeps the workload's skewed
head resident; and a cache-aware score table
(:mod:`~repro_torch.tiering.table`) plugs into the beam search's
``score_rows`` seam, reading misses through one batched host fetch per
gather and staying bit-identical to the all-resident configuration.

:class:`repro_torch.store.VectorStore` owns the tier
(``tier=TierConfig(...)``); the serving engines prefetch the predicted
beam frontier on a host thread while the tick runs.  A tiered search runs
the composed path: no kernel reads a tiered table.
"""

from .blockfile import BlockFile  # noqa: F401
from .cache import BlockCache  # noqa: F401
from .table import TieredTable  # noqa: F401
from .types import TierConfig  # noqa: F401

__all__ = ["BlockFile", "BlockCache", "TieredTable", "TierConfig"]
