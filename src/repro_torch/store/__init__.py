"""Row storage of the port: the single source of truth for rows.

:class:`VectorStore` owns the float32 row table, the optional quantized
code table, the liveness bitmap and the stable external id map, pads
them into device tables, and with a tier keeps rows and codes in block
files behind device block caches.  A port of ``repro.store``.
"""

from .store import CompactionResult, VectorStore  # noqa: F401

__all__ = ["VectorStore", "CompactionResult"]
