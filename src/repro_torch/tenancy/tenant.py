"""Per-tenant preference state.

Everything the paper keeps *once* for its single workload — the query
counter (Alg 2 line 1), the hot index (Alg 2 line 8), the rebuild clock
(Alg 2 line 5) and the padded hot device tables the search reads — lives
here once *per tenant*.  The Full Index, the vector store and the decision
tree stay shared.

:mod:`repro_torch.core.dqf` imports this package, so imports from
``repro_torch.core`` happen inside methods.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.core.hot_index import HotIndex, QueryCounter
    from repro_torch.store import VectorStore

__all__ = ["DEFAULT_TENANT", "TenantState"]

# The implicit tenant of every call that names none: single-workload code
# and checkpoints keep working unchanged.
DEFAULT_TENANT = "default"


@dataclasses.dataclass
class TenantState:
    """One tenant's preference state (counter + hot index + device cache)."""

    name: str
    counter: "QueryCounter"
    hot: Optional["HotIndex"] = None
    slot: int = 0              # stable registry slot = tenant_idx in stacks
    gen: int = 0               # registry creation sequence — tells a
                               # re-created name from its evicted ancestor
    hot_token: int = 0         # bumps whenever ``hot`` is replaced/remapped
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)
    _dev_key: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def set_hot(self, hot: Optional["HotIndex"]) -> None:
        self.hot = hot
        self.hot_token += 1

    def remap_hot(self, remap: np.ndarray) -> bool:
        """Apply a compaction remap (old→new, -1 dropped) to the hot ids.

        Returns False when a hot row was dropped: the caller must rebuild
        this tenant's hot index (its graph references a vanished row).
        """
        if self.hot is None:
            return True
        new_ids = remap[self.hot.ids]
        if (new_ids < 0).any():
            return False
        self.hot = dataclasses.replace(self.hot,
                                       ids=new_ids.astype(np.int32))
        self.hot_token += 1
        return True

    def hot_tables(self, store: "VectorStore", device) -> dict:
        """This tenant's padded hot device tables (single-tenant form),
        cached on ``(hot_token, store.capacity, device)``."""
        if self.hot is None:
            raise RuntimeError(
                f"tenant {self.name!r} has no hot index — warm() or "
                "rebuild_hot() it first")
        key = (self.hot_token, store.capacity, str(device))
        if self._dev_key != key:
            from repro_torch.core import beam_search as bs
            ids = torch.as_tensor(self.hot.ids, dtype=torch.int32,
                                  device=device)
            self._dev = {
                "x_hot_pad": bs.pad_dataset(torch.as_tensor(
                    np.ascontiguousarray(store.x[self.hot.ids]),
                    device=device)),
                "adj_hot_pad": bs.pad_adjacency(torch.as_tensor(
                    np.asarray(self.hot.graph.adj, np.int32),
                    device=device)),
                "hot_ids_pad": torch.cat([ids, torch.tensor(
                    [store.capacity], dtype=torch.int32, device=device)]),
                "hot_entries": torch.as_tensor(
                    np.asarray(self.hot.graph.entries, np.int32),
                    device=device),
            }
            self._dev_key = key
        return self._dev
