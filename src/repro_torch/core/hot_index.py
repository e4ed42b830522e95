"""Hot-index lifecycle (paper §4.2.2, Algorithm 2).

A :class:`QueryCounter` tracks per-node access frequency; once the queries
since the last rebuild exceed ``n_query``, the top ``n_idx = IR·n`` nodes
are re-selected and a fresh NSSG is built over them.  Counting is host
numpy, as in the reference; the NSSG build runs on the caller's device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .ssg import SSGIndex, SSGParams, build_ssg

__all__ = ["QueryCounter", "HotIndex", "build_hot_index"]


@dataclasses.dataclass
class QueryCounter:
    """Alg 2 lines 1/4/10: per-node access counts + trigger bookkeeping."""

    n: int
    trigger: int                      # n_query
    decay: float = 1.0                # optional recency decay per rebuild

    def __post_init__(self):
        self.counts = np.zeros(self.n, np.float64)
        self.since_rebuild = 0

    def record(self, ids: np.ndarray) -> None:
        """Increment counts for each returned id; the trigger counts rows
        (queries), not ids."""
        ids = np.asarray(ids)
        n_queries = int(ids.shape[0]) if ids.ndim >= 1 else 1
        flat = ids.reshape(-1)
        flat = flat[(flat >= 0) & (flat < self.n)]
        np.add.at(self.counts, flat, 1.0)
        self.since_rebuild += n_queries

    @property
    def due(self) -> bool:
        return self.since_rebuild > self.trigger          # Alg 2 line 5

    def top(self, n_idx: int, alive: np.ndarray | None = None) -> np.ndarray:
        """Alg 2 lines 6-7: ids of the ``n_idx`` most-accessed nodes."""
        if alive is None:
            counts = self.counts
            n_idx = min(n_idx, self.n)
        else:
            counts = np.where(alive, self.counts, -np.inf)
            n_idx = min(n_idx, int(alive.sum()))
        part = np.argpartition(-counts, n_idx - 1)[:n_idx]
        return part[np.argsort(-counts[part], kind="stable")]

    def reset_trigger(self) -> None:                      # Alg 2 line 10
        self.since_rebuild = 0
        if self.decay != 1.0:
            self.counts *= self.decay

    # ------------------------------------------------- mutable-store support
    def grow(self, n_new: int) -> None:
        """Extend the id space after inserts (new rows start cold)."""
        if n_new < self.n:
            raise ValueError(f"grow to {n_new} < current {self.n}")
        self.counts = np.concatenate(
            [self.counts, np.zeros(n_new - self.n, np.float64)])
        self.n = n_new

    def remap(self, remap: np.ndarray) -> None:
        """Apply a compaction remap (old→new id, -1 dropped) to the counts.

        Preference mass on surviving rows is kept exactly, so the next
        rebuild sees the hot set it would have seen before compaction; the
        trigger clock keeps running (compaction is not a rebuild).
        """
        keep = remap >= 0
        new_counts = np.zeros(int(keep.sum()), np.float64)
        new_counts[remap[keep]] = self.counts[keep]
        self.counts = new_counts
        self.n = int(new_counts.shape[0])


@dataclasses.dataclass
class HotIndex:
    """Hot NSSG + the local→global id map."""

    graph: SSGIndex
    ids: np.ndarray            # (H,) global ids, hottest first
    build_seconds: float
    version: int = 0

    @property
    def size(self) -> int:
        return int(self.ids.shape[0])

    def nbytes(self) -> int:
        return int(self.graph.adj.nbytes + self.ids.nbytes)


def build_hot_index(x: np.ndarray, hot_ids: np.ndarray,
                    params: SSGParams, n_entry: int = 8, version: int = 0,
                    device="cpu") -> HotIndex:
    """Alg 2 line 8: NSSG over the selected hot nodes only."""
    hot_ids = np.asarray(hot_ids, np.int64)
    t0 = time.perf_counter()
    sub = np.ascontiguousarray(x[hot_ids], dtype=np.float32)
    k = min(params.knn_k, max(2, sub.shape[0] - 1))
    p = dataclasses.replace(params, knn_k=k,
                            out_degree=min(params.out_degree, k))
    graph = build_ssg(sub, p, n_entry=min(n_entry, sub.shape[0]),
                      device=device)
    return HotIndex(graph=graph, ids=hot_ids.astype(np.int32),
                    build_seconds=time.perf_counter() - t0, version=version)
