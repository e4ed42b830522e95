"""DQF — the Dual-Index Query Framework (paper §4), end to end, in PyTorch.

Host-side orchestrator of the full NSSG, the query counter and hot index
of the default tenant, the decision tree, the optional quantized Full
Index and the search.  This port covers a resident index (float32 rows,
plus int8 or PQ codes when ``cfg.quant`` asks for them); mutation,
tenancy and tiering come with their own slices.

Typical flow::

    dqf = DQF(DQFConfig(index_ratio=0.005))     # device "cuda" by default
    dqf.build(x)                          # full NSSG, built on the device
    dqf.warm(workload.sample(50_000))     # seed counters, build hot index
    dqf.fit_tree(history_queries)         # train the termination tree
    res = dqf.search(queries)             # Algorithm 4

Device tables are padded to ``capacity`` rows (sentinel id = capacity),
as ``repro.store.VectorStore`` pads them, and ``live_pad`` is passed to
every search as the reference passes it.  With quantization the code
table is zero-padded the same way and kept beside ``x_pad``; the full
phase scans it, ``fit_tree`` traces on it, and the pool's head is
re-scored exactly from ``x_pad`` (``quant.rerank_k``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.quant import QuantState, build_quantizer

from . import beam_search as bs
from .decision_tree import DecisionTree, train_tree
from .dynamic_search import dynamic_search
from .hot_index import HotIndex, QueryCounter, build_hot_index
from .ssg import SSGIndex, SSGParams, build_ssg
from .tree_training import collect_training_data
from .types import PAD_VALUE, DQFConfig, SearchResult

__all__ = ["DQF", "resolve_device"]


@dataclasses.dataclass
class _Timings:
    full_build: float = 0.0
    hot_build: float = 0.0
    tree_fit: float = 0.0
    quant_train: float = 0.0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DQF runs on a CUDA device by default and none is present; "
                "pass device='cpu' to run the plain versions on the CPU")
        device = "cuda"
    return torch.device(device)


def _to_free_slots(adj: np.ndarray, n: int) -> np.ndarray:
    """Normalize an adjacency to the free-slot convention (-1)."""
    return np.where((adj < 0) | (adj >= n), -1, adj).astype(np.int32)


class DQF:
    """Dual-Index Query Framework over a resident index."""

    def __init__(self, cfg: DQFConfig | None = None, *, device=None):
        self.cfg = cfg or DQFConfig()
        self.device = resolve_device(device)
        self.x: Optional[np.ndarray] = None
        self.quant: Optional[QuantState] = None
        self.alive: Optional[np.ndarray] = None
        self.capacity = 0
        self.full: Optional[SSGIndex] = None
        self.counter: Optional[QueryCounter] = None
        self.hot: Optional[HotIndex] = None
        self.tree: Optional[DecisionTree] = None
        self.timings = _Timings()
        self._dev: dict = {}
        self._hot_dev: Optional[dict] = None

    # ------------------------------------------------------------------ build
    @property
    def _ssg_params(self) -> SSGParams:
        c = self.cfg
        return SSGParams(knn_k=c.knn_k, out_degree=c.out_degree,
                         alpha_deg=c.alpha_deg)

    def build(self, x: np.ndarray) -> "DQF":
        """Build the full index (Alg 2 line 2) and a fresh query counter."""
        x = np.ascontiguousarray(x, np.float32)
        if self.cfg.dim is not None and x.shape[1] != self.cfg.dim:
            raise ValueError(
                f"build() got d={x.shape[1]} vectors but the config expects "
                f"dim={self.cfg.dim}")
        quant = None
        if self.cfg.quant.enabled:
            t0 = time.perf_counter()
            quant = build_quantizer(x, self.cfg.quant)
            self.timings.quant_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        built = build_ssg(x, self._ssg_params, n_entry=self.cfg.n_entry,
                          device=self.device)
        self.timings.full_build = time.perf_counter() - t0
        self._install(x, np.ones(x.shape[0], bool), x.shape[0],
                      _to_free_slots(built.adj, built.n), built.entries,
                      quant)
        return self

    def _install(self, x, alive, capacity, adj, entries,
                 quant: Optional[QuantState] = None) -> None:
        """Install rows, liveness, a free-slot full graph and the quantizer;
        refresh the padded device tables and start a cold counter."""
        n = x.shape[0]
        self.x, self.alive, self.capacity = x, alive, int(capacity)
        self.full = SSGIndex(adj=adj, entries=np.asarray(entries, np.int32),
                             n=n)
        self.counter = QueryCounter(n, trigger=self.cfg.n_query_trigger)
        self.hot = None
        self._hot_dev = None
        cap, d, dev = self.capacity, x.shape[1], self.device
        filler = np.full((cap + 1 - n, d), PAD_VALUE, np.float32)
        live = np.concatenate([alive, np.zeros(cap + 1 - n, bool)])
        adj_dev = np.concatenate(
            [np.where(adj < 0, cap, adj),
             np.full((cap + 1 - n, adj.shape[1]), cap)]).astype(np.int32)
        self._dev = {
            "x_pad": torch.as_tensor(np.concatenate([x, filler]), device=dev),
            "adj_pad": torch.as_tensor(adj_dev, device=dev),
            "entries": torch.as_tensor(self.full.entries, device=dev),
            "live_pad": torch.as_tensor(live, device=dev),
        }
        self.quant = quant
        if quant is not None:
            self._dev["qtable"] = quant.device_table(cap, device=dev)

    @property
    def _quant_active(self) -> bool:
        return self.quant is not None and self.cfg.quant.enabled

    def _quant_table(self):
        """The padded code table the full phase scans, or None (float32)."""
        return self._dev["qtable"] if self._quant_active else None

    @property
    def _rerank_k(self) -> int:
        return self.cfg.quant.rerank_k if self._quant_active else 0

    # ------------------------------------------------------------- hot index
    @property
    def hot_size(self) -> int:
        live = int(self.alive.sum())
        return min(live, max(self.cfg.k + 1,
                             int(round(self.cfg.index_ratio * live))))

    def rebuild_hot(self, hot_ids: Optional[np.ndarray] = None) -> HotIndex:
        """Alg 2 lines 6-10 (``hot_ids`` overrides the head selection)."""
        self._require()
        if hot_ids is None:
            hot_ids = self.counter.top(self.hot_size, alive=self.alive)
        version = (self.hot.version + 1) if self.hot else 0
        self.set_hot(build_hot_index(self.x, hot_ids, self._ssg_params,
                                     n_entry=self.cfg.n_entry,
                                     version=version, device=self.device))
        self.timings.hot_build = self.hot.build_seconds
        self.counter.reset_trigger()
        return self.hot

    def set_hot(self, hot: HotIndex) -> None:
        self.hot = hot
        self._hot_dev = None

    def hot_tables(self) -> dict:
        """Padded hot device tables, cached until the hot index changes."""
        if self.hot is None:
            raise RuntimeError("hot index missing — call warm()/rebuild_hot()")
        if self._hot_dev is None:
            dev = self.device
            ids = torch.as_tensor(self.hot.ids, dtype=torch.int32, device=dev)
            self._hot_dev = {
                "x_hot_pad": bs.pad_dataset(torch.as_tensor(
                    self.x[self.hot.ids], device=dev)),
                "adj_hot_pad": bs.pad_adjacency(torch.as_tensor(
                    np.asarray(self.hot.graph.adj, np.int32), device=dev)),
                "hot_ids_pad": torch.cat([ids, torch.tensor(
                    [self.capacity], dtype=torch.int32, device=dev)]),
                "hot_entries": torch.as_tensor(
                    np.asarray(self.hot.graph.entries, np.int32), device=dev),
            }
        return self._hot_dev

    def warm(self, queries: np.ndarray,
             targets: Optional[np.ndarray] = None) -> HotIndex:
        """Seed the counter from a historical stream and build the hot
        index; unknown targets are resolved with a baseline search."""
        self._require()
        if targets is None:
            targets = self.search_baseline(queries).ids.cpu().numpy()
        self.counter.record(targets)
        return self.rebuild_hot()

    def record(self, ids: np.ndarray) -> None:
        """Feed result ids into the counter (Alg 2 line 4)."""
        self._require()
        self.counter.record(np.asarray(ids))

    def maybe_rebuild_hot(self) -> bool:
        """Rebuild the hot index iff the Alg-2 trigger is due."""
        self._require()
        if not self.counter.due:
            return False
        self.rebuild_hot()
        return True

    # ---------------------------------------------------------- decision tree
    def fit_tree(self, history_queries: np.ndarray, *,
                 max_depth: Optional[int] = None, dedup: bool = True,
                 min_leaf: int = 16) -> DecisionTree:
        """Paper §4.3.2: sample historical queries, dedup, trace, fit CART."""
        self._require(hot=True)
        q = self._queries(history_queries).cpu().numpy()
        if dedup:
            q = np.unique(q, axis=0)
        t0 = time.perf_counter()
        c = self.cfg
        hd = self.hot_tables()
        # Train on what the deployed search will scan: the quantized table
        # when quant is enabled, else the float32 vectors.
        table = self._quant_table()
        feats, labels = collect_training_data(
            self._dev["x_pad"] if table is None else table,
            self._dev["adj_pad"],
            hd["x_hot_pad"], hd["adj_hot_pad"], hd["hot_ids_pad"],
            hd["hot_entries"], q, k=c.k, hot_pool_size=c.hot_pool,
            full_pool_size=c.full_pool, eval_gap=c.eval_gap,
            max_hops=c.max_hops, hot_mode="graph",
            live_pad=self._dev["live_pad"])
        self.tree = train_tree(feats, labels,
                               max_depth=max_depth or c.tree_depth,
                               min_leaf=min_leaf, device=self.device)
        self.timings.tree_fit = time.perf_counter() - t0
        return self.tree

    # ----------------------------------------------------------------- search
    def _queries(self, queries) -> torch.Tensor:
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.x.shape[1]:
            raise ValueError(
                f"queries must be (B, {self.x.shape[1]}) for this index, "
                f"got {q.shape}")
        return torch.as_tensor(np.ascontiguousarray(q), device=self.device)

    def _dynamic(self, queries, tree) -> SearchResult:
        c = self.cfg
        hd = self.hot_tables()
        res, _, _ = dynamic_search(
            self._dev["x_pad"], self._dev["adj_pad"],
            hd["x_hot_pad"], hd["adj_hot_pad"], hd["hot_ids_pad"],
            hd["hot_entries"], tree, self._queries(queries),
            k=c.k, hot_pool_size=c.hot_pool, full_pool_size=c.full_pool,
            eval_gap=c.eval_gap, add_step=c.add_step,
            tree_depth=c.tree_depth, max_hops=c.max_hops,
            hot_mode=c.hot_mode, qtable=self._quant_table(),
            rerank_k=self._rerank_k, live_pad=self._dev["live_pad"],
            fused=c.fused, fused_hops=c.fused_hops)
        return res

    def search(self, queries: np.ndarray, *, record: bool = True,
               auto_rebuild: bool = True) -> SearchResult:
        """Dynamic dual-index search (Algorithm 4); results feed the counter
        and its rebuild clock."""
        self._require(hot=True)
        res = self._dynamic(
            queries, self.tree.arrays if self.tree is not None else None)
        if record:
            self.counter.record(res.ids.cpu().numpy())
            if auto_rebuild and self.counter.due:          # Alg 2 line 5
                self.rebuild_hot()
        return res

    def search_dual_beam(self, queries: np.ndarray) -> SearchResult:
        """Fig 3 ablation: dual index + traditional beam search (no tree)."""
        self._require(hot=True)
        return self._dynamic(queries, None)

    def search_baseline(self, queries: np.ndarray,
                        pool_size: Optional[int] = None) -> SearchResult:
        """Plain NSSG beam search over the full index (Algorithm 3)."""
        self._require()
        c = self.cfg
        return bs.beam_search(
            self._dev["x_pad"], self._dev["adj_pad"], self._dev["entries"],
            self._queries(queries), pool_size=pool_size or c.full_pool,
            k=c.k, max_hops=c.max_hops, live_pad=self._dev["live_pad"],
            fused=c.fused, fused_hops=c.fused_hops)

    def _require(self, hot: bool = False) -> None:
        if self.full is None:
            raise RuntimeError("call build() first")
        if hot and self.hot is None:
            raise RuntimeError("hot index missing — call warm()/rebuild_hot()")
