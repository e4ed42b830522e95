"""DQF — the Dual-Index Query Framework (paper §4), end to end, in PyTorch.

Host-side orchestrator of the vector store, the full NSSG, the tenant
registry (per-tenant query counters and hot indexes), the decision tree,
the optional quantized Full Index, the search, the mutable lifecycle,
checkpoints, and the disk tier.

Typical flow::

    dqf = DQF(DQFConfig(index_ratio=0.005))     # device "cuda" by default
    dqf.build(x)                          # full NSSG, built on the device
    dqf.warm(workload.sample(50_000))     # seed counters, build hot index
    dqf.fit_tree(history_queries)         # train the termination tree
    res = dqf.search(queries)             # Algorithm 4

Mutable lifecycle and checkpoints::

    ext = dqf.insert(new_rows)            # append + local graph re-link
    dqf.delete(ext[:10])                  # tombstone + neighbor patch-through
    dqf.compact()                         # drop tombstones, remap, repair
    dqf.save(path)                        # the reference's .npz keys
    dqf = DQF.load(path, cfg)             # on the card unless device="cpu"

Graph maintenance under insert and delete is host numpy, as in the
reference; compaction's connectivity repair and every hot rebuild run on
the DQF's device.

Multi-tenant preference (:mod:`repro_torch.tenancy`): the counter, the hot
index and the Alg-2 rebuild clock live per tenant while the Full Index
stays shared.  ``warm``/``record``/``rebuild_hot``/``maybe_rebuild_hot``/
``fit_tree``/``search``/``search_dual_beam`` take ``tenant=``; omitting it
targets the default tenant (``dqf.counter``/``dqf.hot`` alias its state).

Rows, codes and liveness live in ``dqf.store``
(:class:`repro_torch.store.VectorStore`); ``x``, ``alive`` and
``capacity`` are views of it.  Device tables are padded to the store's
capacity (sentinel id = capacity) and refreshed when ``store.epoch``
moves; ``live_pad`` is passed to every search as the reference passes
it.  With quantization the code table is zero-padded the same way and
kept beside ``x_pad``; the full phase scans it, ``fit_tree`` traces on it,
and the pool's head is re-scored exactly from ``x_pad``
(``quant.rerank_k``).

Tiered storage (:mod:`repro_torch.tiering`): with
``DQFConfig(tier=TierConfig(mode="host"))`` the quantized codes and the
float32 rows spill to mmap-backed block files and the cold path scores
through bounded device block caches instead of fully resident tables —
the same results bit for bit (against the composed path), a fraction of
the device memory.  A tiered search takes the composed path (the fused
hop cannot read the host), snapshots the caches at entry, admits the
hottest missed blocks at the next entry, and returns after its last host
fetch (each fetch is a synchronous host read between launches, so the
caller may mutate the store the moment it returns); ``relayout_tier``
re-clusters blocks around the traffic seen, and ``save``/``load`` keep
the block files in a ``<path>.npz.tier/`` sidecar.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry
from repro_torch.quant import QuantState, build_quantizer
from repro_torch.store import VectorStore
from repro_torch.tenancy import DEFAULT_TENANT, TenantRegistry, TenantState

from . import beam_search as bs
from .decision_tree import DecisionTree, train_tree, tree_arrays
from .dynamic_search import dynamic_search
from .hot_index import HotIndex, QueryCounter, build_hot_index
from .ssg import (SSGIndex, SSGParams, build_ssg, compact_adjacency,
                  link_new_rows, medoid, patch_dead_edges,
                  repair_free_adjacency)
from .tree_training import collect_training_data
from .types import DQFConfig, SearchResult

__all__ = ["DQF", "resolve_device"]


@dataclasses.dataclass
class _Timings:
    full_build: float = 0.0
    hot_build: float = 0.0
    tree_fit: float = 0.0
    quant_train: float = 0.0
    # the last compact(), step by step: the store's left-pack, the
    # adjacency rewrite, the connectivity repair
    compact_store: float = 0.0
    compact_graph: float = 0.0
    compact_repair: float = 0.0


def resolve_device(device=None, what: str = "DQF") -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device by default and none is "
                "present; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _to_free_slots(adj: np.ndarray, n: int) -> np.ndarray:
    """Normalize an adjacency to the free-slot convention (-1)."""
    return np.where((adj < 0) | (adj >= n), -1, adj).astype(np.int32)


def _hot_index(arrays, prefix: str) -> HotIndex:
    """A saved hot index (``{prefix}hot_*`` keys)."""
    ids = np.asarray(arrays[f"{prefix}hot_ids"], np.int32)
    graph = SSGIndex(adj=np.asarray(arrays[f"{prefix}hot_adj"], np.int32),
                     entries=np.asarray(arrays[f"{prefix}hot_entries"],
                                        np.int32),
                     n=int(ids.shape[0]))
    return HotIndex(graph=graph, ids=ids, build_seconds=0.0,
                    version=int(arrays[f"{prefix}hot_version"]))


class DQF:
    """Dual-Index Query Framework over a mutable vector store."""

    def __init__(self, cfg: DQFConfig | None = None, *, device=None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg or DQFConfig()
        self.device = resolve_device(device)
        # Each DQF owns a registry (fresh by default, so instances and
        # tests never share series); the store, the tenants and any engine
        # over this instance publish into it — one scrape() covers all.
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._m_batches = self.registry.counter(
            "search_batches_total", "search() batch calls")
        self._m_queries = self.registry.counter(
            "search_queries_total", "queries across all search() batches")
        self.registry.register_callback("dqf", self._collect_metrics)
        self.store: Optional[VectorStore] = None
        self.full: Optional[SSGIndex] = None
        self.tree: Optional[DecisionTree] = None
        self.tenants: Optional[TenantRegistry] = None
        self.timings = _Timings()
        self._dev: dict = {}
        self._dev_epoch = -1
        self._dev_rows_epoch = -1
        self._adj_buf: Optional[np.ndarray] = None

    def _collect_metrics(self) -> dict:
        """Registry scrape-time collector (keyed ``"dqf"``)."""
        if self.store is None:
            return {}
        mem = self.memory_report()
        return {"index_device_bytes": float(mem["device"]["total"]),
                "index_host_bytes": float(mem["host"]["total"]),
                "index_disk_bytes": float(mem["disk"]["total"])}

    def scrape(self) -> dict:
        """One flat metrics dict across store, tenants and engines."""
        return self.registry.scrape()

    def exposition(self) -> str:
        """Prometheus text exposition of :meth:`scrape`."""
        return self.registry.exposition()

    def debug_bundle(self, out_dir: str, *, reason: str = "") -> str:
        """Write a diagnostic bundle for this DQF (the engines' bundle
        without an engine: scrape, exposition, config and memory report).
        Returns the bundle directory path."""
        from repro_torch.obs.bundle import debug_bundle as _bundle
        extra = ({"memory_report": self.memory_report()}
                 if self.store is not None else None)
        return _bundle(self, out_dir, reason=reason, extra=extra)

    # -------------------------------------------------------------- storage
    @property
    def x(self) -> Optional[np.ndarray]:
        """The store's row table (live + tombstoned rows), read-only."""
        return self.store.x if self.store is not None else None

    @property
    def alive(self) -> Optional[np.ndarray]:
        return self.store.alive if self.store is not None else None

    @property
    def capacity(self) -> int:
        return self.store.capacity if self.store is not None else 0

    @property
    def quant(self) -> Optional[QuantState]:
        return self.store.quant if self.store is not None else None

    # ------------------------------------------------------------- tenants
    @property
    def counter(self) -> Optional[QueryCounter]:
        """The default tenant's query counter (single-workload API)."""
        return self.tenants.default.counter if self.tenants else None

    @property
    def hot(self) -> Optional[HotIndex]:
        """The default tenant's hot index (single-workload API)."""
        return self.tenants.default.hot if self.tenants else None

    def _tenant(self, tenant, *, create: bool = False) -> TenantState:
        """Resolve a tenant name (or TenantState) to its state."""
        self._require()
        if isinstance(tenant, TenantState):
            return tenant
        if create and tenant not in self.tenants:
            return self.tenants.create(tenant)
        return self.tenants.get(tenant)

    def create_tenant(self, name: str) -> TenantState:
        """Register a new tenant (cold counter, no hot index yet)."""
        self._require()
        return self.tenants.create(name)

    def evict_tenant(self, name: str) -> None:
        """Drop a tenant's preference state; the Full Index is untouched."""
        self._require()
        self.tenants.evict(name)

    # ------------------------------------------------------------------ build
    @property
    def _ssg_params(self) -> SSGParams:
        c = self.cfg
        return SSGParams(knn_k=c.knn_k, out_degree=c.out_degree,
                         alpha_deg=c.alpha_deg)

    def build(self, x: np.ndarray,
              ext_ids: Optional[np.ndarray] = None) -> "DQF":
        """Build the full index (Alg 2 line 2) and a fresh tenant registry."""
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
        store = VectorStore(
            x, ext_ids=ext_ids, quant=quant,
            tier=self.cfg.tier if self.cfg.tier.enabled else None,
            registry=self.registry, device=self.device)
        t0 = time.perf_counter()
        built = build_ssg(store.x, self._ssg_params,
                          n_entry=self.cfg.n_entry, device=self.device)
        self.timings.full_build = time.perf_counter() - t0
        self._install(store, _to_free_slots(built.adj, built.n),
                      built.entries)
        return self

    def _install(self, store: VectorStore, adj: np.ndarray,
                 entries: np.ndarray) -> None:
        """Install a store and its free-slot full graph; start a fresh
        tenant registry and upload the padded device tables."""
        self.store = store
        self._set_full_adj(adj, np.asarray(entries, np.int32))
        self.tenants = TenantRegistry(store.n,
                                      trigger=self.cfg.n_query_trigger,
                                      device=self.device,
                                      registry=self.registry)
        self._dev = {}
        self._sync_device(force=True)

    def _set_full_adj(self, adj: np.ndarray, entries: np.ndarray) -> None:
        """Install a full-graph adjacency into the capacity-sized host
        buffer (so inserts extend it by slice instead of copying it)."""
        n = adj.shape[0]
        self._adj_buf = np.full((self.store.capacity, adj.shape[1]), -1,
                                np.int32)
        self._adj_buf[:n] = adj
        self.full = SSGIndex(adj=self._adj_buf[:n], entries=entries, n=n)

    # --------------------------------------------------------- device tables
    def _sync_device(self, force: bool = False) -> None:
        """Refresh the padded device tables when the store epoch moved: the
        row and code tables follow ``store.rows_epoch``, the graph and
        liveness tables ``store.epoch``.  Hot tables are per tenant
        (:meth:`TenantState.hot_tables`).  A tiered store uploads no row
        or code table: the per-call snapshots of :meth:`_row_table` and
        :meth:`_quant_table` take their place."""
        st, dev = self.store, self.device
        if force or self._dev_epoch != st.epoch:
            if force or self._dev_rows_epoch != st.rows_epoch:
                if st.tiered:
                    self._dev.pop("x_pad", None)
                    self._dev.pop("qtable", None)
                else:
                    self._dev["x_pad"] = st.padded_rows(dev)
                    if st.quant is not None and self.cfg.quant.enabled:
                        self._dev["qtable"] = st.padded_quant_table(dev)
                    else:
                        self._dev.pop("qtable", None)
                self._dev_rows_epoch = st.rows_epoch
            self._dev["adj_pad"] = st.pad_adjacency(self.full.adj, dev)
            self._dev["entries"] = torch.as_tensor(self.full.entries,
                                                   device=dev)
            self._dev["live_pad"] = st.padded_live(dev)
            self._dev_epoch = st.epoch

    def _row_table(self):
        """The exact float32 score table: resident ``x_pad`` or a tier
        snapshot."""
        st = self.store
        return st.tiered_rows_table() if st.tiered else self._dev["x_pad"]

    @property
    def _quant_active(self) -> bool:
        return self.quant is not None and self.cfg.quant.enabled

    def _quant_table(self):
        """The padded code table the full phase scans (or its tier
        snapshot), or None (float32)."""
        if not self._quant_active:
            return None
        st = self.store
        return st.tiered_codes_table() if st.tiered else self._dev["qtable"]

    @property
    def _fused(self) -> bool:
        """The fused hop, gated off for a tiered store: its host fetches
        cannot run inside the kernel, so a tiered search keeps the
        composed path and its select-after-score seam."""
        return self.cfg.fused and not (self.store is not None
                                       and self.store.tiered)

    @property
    def _rerank_k(self) -> int:
        return self.cfg.quant.rerank_k if self._quant_active else 0

    def _queries(self, queries) -> torch.Tensor:
        """The query batch as a contiguous float32 tensor on the device; a
        tensor already there (an LM's hidden states) is not copied."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32).contiguous()
        else:
            q = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                                device=self.device)
        if q.ndim != 2 or q.shape[1] != self.store.d:
            raise ValueError(
                f"queries must be (B, {self.store.d}) for this index, got "
                f"{tuple(q.shape)}")
        return q

    def _search_begin(self, queries) -> torch.Tensor:
        """Per-search-entry checks (one seam for all search paths): the
        query shape, the batch counters, fresh device tables, and the
        block caches' housekeeping (apply prefetches, admit the blocks
        the previous searches missed hardest)."""
        q = self._queries(queries)
        self._m_batches.inc()
        self._m_queries.inc(q.shape[0])
        self._sync_device()
        if self.store.tiered:
            self.store.tier_begin()
        return q

    # ------------------------------------------------------------- hot index
    @property
    def hot_size(self) -> int:
        live = self.store.live_count
        return min(live, max(self.cfg.k + 1,
                             int(round(self.cfg.index_ratio * live))))

    def rebuild_hot(self, hot_ids: Optional[np.ndarray] = None, *,
                    tenant=DEFAULT_TENANT) -> HotIndex:
        """Alg 2 lines 6-10 for one tenant (``hot_ids`` overrides the head
        selection).  Each tenant rebuilds on its own clock."""
        t = self._tenant(tenant)
        if hot_ids is None:
            hot_ids = t.counter.top(self.hot_size, alive=self.store.alive)
        version = (t.hot.version + 1) if t.hot else 0
        t.set_hot(build_hot_index(self.store.x, hot_ids, self._ssg_params,
                                  n_entry=self.cfg.n_entry, version=version,
                                  device=self.device))
        self.timings.hot_build = t.hot.build_seconds
        t.counter.reset_trigger()
        return t.hot

    def set_hot(self, hot: HotIndex, *, tenant=DEFAULT_TENANT) -> None:
        """Install a built hot index for one tenant."""
        self._tenant(tenant).set_hot(hot)

    def hot_tables(self, tenant=DEFAULT_TENANT) -> dict:
        """One tenant's padded hot device tables (cached until its hot
        index or the store capacity changes)."""
        t = self._tenant(tenant)
        self._require(t)
        return t.hot_tables(self.store, self.device)

    def warm(self, queries: np.ndarray, targets: Optional[np.ndarray] = None,
             *, tenant=DEFAULT_TENANT) -> HotIndex:
        """Seed a tenant's counter from a historical stream and build its
        hot index; an unknown tenant is created on the spot and unknown
        targets are resolved with a baseline search."""
        t = self._tenant(tenant, create=True)
        if targets is None:
            targets = self.search_baseline(queries).ids.cpu().numpy()
        t.counter.record(targets)
        return self.rebuild_hot(tenant=t)

    def record(self, ids: np.ndarray, *, tenant=DEFAULT_TENANT) -> None:
        """Feed result ids into a tenant's counter (Alg 2 line 4)."""
        self._tenant(tenant).counter.record(np.asarray(ids))

    def maybe_rebuild_hot(self, *, tenant=DEFAULT_TENANT) -> bool:
        """Rebuild a tenant's hot index iff its Alg-2 trigger is due."""
        t = self._tenant(tenant)
        if not t.counter.due:
            return False
        self.rebuild_hot(tenant=t)
        return True

    # ---------------------------------------------------------- decision tree
    def fit_tree(self, history_queries: np.ndarray, *,
                 max_depth: Optional[int] = None, dedup: bool = True,
                 min_leaf: int = 16, tenant=DEFAULT_TENANT) -> DecisionTree:
        """Paper §4.3.2: sample historical queries, dedup, trace, fit CART.

        The tree is shared by every tenant (its features are distribution
        shapes, not ids); ``tenant`` picks whose hot index the training
        traces run against.
        """
        t = self._tenant(tenant)
        self._require(t)
        q = self._search_begin(history_queries).cpu().numpy()
        if dedup:
            q = np.unique(q, axis=0)
        t0 = time.perf_counter()
        c = self.cfg
        hd = t.hot_tables(self.store, self.device)
        # Train on what the deployed search will scan: the quantized table
        # when quant is enabled, else the float32 vectors.
        table = self._quant_table()
        feats, labels = collect_training_data(
            self._row_table() if table is None else table,
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
    def _dynamic(self, t: TenantState, queries, tree) -> SearchResult:
        q = self._search_begin(queries)
        c = self.cfg
        hd = t.hot_tables(self.store, self.device)
        res, _, _ = dynamic_search(
            self._row_table(), self._dev["adj_pad"],
            hd["x_hot_pad"], hd["adj_hot_pad"], hd["hot_ids_pad"],
            hd["hot_entries"], tree, q,
            k=c.k, hot_pool_size=c.hot_pool, full_pool_size=c.full_pool,
            eval_gap=c.eval_gap, add_step=c.add_step,
            tree_depth=c.tree_depth, max_hops=c.max_hops,
            hot_mode=c.hot_mode, qtable=self._quant_table(),
            rerank_k=self._rerank_k, live_pad=self._dev["live_pad"],
            fused=self._fused, fused_hops=c.fused_hops)
        return res

    def search(self, queries: np.ndarray, *, record: bool = True,
               auto_rebuild: bool = True,
               tenant=DEFAULT_TENANT) -> SearchResult:
        """Dynamic dual-index search (Algorithm 4) through one tenant's hot
        index; results feed that tenant's counter and rebuild clock."""
        t = self._tenant(tenant)
        self._require(t)
        res = self._dynamic(
            t, queries, self.tree.arrays if self.tree is not None else None)
        if record:
            t.counter.record(res.ids.cpu().numpy())
            if auto_rebuild and t.counter.due:          # Alg 2 line 5
                self.rebuild_hot(tenant=t)
        return res

    def search_dual_beam(self, queries: np.ndarray, *,
                         tenant=DEFAULT_TENANT) -> SearchResult:
        """Fig 3 ablation: dual index + traditional beam search (no tree)."""
        t = self._tenant(tenant)
        self._require(t)
        return self._dynamic(t, queries, None)

    def search_baseline(self, queries: np.ndarray,
                        pool_size: Optional[int] = None) -> SearchResult:
        """Plain NSSG beam search over the full index (Algorithm 3)."""
        self._require()
        q = self._search_begin(queries)
        c = self.cfg
        return bs.beam_search(
            self._row_table(), self._dev["adj_pad"], self._dev["entries"], q,
            pool_size=pool_size or c.full_pool, k=c.k, max_hops=c.max_hops,
            live_pad=self._dev["live_pad"], fused=self._fused,
            fused_hops=c.fused_hops)

    # ------------------------------------------------------ mutable lifecycle
    def insert(self, rows: np.ndarray,
               ext_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Append rows; returns their stable external ids.

        Storage: rows (and quant codes, encoded with the existing codebooks)
        are appended to the store, whose capacity grows geometrically.
        Graph: each new node gets search-based neighbor candidates and an
        SSG-pruned out-edge set, and its chosen neighbors gain reverse edges
        (:func:`repro_torch.core.ssg.link_new_rows`, host numpy).  Device
        tables refresh at the next search.
        """
        self._require()
        rows = np.atleast_2d(np.ascontiguousarray(rows, np.float32))
        start = self.store.n
        new_ext = self.store.add(rows, ext_ids)
        n_new = self.store.n
        if self._adj_buf.shape[0] < self.store.capacity:   # buffers grew
            buf = np.full((self.store.capacity, self._adj_buf.shape[1]),
                          -1, np.int32)
            buf[:start] = self._adj_buf[:start]
            self._adj_buf = buf
        self._adj_buf[start:n_new] = -1
        adj = self._adj_buf[:n_new]
        link_new_rows(self.store.x, adj, np.arange(start, n_new),
                      self._ssg_params, self.full.entries,
                      alive=self.store.alive)
        self.full = SSGIndex(adj=adj, entries=self.full.entries, n=n_new)
        self.tenants.grow(n_new)        # every tenant's new rows start cold
        return new_ext

    def delete(self, ext_ids: np.ndarray) -> int:
        """Tombstone rows by external id; returns the number deleted.

        The rows stay gatherable (search masks them everywhere) and their
        in-neighbors inherit their live out-edges, so reachability through
        the tombstones survives.  Every tenant whose hot index held a
        deleted row gets its hot index rebuilt at once.  A delete that
        would leave fewer than two live rows is refused before any
        mutation (an index that empty needs a rebuild, not a delete).
        """
        self._require()
        requested = np.unique(np.asarray(ext_ids).reshape(-1))
        if self.store.live_count - requested.size < 2:
            raise ValueError(
                f"deleting {requested.size} of {self.store.live_count} live "
                "rows would leave an unsearchable index — rebuild instead")
        dead = self.store.mark_dead(ext_ids)
        patch_dead_edges(self.store.x, self.full.adj, dead, self.store.alive)
        self._refresh_entries()
        for name in self.tenants.hot_tenants_containing(dead):
            self.rebuild_hot(tenant=name)
        return int(dead.size)

    def _refresh_entries(self) -> None:
        """Keep the entry set on live nodes (re-draw tombstoned entries,
        seeded by the store epoch)."""
        ent = self.full.entries
        keep = ent[self.store.alive[ent]]
        if keep.size == ent.size:
            return
        live = self.store.live_ids()
        pool = np.setdiff1d(live, keep)
        rng = np.random.default_rng(int(self.store.epoch))
        need = min(ent.size - keep.size, pool.size)
        extra = rng.choice(pool, size=need, replace=False) if need else []
        self.full = SSGIndex(
            adj=self.full.adj,
            entries=np.unique(np.concatenate([keep, extra])).astype(np.int32),
            n=self.full.n)

    def compact(self) -> dict:
        """Rewrite storage without tombstones; external ids are kept.

        Internal ids shift (the store returns the remap); the graph, every
        tenant's hot ids and every tenant's counter are remapped and the
        graph's connectivity is re-verified.  In-flight search state (live
        serving lanes) is invalidated: drain the engines first.
        """
        self._require()
        t0 = time.perf_counter()
        res = self.store.compact()
        remap = res.remap
        t1 = time.perf_counter()
        adj = compact_adjacency(self.full.adj, remap)
        ent = remap[self.full.entries]
        ent = np.unique(ent[ent >= 0]).astype(np.int32)
        if ent.size == 0:
            ent = np.asarray([medoid(self.store.x)], np.int32)
        t2 = time.perf_counter()
        adj = repair_free_adjacency(self.store.x, adj, int(ent[0]),
                                    device=self.device)
        t3 = time.perf_counter()
        self.timings.compact_store = t1 - t0
        self.timings.compact_graph = t2 - t1
        self.timings.compact_repair = t3 - t2
        self._set_full_adj(adj, ent)
        for name in self.tenants.remap(remap):
            # unreachable when delete() rebuilt eagerly; explicit hot_ids
            # overrides can still hold a dropped row
            self.rebuild_hot(tenant=name)
        self._sync_device()
        return {"dropped": res.dropped, "n": self.store.n, "remap": remap}

    def to_external(self, internal_ids: np.ndarray) -> np.ndarray:
        """Map search-result internal ids to stable external ids; sentinel
        and padding ids (≥ store.n) map to -1."""
        ids = np.asarray(internal_ids)
        valid = (ids >= 0) & (ids < self.store.n)
        out = np.full(ids.shape, -1, np.int64)
        out[valid] = self.store.to_external(ids[valid])
        return out

    def relayout_tier(self) -> bool:
        """Re-cluster the disk tier's cache blocks around observed traffic.

        Call after a warmup stretch (or periodically): the full-phase
        cache re-groups rows into blocks by touch frequency, which turns
        the workload's row-level skew into block-level skew the bounded
        device cache can exploit.  False on a resident store or before
        any traffic.
        """
        self._require()
        return self.store.tier_relayout() if self.store.tiered else False

    # ------------------------------------------------------------------ misc
    def memory_report(self) -> dict:
        """Byte accounting split by residency, as the reference reports it:
        ``full``/``hot`` graph bytes, ``full_vec`` the float32 rows,
        ``quant`` codes + codebook, ``total`` the resident index, and the
        ``device``/``host``/``disk`` sub-dicts, each with its ``total``:
        ``device`` holds the padded graph and liveness, hot indexes,
        codebooks and either the resident row and code tables or the
        tier's cache arenas; ``host`` the non-tiered row and code buffers
        and the id and liveness metadata; ``disk`` the tier's files."""
        st = self.store
        hot_bytes = sum(t.hot.nbytes() for t in (self.tenants or [])
                        if t.hot is not None)
        out = {"full": int(self.full.adj.nbytes) if self.full else 0,
               "hot": int(hot_bytes),
               "full_vec": int(st.x.nbytes) if st is not None else 0,
               "quant": int(st.quant.nbytes()) if st and st.quant else 0}
        out["total"] = out["full"] + out["hot"] + out["quant"]
        out["compression"] = (out["full_vec"] / out["quant"]
                              if out["quant"] else 1.0)
        if st is None:
            out.update(device={"total": 0}, host={"total": 0},
                       disk={"total": 0})
            return out
        cap1 = st.capacity + 1
        R = self.full.adj.shape[1] if self.full is not None else 0
        codebook = (out["quant"] - int(st.quant.codes.nbytes)
                    if st.quant is not None else 0)
        code_row = (int(st.quant.codes.shape[1]
                        * st.quant.codes.dtype.itemsize)
                    if st.quant is not None else 0)
        dev = {"graph": cap1 * R * 4 + cap1,     # adj_pad int32 + live_pad
               "hot": int(hot_bytes), "codebooks": int(codebook)}
        if st.tiered:
            caches = {c.name: c for c in st.tier_caches()}
            dev["rows"] = caches["rows"].arena_nbytes()
            dev["codes"] = (caches["codes"].arena_nbytes()
                            if "codes" in caches else 0)
        else:
            dev["rows"] = cap1 * st.d * 4                     # x_pad
            dev["codes"] = cap1 * code_row if self._quant_active else 0
        dev["total"] = sum(dev.values())
        host = {"rows": 0 if st.tiered else int(st.x.nbytes),
                "codes": (0 if st.tiered or st.quant is None
                          else int(st.quant.codes.nbytes)),
                "meta": int(st.alive.nbytes + st.ext_ids.nbytes)}
        host["total"] = sum(host.values())
        disk = {"tier_files": st.tier_disk_nbytes() if st.tiered else 0}
        disk["total"] = disk["tier_files"]
        out.update(device=dev, host=host, disk=disk)
        return out

    def index_nbytes(self) -> dict:
        """Alias of :meth:`memory_report` (same dict)."""
        return self.memory_report()

    # ----------------------------------------------------------- checkpoints
    def to_arrays(self) -> dict:
        """Store, graph, tree and every tenant's preference state as numpy
        arrays under the reference checkpoint's keys (what :meth:`save`
        writes).  The default tenant keeps the keys ``counts``,
        ``counter_since`` and ``hot_*``; every other tenant is saved under
        ``tenant{i}_*``, listed by ``tenant_names``."""
        self._require()
        arrs = self.store.to_arrays()
        arrs.update(full_adj=self.full.adj,
                    full_entries=self.full.entries,
                    counts=self.counter.counts,
                    counter_since=np.int64(self.counter.since_rebuild),
                    metric=np.array(self.cfg.metric))
        if self.hot is not None:
            arrs.update(hot_adj=self.hot.graph.adj,
                        hot_entries=self.hot.graph.entries,
                        hot_ids=self.hot.ids,
                        hot_version=np.int64(self.hot.version))
        extra = [t for t in self.tenants if t.name != DEFAULT_TENANT]
        if extra:
            arrs["tenant_names"] = np.array([t.name for t in extra])
            for i, t in enumerate(extra):
                arrs[f"tenant{i}_counts"] = t.counter.counts
                arrs[f"tenant{i}_since"] = np.int64(t.counter.since_rebuild)
                if t.hot is not None:
                    arrs[f"tenant{i}_hot_adj"] = t.hot.graph.adj
                    arrs[f"tenant{i}_hot_entries"] = t.hot.graph.entries
                    arrs[f"tenant{i}_hot_ids"] = t.hot.ids
                    arrs[f"tenant{i}_hot_version"] = np.int64(t.hot.version)
        if self.tree is not None:
            t = self.tree.arrays
            arrs.update(tree_feature=t.feature.cpu().numpy(),
                        tree_threshold=t.threshold.cpu().numpy(),
                        tree_left=t.left.cpu().numpy(),
                        tree_right=t.right.cpu().numpy(),
                        tree_value=t.value.cpu().numpy(),
                        tree_depth=np.int64(self.tree.depth),
                        tree_importance=self.tree.feature_importance)
        return arrs

    def save(self, path: str) -> None:
        """Persist :meth:`to_arrays` to ``path`` (``.npz`` appended when
        missing), crash-safe: staged in a temp dir in the destination
        directory, fsynced, and published by one ``os.replace``, so a
        crash at any step leaves the old checkpoint or the new one whole.
        Written uncompressed (float32 rows barely compress, and zlib would
        take most of a million-row save); ``np.load`` reads either form,
        so the reference's ``DQF.load`` reads it too.

        A tiered store also flushes and copies its block files to
        ``<path>.npz.tier/``, moved into place before the npz commit (the
        npz arrays stay the canonical copy; ``load`` rematerializes the
        tier from them, so a stale sidecar is never load-bearing)."""
        arrs = self.to_arrays()
        final = str(path)
        if not final.endswith(".npz"):
            final += ".npz"
        dest_dir = os.path.dirname(os.path.abspath(final))
        tmp_dir = tempfile.mkdtemp(prefix=".dqf-save-", dir=dest_dir)
        try:
            tmp_npz = os.path.join(tmp_dir, "checkpoint.npz")
            with open(tmp_npz, "wb") as f:
                np.savez(f, **arrs)
                f.flush()
                os.fsync(f.fileno())
            if self.store.tiered:
                side = self._tier_sidecar(final)
                if (self.store.tier_dir is not None
                        and os.path.abspath(self.store.tier_dir)
                        == os.path.abspath(side)):
                    # the live tier already IS the sidecar (after a load):
                    # renaming it away would orphan the store's open block
                    # files, so flush in place
                    self.store.export_tier(side)
                else:
                    tmp_tier = os.path.join(tmp_dir, "tier")
                    self.store.export_tier(tmp_tier)
                    if os.path.isdir(side):     # park the old sidecar
                        os.rename(side,         # for tmp-dir cleanup
                                  os.path.join(tmp_dir, "tier.old"))
                    os.rename(tmp_tier, side)
            os.replace(tmp_npz, final)      # atomic commit
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)

    @staticmethod
    def _tier_sidecar(path) -> str:
        """Directory for tier files next to a checkpoint (``.npz`` is
        appended when missing, as ``save`` does)."""
        p = str(path)
        if not p.endswith(".npz"):
            p += ".npz"
        return p + ".tier"

    @classmethod
    def load(cls, path: str, cfg: DQFConfig | None = None, *,
             device=None) -> "DQF":
        """A DQF from a checkpoint of either package (:meth:`save` or the
        reference's ``DQF.save``), on the card unless ``device`` says
        otherwise; see :meth:`from_arrays` for what is refused.  A tiered
        ``cfg`` without a ``tier.dir`` keeps its block files in the
        checkpoint's sidecar, ``<path>.npz.tier/``."""
        with np.load(path) as z:
            return cls.from_arrays(z, cfg, device=device, source=str(path),
                                   tier_dir=cls._tier_sidecar(path))

    @classmethod
    def from_arrays(cls, arrays, cfg: DQFConfig | None = None, *,
                    device=None, source: str = "the arrays",
                    tier_dir: Optional[str] = None) -> "DQF":
        """A DQF over the state saved under the reference checkpoint keys
        (any mapping: ``np.load`` of a ``.npz``, or :meth:`to_arrays`).

        Refused, as the reference refuses them: a ``cfg.dim`` other than
        the rows' width, a ``metric`` other than ``cfg.metric``, and, when
        ``cfg.quant`` asks for a quantized index, saved codes that are
        absent, of another mode, or (pq) of another shape than
        ``(pq_m, min(2**pq_bits, n))``.  A float32 ``cfg`` drops saved
        codes.  Missing store keys default as the reference's do.

        With ``cfg.tier`` enabled the store spills to block files in
        ``cfg.tier.dir``, else in ``tier_dir`` (``load`` passes the
        checkpoint's sidecar), else in a fresh temp dir.
        """
        self = cls(cfg, device=device)
        c = self.cfg
        d_saved = int(arrays["x"].shape[1])
        if c.dim is not None and d_saved != c.dim:
            raise ValueError(
                f"checkpoint {source} holds d={d_saved} vectors but the "
                f"config expects dim={c.dim} — fix DQFConfig.dim (or drop "
                "it) or rebuild the index")
        metric_saved = str(arrays["metric"]) if "metric" in arrays else "l2"
        if metric_saved != c.metric:
            raise ValueError(
                f"checkpoint {source} was built for metric "
                f"{metric_saved!r} but the config expects {c.metric!r} — "
                "distances would be meaningless")
        tier = None
        if c.tier.enabled:
            tier = c.tier if c.tier.dir or tier_dir is None else \
                dataclasses.replace(c.tier, dir=tier_dir)
        store = VectorStore.from_arrays(arrays, tier=tier,
                                        registry=self.registry,
                                        device=self.device)
        n = store.n
        if not c.quant.enabled:
            # cfg decides the search; the checkpoint provides the artifacts
            store.drop_quant()
        elif store.quant is None:
            raise ValueError(
                f"cfg requests quant mode {c.quant.mode!r} but {source} "
                "holds no quantizer — rebuild with build()")
        elif store.quant.mode != c.quant.mode:
            raise ValueError(f"cfg quant mode {c.quant.mode!r} != saved "
                             f"{store.quant.mode!r}")
        elif store.quant.mode == "pq":
            m, kk = store.quant.pq.m, store.quant.pq.k
            want_k = min(2 ** c.quant.pq_bits, n)
            if (m, kk) != (c.quant.pq_m, want_k):
                raise ValueError(f"cfg PQ shape (m={c.quant.pq_m}, "
                                 f"k={want_k}) != saved (m={m}, k={kk})")
        self._install(store, _to_free_slots(np.asarray(arrays["full_adj"]),
                                            n),
                      np.asarray(arrays["full_entries"], np.int32))
        self.counter.counts = np.asarray(arrays["counts"], np.float64).copy()
        if "counter_since" in arrays:
            self.counter.since_rebuild = int(arrays["counter_since"])
        if "tenant_names" in arrays:
            for i, name in enumerate(str(s) for s in arrays["tenant_names"]):
                t = self.tenants.create(name)
                t.counter.counts = np.asarray(arrays[f"tenant{i}_counts"],
                                              np.float64).copy()
                t.counter.since_rebuild = int(arrays[f"tenant{i}_since"])
                if f"tenant{i}_hot_ids" in arrays:
                    t.set_hot(_hot_index(arrays, f"tenant{i}_"))
        if "tree_feature" in arrays:
            self.tree = DecisionTree(
                arrays=tree_arrays(arrays["tree_feature"],
                                   arrays["tree_threshold"],
                                   arrays["tree_left"], arrays["tree_right"],
                                   arrays["tree_value"], device=self.device),
                depth=int(arrays["tree_depth"]),
                feature_importance=np.asarray(arrays["tree_importance"]))
        if "hot_ids" in arrays:
            self.set_hot(_hot_index(arrays, ""))
        return self

    def _require(self, tenant: Optional[TenantState] = None) -> None:
        if self.full is None:
            raise RuntimeError("call build() first")
        if tenant is not None and tenant.hot is None:
            raise RuntimeError(
                f"hot index missing for tenant {tenant.name!r} — call "
                "warm()/rebuild_hot()")
