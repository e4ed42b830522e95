"""DQF — the Dual-Index Query Framework (paper §4), end to end, in PyTorch.

Host-side orchestrator of the vector store, the full NSSG, the tenant
registry (per-tenant query counters and hot indexes), the decision tree,
the optional quantized Full Index and the search.  This port covers a
resident index; mutation (insert, delete, compact) and tiering come with
their own slices.

Typical flow::

    dqf = DQF(DQFConfig(index_ratio=0.005))     # device "cuda" by default
    dqf.build(x)                          # full NSSG, built on the device
    dqf.warm(workload.sample(50_000))     # seed counters, build hot index
    dqf.fit_tree(history_queries)         # train the termination tree
    res = dqf.search(queries)             # Algorithm 4

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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry
from repro_torch.quant import QuantState, build_quantizer
from repro_torch.store import VectorStore
from repro_torch.tenancy import DEFAULT_TENANT, TenantRegistry, TenantState

from . import beam_search as bs
from .decision_tree import DecisionTree, train_tree
from .dynamic_search import dynamic_search
from .hot_index import HotIndex, QueryCounter, build_hot_index
from .ssg import SSGIndex, SSGParams, build_ssg
from .tree_training import collect_training_data
from .types import DQFConfig, SearchResult

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
    """Dual-Index Query Framework over a resident vector store."""

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
        store = VectorStore(x, ext_ids=ext_ids, quant=quant,
                            registry=self.registry)
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
        self.full = SSGIndex(adj=adj, entries=np.asarray(entries, np.int32),
                             n=store.n)
        self.tenants = TenantRegistry(store.n,
                                      trigger=self.cfg.n_query_trigger,
                                      device=self.device,
                                      registry=self.registry)
        self._dev = {}
        self._sync_device(force=True)

    # --------------------------------------------------------- device tables
    def _sync_device(self, force: bool = False) -> None:
        """Refresh the padded device tables when the store epoch moved: the
        row and code tables follow ``store.rows_epoch``, the graph and
        liveness tables ``store.epoch``.  Hot tables are per tenant
        (:meth:`TenantState.hot_tables`)."""
        st, dev = self.store, self.device
        if force or self._dev_epoch != st.epoch:
            if force or self._dev_rows_epoch != st.rows_epoch:
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

    def _row_table(self) -> torch.Tensor:
        """The exact float32 score table (resident ``x_pad``)."""
        return self._dev["x_pad"]

    @property
    def _quant_active(self) -> bool:
        return self.quant is not None and self.cfg.quant.enabled

    def _quant_table(self):
        """The padded code table the full phase scans, or None (float32)."""
        return self._dev["qtable"] if self._quant_active else None

    @property
    def _rerank_k(self) -> int:
        return self.cfg.quant.rerank_k if self._quant_active else 0

    def _queries(self, queries) -> torch.Tensor:
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.store.d:
            raise ValueError(
                f"queries must be (B, {self.store.d}) for this index, got "
                f"{q.shape}")
        return torch.as_tensor(np.ascontiguousarray(q), device=self.device)

    def _search_begin(self, queries) -> torch.Tensor:
        """Per-search-entry checks (one seam for all search paths): the
        query shape, the batch counters, fresh device tables."""
        q = self._queries(queries)
        self._m_batches.inc()
        self._m_queries.inc(q.shape[0])
        self._sync_device()
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
            fused=c.fused, fused_hops=c.fused_hops)
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
            live_pad=self._dev["live_pad"], fused=c.fused,
            fused_hops=c.fused_hops)

    # ------------------------------------------------------------------ misc
    def memory_report(self) -> dict:
        """Byte accounting split by residency, as the reference reports it:
        ``full``/``hot`` graph bytes, ``full_vec`` the float32 rows,
        ``quant`` codes + codebook, ``total`` the resident index, and the
        ``device``/``host``/``disk`` sub-dicts, each with its ``total``."""
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
               "hot": int(hot_bytes), "codebooks": int(codebook),
               "rows": cap1 * st.d * 4,
               "codes": cap1 * code_row if self._quant_active else 0}
        dev["total"] = sum(dev.values())
        host = {"rows": int(st.x.nbytes),
                "codes": (0 if st.quant is None
                          else int(st.quant.codes.nbytes)),
                "meta": int(st.alive.nbytes + st.ext_ids.nbytes)}
        host["total"] = sum(host.values())
        out.update(device=dev, host=host,
                   disk={"tier_files": 0, "total": 0})
        return out

    def _require(self, tenant: Optional[TenantState] = None) -> None:
        if self.full is None:
            raise RuntimeError("call build() first")
        if tenant is not None and tenant.hot is None:
            raise RuntimeError(
                f"hot index missing for tenant {tenant.name!r} — call "
                "warm()/rebuild_hot()")
