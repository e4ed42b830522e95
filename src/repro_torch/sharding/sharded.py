"""ShardedDQF — S per-shard DQFs behind one merged search (read path).

A port of ``repro/sharding/sharded.py``.  Each shard owns a full
:class:`repro_torch.core.DQF`: its store, its NSSG over its rows, its
tenants' hot indexes.  Queries are *replicated* and rows are *sharded*.

The stacked search.  With resident float32 shards, one batch of B
queries runs as S·B lanes, lane ``s·B + b`` searching shard s for query
b: every shard's tables are stacked to a common capacity ``(S, cap+1,
·)`` and lane l reads block ``l // B`` of them
(:class:`~repro_torch.core.beam_search.LaneTable`; on the card the fused
hop's per-lane table base).  The graph hot phase is
:func:`~repro_torch.core.dynamic_search.hot_phase_stacked` with lane →
shard, the seed and full phase are
:func:`~repro_torch.core.dynamic_search.search_from_hot` over the stacked
tables and liveness, and the cross-shard top-k is one
:func:`~repro_torch.sharding.merge.merge_topk` (the ``pool_merge``
kernel).  On the card that is one hot-phase and one full-phase
``fused_hop`` launch and one ``pool_merge`` launch a batch, whatever S
is.  The result equals :meth:`ShardedDQF.search_oracle` — every shard
searched on its own, merged on the host by a stable argsort — bit for
bit: padding rows are unreachable and the common sentinels stand where
each shard's own stood.  ``hot_mode="mxu"`` scores each shard's own hot
rows with the top-k kernel (one launch a shard, as the oracle does) and
stacks the rest.  Tiered or quantized shards take the sequential path.

At S = 1 the one shard runs :func:`~repro_torch.core.dynamic_search.
dynamic_search` on its stacked slice, the computation a plain
``DQF.search`` issues, so one shard equals a plain DQF bit for bit.

Ids: callers see stable **global external ids** (``-1`` for empty
slots), int64 numpy arrays, as the reference returns them; external ids
must fit in int32 (they ride the device merge).

Tenants: ``warm``/``record``/``search`` take ``tenant=`` names; the
merged global top-k feeds each tenant's counters **once**: every winner
id goes to the counter of the shard that owns the row, and every
shard's Alg-2 clock advances by the query count.

Writes: ``insert`` fills the least-loaded shards first, ``delete``
routes by the owner map, ``compact`` compacts every shard and then
rebalances (Quake-style: the hottest shard's most-hit live rows move to
the coldest with their external ids and counter mass).  Each write moves
a shard's store epoch, and the stacked tables follow at the next search
(``_sync_stacked`` re-uploads every shard).  :class:`~repro_torch.
sharding.engine.ShardedEngine` serves the index, writes included.

Placement over ranks (``ShardConfig.use_mesh``): with a process group of
at least S ranks the shards are placed one a rank on a one-axis
:class:`~repro_torch.distributed.mesh.Mesh` over ranks ``0 .. S-1`` (the
reference takes the first S devices).  The host state stays replicated:
every rank runs the same build, warm, fit and writes from the same seed,
as every process of a multi-controller JAX job runs the same program.
The device tables are partitioned: ``_sync_stacked`` uploads only this
rank's ``(1, cap+1, ·)`` slice (and its hot tables).  ``search`` runs
this rank's shard through the stacked path (the hot phase, then one
``fused_hop`` launch a phase on the card), ``all_gather``s the ``(B,
k)`` ids and distances over the mesh's group and runs the one
``merge_topk`` on every rank, so every rank returns the oracle's answer.
A :class:`~repro_torch.distributed.mesh.Mesh` given as ``use_mesh`` is
the placement itself, at any S (one included: the reference places
nothing at S = 1, but a world of one rank, as on one card, reaches the
placed code only so).  :class:`~repro_torch.sharding.engine.
ShardedEngine` serves a placed index one shard a rank.  Runs on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import beam_search as bs
from repro_torch.core.decision_tree import (DecisionTree, train_tree,
                                            tree_arrays)
from repro_torch.core.dqf import DQF, resolve_device
from repro_torch.core.dynamic_search import (dynamic_search, hot_phase_mxu,
                                             hot_phase_stacked,
                                             search_from_hot)
from repro_torch.core.tree_training import collect_training_data
from repro_torch.core.types import INF_DIST, PAD_VALUE, DQFConfig, \
    PoolState, SearchResult
from repro_torch.obs import MetricsRegistry
from repro_torch.tenancy import DEFAULT_TENANT

from .merge import gather_candidates, merge_topk, merge_topk_host
from .types import ShardConfig

__all__ = ["ShardedDQF"]

_PAD_VALUE = np.float32(PAD_VALUE)


def _shard_label(flat: str, shard: int) -> str:
    """Inject a ``shard=i`` label into a flat series name."""
    if flat.endswith("}"):
        return f"{flat[:-1]},shard={shard}}}"
    return f"{flat}{{shard={shard}}}"


@dataclasses.dataclass
class _Shard:
    index: int
    dqf: DQF


class ShardedDQF:
    """S independent DQF shards behind one merged-search front door."""

    def __init__(self, cfg: DQFConfig | None = None,
                 shards: ShardConfig | int = 1, *, device=None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg or DQFConfig()
        self.scfg = shards if isinstance(shards, ShardConfig) \
            else ShardConfig(num_shards=int(shards))
        self.device = resolve_device(device)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._m_batches = self.registry.counter(
            "sharded_search_batches_total", "merged search() batch calls")
        self._m_queries = self.registry.counter(
            "sharded_search_queries_total", "queries across merged batches")
        self._m_rebalanced = self.registry.counter(
            "shard_rebalanced_rows_total",
            "rows migrated between shards at compaction")
        self.registry.gauge("shard_count", "configured shard count").set(
            float(self.scfg.num_shards))
        self.registry.register_callback("shards", self._collect_shard_metrics)
        self.shards: list[_Shard] = []
        self.tree: Optional[DecisionTree] = None
        self._owner: dict[int, int] = {}     # global ext id → shard index
        self._next_ext = 0
        self._stk: Optional[dict] = None
        self._stk_key = None
        self._stk_cap = 0
        self._hot_stk: dict = {}
        self._mesh = None

    # ------------------------------------------------------------------ build
    @property
    def num_shards(self) -> int:
        return self.scfg.num_shards

    def _shard_cfg(self, s: int) -> DQFConfig:
        """Per-shard config: a shared tier dir gets a per-shard subdir so
        shard block files never collide (``dir=None`` tiers already get a
        private tempdir per store)."""
        c = self.cfg
        if c.tier.enabled and c.tier.dir:
            return dataclasses.replace(
                c, tier=dataclasses.replace(
                    c.tier, dir=os.path.join(c.tier.dir, f"shard{s}")))
        return c

    def build(self, x: np.ndarray,
              ext_ids: Optional[np.ndarray] = None) -> "ShardedDQF":
        """Partition rows and build one full DQF per shard.

        ``num_shards == 1`` keeps the identity row order, so the
        single-shard deployment is bit-identical to ``DQF().build(x)``.
        ``num_shards > 1`` deals a seeded permutation round-robin — shard
        sizes differ by at most one row.
        """
        self._mesh = self._make_mesh()
        x = np.ascontiguousarray(x, np.float32)
        n = x.shape[0]
        S = self.num_shards
        if n < 2 * S:
            raise ValueError(f"{n} rows cannot fill {S} shards (need >= 2 "
                             "live rows per shard)")
        ext = (np.arange(n, dtype=np.int64) if ext_ids is None
               else np.asarray(ext_ids, np.int64).reshape(-1))
        if ext.shape != (n,):
            raise ValueError("one external id per row required")
        if ext.size and (ext.max() >= 2 ** 31 or ext.min() < 0):
            raise ValueError("sharded external ids must fit in int32 "
                             "(they ride the device merge as payload)")
        if S == 1:
            parts = [np.arange(n)]
        else:
            rng = np.random.default_rng(self.scfg.seed)
            perm = rng.permutation(n)       # density-balance the shards
            parts = [np.sort(perm[s::S]) for s in range(S)]
        self.shards = []
        self._owner = {}
        for s, rows in enumerate(parts):
            dqf = DQF(self._shard_cfg(s), device=self.device).build(
                x[rows], ext_ids=ext[rows])
            self.shards.append(_Shard(index=s, dqf=dqf))
            for e in ext[rows]:
                self._owner[int(e)] = s
        self._next_ext = int(ext.max()) + 1 if n else 0
        self._invalidate_stacked()
        return self

    @classmethod
    def from_arrays(cls, per_shard_arrays, cfg: DQFConfig | None = None,
                    shards: ShardConfig | int | None = None, *,
                    owner: Optional[dict] = None, tree=None, device=None,
                    registry: Optional[MetricsRegistry] = None
                    ) -> "ShardedDQF":
        """A ShardedDQF over saved per-shard state, with no build.

        ``per_shard_arrays`` holds one mapping a shard, in shard order,
        under the reference checkpoint's keys (a reference shard's
        ``DQF.save``, or the port's ``DQF.to_arrays``); each becomes the
        shard's DQF through :meth:`DQF.from_arrays`.  ``owner`` maps global
        ext id → shard (the reference's ``_owner``); omitted, every live
        row's ext id maps to its shard.  ``tree`` is a mapping holding the
        ``tree_*`` keys, assigned to every shard; omitted, the tree the
        first shard's arrays carry (the reference assigns its one tree to
        every shard).
        """
        arrays = list(per_shard_arrays)
        scfg = ShardConfig(num_shards=len(arrays)) if shards is None \
            else shards
        self = cls(cfg, scfg, device=device, registry=registry)
        if len(arrays) != self.num_shards:
            raise ValueError(f"{len(arrays)} shards' arrays for "
                             f"num_shards={self.num_shards}")
        self._mesh = self._make_mesh()
        self.shards = [
            _Shard(index=s, dqf=DQF.from_arrays(a, self._shard_cfg(s),
                                                device=self.device))
            for s, a in enumerate(arrays)]
        if owner is None:
            owner = {}
            for s, sh in enumerate(self.shards):
                st = sh.dqf.store
                for e in st.ext_ids[st.alive]:
                    owner[int(e)] = s
        self._owner = {int(e): int(s) for e, s in owner.items()}
        self._next_ext = max(sh.dqf.store.next_ext for sh in self.shards)
        if tree is not None:
            self.tree = DecisionTree(
                arrays=tree_arrays(tree["tree_feature"],
                                   tree["tree_threshold"], tree["tree_left"],
                                   tree["tree_right"], tree["tree_value"],
                                   device=self.device),
                depth=int(tree["tree_depth"]),
                feature_importance=np.asarray(tree["tree_importance"]))
            for sh in self.shards:
                sh.dqf.tree = self.tree
        else:
            self.tree = self.shards[0].dqf.tree
        self._invalidate_stacked()
        return self

    def _make_mesh(self):
        """One-axis shard mesh over the first S ranks when placement is
        requested and possible: ``True`` needs a process group of at least
        S ranks (``RuntimeError`` otherwise, as the reference's with too
        few devices); ``"auto"`` places when there is one.  A ``Mesh``
        given as ``use_mesh`` is taken as it is, at any S: its
        ``scfg.axis`` must hold S ranks."""
        S = self.num_shards
        um = self.scfg.use_mesh
        if not isinstance(um, (bool, str)):
            if self.scfg.axis not in um.shape or \
                    um.shape[self.scfg.axis] != S:
                raise ValueError(f"use_mesh: a mesh with axis "
                                 f"{self.scfg.axis!r} of {S} ranks needed, "
                                 f"got {um}")
            return um
        if S == 1 or um is False:
            return None
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < S:
            if self.scfg.use_mesh is True:
                raise RuntimeError(
                    f"use_mesh=True needs >= {S} ranks, have {world} "
                    "(start a process group: torchrun, or "
                    "repro_torch.distributed.mesh.init_distributed)")
            return None
        from repro_torch.distributed.mesh import Mesh
        return Mesh((S,), (self.scfg.axis,), ranks=range(S),
                    device_type=self.device.type)

    def _local_shards(self) -> list[int]:
        """The shards whose device tables this rank holds: its own on the
        mesh, else all."""
        if self._mesh is not None and self._mesh.coordinate is not None:
            return [self._mesh.coordinate[self.scfg.axis]]
        return list(range(self.num_shards))

    # ------------------------------------------------------------- residency
    @property
    def _stacked_ok(self) -> bool:
        """The stacked path needs resident float32 tables; tiered or
        quantized shards take the (bit-identical) sequential path."""
        return not (self.cfg.quant.enabled
                    or any(sh.dqf.store.tiered for sh in self.shards))

    # ------------------------------------------------------- stacked tables
    def _invalidate_stacked(self) -> None:
        self._stk = None
        self._stk_key = None
        self._hot_stk = {}

    def _epoch_key(self):
        return tuple((sh.dqf.store.epoch, sh.dqf.store.rows_epoch)
                     for sh in self.shards)

    def _sync_stacked(self) -> dict:
        """(Re)build the stacked full-index tables when any shard moved.

        Every shard is re-padded to the *common* capacity: padding rows
        score ``_PAD_VALUE`` and are unreachable (their adjacency slots
        point at the common sentinel ``cap``), so each shard's search over
        the common-padded slice is bit-identical to its natively padded
        one — results only name real rows and sentinels.  On the shard
        mesh only this rank's block is built and uploaded, ``(1, cap+1,
        ·)``.
        """
        key = self._epoch_key()
        if self._stk is not None and self._stk_key == key:
            return self._stk
        mine = self._local_shards()
        T = len(mine)
        cap = max(sh.dqf.store.capacity for sh in self.shards)
        d = self.shards[0].dqf.store.d
        R = max(sh.dqf.full.adj.shape[1] for sh in self.shards)
        x = np.full((T, cap + 1, d), _PAD_VALUE, np.float32)
        adj = np.full((T, cap + 1, R), cap, np.int32)
        live = np.zeros((T, cap + 1), bool)
        gid = np.full((T, cap + 1), -1, np.int32)
        for s, sh in enumerate(self.shards[i] for i in mine):
            st = sh.dqf.store
            n_s = st.n
            x[s, :n_s] = st.x
            a = sh.dqf.full.adj
            adj[s, :n_s, :a.shape[1]] = np.where(
                (a < 0) | (a >= n_s), cap, a)
            live[s, :n_s] = st.alive
            gid[s, :n_s] = st.ext_ids.astype(np.int32)
        put = lambda a: torch.as_tensor(a, device=self.device)
        self._stk = {"x_pad": put(x), "adj_pad": put(adj),
                     "live_pad": put(live), "gid_pad": put(gid)}
        self._stk_key = key
        self._stk_cap = cap
        self._hot_stk = {}          # hot sentinels depend on the common cap
        return self._stk

    def _hot_stacked(self, tenant: str) -> tuple:
        """Stacked per-shard hot tables for one tenant, common-H padded:
        ``(x (S, H+1, d), adj (S, H+1, Rh), hot ids (S, H+1), entries (S,
        E), each shard's hot size)``.

        Padding entries use the hot sentinel ``H`` (masked to INF by
        ``init_state``) and padded ``hot_ids`` slots use the common full
        sentinel ``cap`` — both exactly re-create each shard's native hot
        phase inside the stacked layout.
        """
        states = []
        for sh in self.shards:
            if tenant not in sh.dqf.tenants:
                raise KeyError(f"unknown tenant {tenant!r}")
            t = sh.dqf.tenants.get(tenant)
            if t.hot is None:
                raise RuntimeError(
                    f"tenant {tenant!r} has no hot index on shard "
                    f"{sh.index} — warm() it before serving")
            states.append(t)
        key = (tuple(t.hot_token for t in states), self._stk_cap)
        hit = self._hot_stk.get(tenant)
        if hit is not None and hit[0] == key:
            return hit[1]
        cap = self._stk_cap
        d = self.shards[0].dqf.store.d
        hots = [t.hot for t in states]
        H = max(h.size for h in hots)
        Rh = max(h.graph.adj.shape[1] for h in hots)
        E = max(h.graph.entries.shape[0] for h in hots)
        mine = self._local_shards()         # the common pads stay global
        T = len(mine)
        xh = np.full((T, H + 1, d), _PAD_VALUE, np.float32)
        adjh = np.full((T, H + 1, Rh), H, np.int32)
        idsh = np.full((T, H + 1), cap, np.int32)
        enth = np.full((T, E), H, np.int32)
        hots = [hots[i] for i in mine]
        for s, (sh, h) in enumerate(zip((self.shards[i] for i in mine),
                                        hots)):
            hs = h.size
            xh[s, :hs] = sh.dqf.store.x[h.ids]
            a = h.graph.adj
            adjh[s, :hs, :a.shape[1]] = np.where((a < 0) | (a >= hs), H, a)
            idsh[s, :hs] = h.ids
            enth[s, :h.graph.entries.shape[0]] = h.graph.entries
        put = lambda a: torch.as_tensor(a, device=self.device)
        out = (put(xh), put(adjh), put(idsh), put(enth),
               tuple(h.size for h in hots))
        self._hot_stk[tenant] = (key, out)
        return out

    # ------------------------------------------------------------- search fn
    def _search_stacked(self, q: torch.Tensor, tenant: str):
        """Every shard's hot phase, seed and full phase as S·B lanes, then
        the cross-shard merge: (ids (B, k) int32 ext ids, dists (B, k)).
        On the shard mesh this rank runs its own shard's B lanes and the
        merge takes every rank's (B, k), gathered."""
        c = self.cfg
        S, B = self.num_shards, q.shape[0]
        T = len(self._local_shards())
        stk = self._sync_stacked()
        xh, adjh, idsh, enth, sizes = self._hot_stacked(tenant)
        tree = self.tree.arrays if self.tree is not None else None
        kw = dict(k=c.k, full_pool_size=c.full_pool, eval_gap=c.eval_gap,
                  add_step=c.add_step, tree_depth=c.tree_depth,
                  max_hops=c.max_hops, fused=c.fused,
                  fused_hops=c.fused_hops)
        if S == 1:
            # the single shard runs the exact computation a plain
            # DQF.search issues (bitwise parity by construction)
            res, _, _ = dynamic_search(
                stk["x_pad"][0], stk["adj_pad"][0], xh[0], adjh[0], idsh[0],
                enth[0], tree, q, hot_pool_size=c.hot_pool,
                hot_mode=c.hot_mode, live_pad=stk["live_pad"][0], **kw)
            lane = torch.zeros(B, dtype=torch.long, device=q.device)
        else:
            lane = torch.arange(T, device=q.device).repeat_interleave(B)
            qq = q.repeat(T, 1)
            if c.hot_mode == "graph":
                hot_pool, _ = hot_phase_stacked(
                    xh, adjh, enth, None, lane, qq, pool_size=c.hot_pool,
                    max_hops=c.max_hops, fused=c.fused)
            else:       # each shard's own hot rows, as its search scores
                pools = [hot_phase_mxu(xh[s, :sizes[s]], q,
                                       pool_size=c.hot_pool)[0]
                         for s in range(T)]
                hot_pool = PoolState(*(torch.cat(f) for f in zip(*pools)))
            table = lambda name: bs.LaneTable(stk[name], lane)
            res, _ = search_from_hot(
                table("x_pad"), table("adj_pad"), hot_pool, idsh[lane],
                tree, qq, live_pad=table("live_pad"), **kw)
        g = bs.LaneTable(stk["gid_pad"], lane).rows(res.ids)   # global ext
        dists = torch.where(g < 0, INF_DIST, res.dists).reshape(T, B, c.k)
        g = g.reshape(T, B, c.k)
        if T < S:                       # placed: every rank's (B, k)
            dists, g = gather_candidates(dists[0], g[0],
                                         self._mesh.group(self.scfg.axis), S)
        return merge_topk(dists, g, c.k)

    # ---------------------------------------------------------------- search
    def _tenant_name(self, tenant) -> str:
        if isinstance(tenant, str):
            return tenant
        name = getattr(tenant, "name", None)
        if name is None:
            raise TypeError("sharded tenants are addressed by name")
        return name

    def _check_queries(self, queries) -> np.ndarray:
        q = np.asarray(queries, np.float32)
        d = self.shards[0].dqf.store.d
        if q.ndim != 2 or q.shape[1] != d:
            raise ValueError(f"queries must be (B, {d}), got {q.shape}")
        return q

    def search(self, queries: np.ndarray, *, record: bool = True,
               auto_rebuild: bool = True,
               tenant=DEFAULT_TENANT) -> SearchResult:
        """Merged dual-index search: global external ids + exact dists.

        One stacked pass covers every shard's hot phase, full phase and
        the cross-shard merge (resident float32 shards); tiered or
        quantized shards take the sequential per-shard path with the host
        stable merge — identical results either way.
        """
        self._require()
        name = self._tenant_name(tenant)
        q = self._check_queries(queries)
        self._m_batches.inc()
        self._m_queries.inc(q.shape[0])
        if self._stacked_ok:
            ids, dists = self._search_stacked(
                torch.as_tensor(np.ascontiguousarray(q), device=self.device),
                name)
            ids = ids.cpu().numpy().astype(np.int64)
            dists = dists.cpu().numpy()
        else:
            ids, dists = self._merge_sequential(q, tenant=name)
        if record:
            self._record_routed(ids, name, auto_rebuild)
        return SearchResult(ids=ids, dists=dists, stats=None)

    def _merge_sequential(self, q: np.ndarray, *, tenant: str,
                          baseline: bool = False):
        """Single-shard oracle: per-shard searches + host stable merge."""
        per_i, per_d = [], []
        for sh in self.shards:
            if baseline:
                res = sh.dqf.search_baseline(q)
            else:
                res = sh.dqf.search(q, record=False, tenant=tenant)
            per_i.append(sh.dqf.to_external(res.ids.cpu().numpy()))
            per_d.append(res.dists.cpu().numpy())
        return merge_topk_host(per_i, per_d, self.cfg.k)

    def search_oracle(self, queries: np.ndarray, *,
                      tenant=DEFAULT_TENANT) -> SearchResult:
        """The sequential reference the stacked path must match bitwise."""
        self._require()
        q = self._check_queries(queries)
        ids, dists = self._merge_sequential(
            q, tenant=self._tenant_name(tenant))
        return SearchResult(ids=ids.astype(np.int64), dists=dists,
                            stats=None)

    def search_baseline(self, queries: np.ndarray) -> SearchResult:
        """Merged plain NSSG beam search (no hot phase / tree)."""
        self._require()
        q = self._check_queries(queries)
        ids, dists = self._merge_sequential(q, tenant=DEFAULT_TENANT,
                                            baseline=True)
        return SearchResult(ids=ids.astype(np.int64), dists=dists,
                            stats=None)

    def search_degraded(self, queries: np.ndarray, alive: list, *,
                        tenant=DEFAULT_TENANT):
        """Fault-tolerant merge over the shards that responded.

        Returns ``(ids, dists, coverage)``; the per-shard response and
        dropout counters land in this instance's registry
        (:meth:`scrape` / :meth:`exposition`).
        """
        from repro_torch.serving.sharded import merge_with_dropout
        self._require()
        name = self._tenant_name(tenant)
        q = self._check_queries(queries)
        k = self.cfg.k
        per_i, per_d = [], []
        for a, sh in zip(alive, self.shards):
            if a:
                res = sh.dqf.search(q, record=False, tenant=name)
                per_i.append(sh.dqf.to_external(res.ids.cpu().numpy()))
                per_d.append(res.dists.cpu().numpy())
            else:       # lost shard: placeholder, skipped by the merge
                per_i.append(np.full((q.shape[0], k), -1, np.int64))
                per_d.append(np.full((q.shape[0], k), np.inf, np.float32))
        return merge_with_dropout(per_i, per_d, list(alive), k,
                                  registry=self.registry)

    def to_external(self, ids: np.ndarray) -> np.ndarray:
        """Sharded results already carry global external ids; invalid
        slots are ``-1`` (API parity with :meth:`DQF.to_external`)."""
        ids = np.asarray(ids)
        return np.where(ids < 0, -1, ids).astype(np.int64)

    # --------------------------------------------------------------- tenants
    def create_tenant(self, name: str) -> None:
        self._require()
        for sh in self.shards:
            if name not in sh.dqf.tenants:
                sh.dqf.create_tenant(name)

    def evict_tenant(self, name: str) -> None:
        self._require()
        for sh in self.shards:
            sh.dqf.evict_tenant(name)
        self._hot_stk.pop(name, None)

    def _route_internal(self, ids_ext: np.ndarray, shard: int) -> np.ndarray:
        """Global ext ids → this shard's internal ids; foreign/invalid
        slots become ``-1`` (ignored by the counters)."""
        sh = self.shards[shard]
        flat = np.asarray(ids_ext, np.int64).reshape(-1)
        out = np.full(flat.shape, -1, np.int64)
        own = np.fromiter((self._owner.get(int(e), -1) == shard
                           for e in flat), bool, flat.size)
        if own.any():
            out[own] = sh.dqf.store.to_internal(flat[own])
        return out.reshape(np.asarray(ids_ext).shape)

    def record(self, ids_ext: np.ndarray, *, tenant=DEFAULT_TENANT) -> None:
        """Feed merged result ids (global ext) into the owning shards'
        tenant counters — each query counted once per shard clock."""
        self._require()
        name = self._tenant_name(tenant)
        ids = np.atleast_2d(np.asarray(ids_ext))
        # one ownership pass for the whole batch (not one per shard):
        # the dict lookup dominates at high shard counts
        flat = ids.reshape(-1).astype(np.int64)
        owner = np.fromiter((self._owner.get(int(e), -1) for e in flat),
                            np.int64, flat.size)
        for s, sh in enumerate(self.shards):
            out = np.full(flat.shape, -1, np.int64)
            own = owner == s
            if own.any():
                out[own] = sh.dqf.store.to_internal(flat[own])
            sh.dqf.tenants.get(name).counter.record(out.reshape(ids.shape))

    def _record_routed(self, ids_ext, name: str, auto_rebuild: bool) -> None:
        self.record(ids_ext, tenant=name)
        if auto_rebuild:
            for sh in self.shards:
                sh.dqf.maybe_rebuild_hot(tenant=name)

    def warm(self, queries: np.ndarray,
             targets: Optional[np.ndarray] = None, *,
             tenant=DEFAULT_TENANT) -> None:
        """Seed a tenant's counters from history and build its per-shard
        hot indexes.  ``targets`` are global external ids; omitted, they
        are resolved with the merged baseline search."""
        self._require()
        name = self._tenant_name(tenant)
        self.create_tenant(name)
        q = self._check_queries(queries)
        if targets is None:
            targets = np.asarray(self.search_baseline(q).ids)
        targets = np.asarray(targets)
        if targets.ndim == 1:
            targets = targets[:, None]
        for s, sh in enumerate(self.shards):
            t = sh.dqf.tenants.get(name)
            t.counter.record(self._route_internal(targets, s))
            sh.dqf.rebuild_hot(tenant=name)

    def rebuild_hot(self, *, tenant=DEFAULT_TENANT) -> None:
        self._require()
        name = self._tenant_name(tenant)
        for sh in self.shards:
            sh.dqf.rebuild_hot(tenant=name)

    def maybe_rebuild_hot(self, *, tenant=DEFAULT_TENANT) -> bool:
        self._require()
        name = self._tenant_name(tenant)
        return any(sh.dqf.maybe_rebuild_hot(tenant=name)
                   for sh in self.shards)

    def fit_tree(self, history_queries: np.ndarray, *,
                 max_depth: Optional[int] = None, dedup: bool = True,
                 min_leaf: int = 16, tenant=DEFAULT_TENANT) -> DecisionTree:
        """Train one shared termination tree on traces from every shard.

        The tree's features are distribution shapes, not ids, so a single
        CART fit over the concatenated per-shard traces serves all shards
        (and at ``num_shards == 1`` reproduces ``DQF.fit_tree`` exactly).
        """
        self._require()
        name = self._tenant_name(tenant)
        feats, labels = [], []
        for sh in self.shards:
            dqf = sh.dqf
            t = dqf._tenant(name)
            dqf._require(t)
            q = dqf._search_begin(history_queries).cpu().numpy()
            if dedup:
                q = np.unique(q, axis=0)
            c = dqf.cfg
            hd = t.hot_tables(dqf.store, dqf.device)
            table = dqf._quant_table()
            f, lab = collect_training_data(
                table if table is not None else dqf._row_table(),
                dqf._dev["adj_pad"], hd["x_hot_pad"], hd["adj_hot_pad"],
                hd["hot_ids_pad"], hd["hot_entries"], q,
                k=c.k, hot_pool_size=c.hot_pool,
                full_pool_size=c.full_pool, eval_gap=c.eval_gap,
                max_hops=c.max_hops, hot_mode="graph",
                live_pad=dqf._dev["live_pad"])
            feats.append(f)
            labels.append(lab)
        self.tree = train_tree(np.concatenate(feats),
                               np.concatenate(labels),
                               max_depth=max_depth or self.cfg.tree_depth,
                               min_leaf=min_leaf, device=self.device)
        for sh in self.shards:          # sequential path uses dqf.tree
            sh.dqf.tree = self.tree
        return self.tree

    # ------------------------------------------------------------- mutation
    def insert(self, rows: np.ndarray,
               ext_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Append rows, filling the least-loaded shards first; returns
        their stable global external ids."""
        self._require()
        rows = np.atleast_2d(np.ascontiguousarray(rows, np.float32))
        m = rows.shape[0]
        if ext_ids is None:
            ext = np.arange(self._next_ext, self._next_ext + m,
                            dtype=np.int64)
        else:
            ext = np.asarray(ext_ids, np.int64).reshape(-1)
            if ext.shape != (m,):
                raise ValueError("one external id per row required")
            known = [int(e) for e in ext if int(e) in self._owner]
            if known:
                raise ValueError(f"external ids already owned: {known[:5]}")
        if m and ext.max() >= 2 ** 31:
            raise ValueError("sharded external ids must fit in int32")
        counts = np.array([sh.dqf.store.live_count for sh in self.shards])
        assign = np.empty(m, np.int64)
        for i in range(m):                          # greedy balance
            s = int(np.argmin(counts))
            assign[i] = s
            counts[s] += 1
        for s, sh in enumerate(self.shards):
            idx = np.flatnonzero(assign == s)
            if idx.size == 0:
                continue
            sh.dqf.insert(rows[idx], ext_ids=ext[idx])
            for e in ext[idx]:
                self._owner[int(e)] = s
        if m:
            self._next_ext = max(self._next_ext, int(ext.max()) + 1)
        return ext

    def delete(self, ext_ids: np.ndarray) -> int:
        """Tombstone rows by global external id; returns the count."""
        self._require()
        req = np.unique(np.asarray(ext_ids, np.int64).reshape(-1))
        groups: dict[int, list] = {}
        for e in req:
            s = self._owner.get(int(e))
            if s is None:
                raise KeyError(f"unknown external id {int(e)}")
            groups.setdefault(s, []).append(int(e))
        done = 0
        for s, ids in groups.items():
            done += self.shards[s].dqf.delete(np.asarray(ids, np.int64))
            for e in ids:
                self._owner.pop(e, None)
        return done

    def compact(self) -> dict:
        """Compact every shard, then rebalance traffic if enabled.

        Rebalancing is Quake-style adaptive partitioning: the per-tenant
        ``tenant_head_mass`` / ``tenant_pref_mass_total`` gauges
        (:mod:`repro_torch.obs`) give each shard's observed preference mass;
        when the hottest shard carries more than
        ``rebalance_imbalance``× the coldest's, its most-accessed rows
        migrate there through the stores' delete/insert remap hooks —
        external ids and per-tenant counter mass move with the rows.
        """
        self._require()
        per = [sh.dqf.compact() for sh in self.shards]
        moved = self._maybe_rebalance() if self.scfg.rebalance else 0
        self._invalidate_stacked()
        return {"per_shard": [{"dropped": p["dropped"], "n": p["n"]}
                              for p in per],
                "rebalanced_rows": moved}

    def _shard_mass(self, sh: _Shard) -> float:
        """Observed preference mass concentrated in this shard's heads
        (the repro.obs head-mass gauges scaled by total mass)."""
        sc = sh.dqf.scrape()
        mass = 0.0
        for key, v in sc.items():
            if key.startswith("tenant_pref_mass_total{"):
                lbl = key.partition("{")[2]
                head = sc.get("tenant_head_mass{" + lbl, 0.0)
                mass += float(v) * float(head)
        return mass

    def _maybe_rebalance(self) -> int:
        if self.num_shards == 1:
            return 0
        masses = [self._shard_mass(sh) for sh in self.shards]
        donor = int(np.argmax(masses))
        recip = int(np.argmin(masses))
        if donor == recip or masses[donor] <= 0.0:
            return 0
        if masses[donor] <= self.scfg.rebalance_imbalance \
                * max(masses[recip], 1e-12):
            return 0
        ddqf = self.shards[donor].dqf
        total = np.zeros(ddqf.store.n, np.float64)
        for t in ddqf.tenants:
            total += t.counter.counts[:ddqf.store.n]
        total[~ddqf.store.alive] = 0.0
        hot = np.flatnonzero(total > 0.0)
        hot = hot[np.argsort(-total[hot], kind="stable")]
        n_move = min(self.scfg.rebalance_max_rows, hot.size,
                     ddqf.store.live_count - 2)
        if n_move <= 0:
            return 0
        move = hot[:n_move]
        ext = ddqf.store.to_external(move).copy()
        rows = ddqf.store.x[move].copy()
        saved = {t.name: t.counter.counts[move].copy()
                 for t in ddqf.tenants}
        ddqf.delete(ext)
        rdqf = self.shards[recip].dqf
        rdqf.insert(rows, ext_ids=ext)
        new_int = rdqf.store.to_internal(ext)
        for name, mass in saved.items():
            if name not in rdqf.tenants:
                rdqf.create_tenant(name)
            t = rdqf.tenants.get(name)
            t.counter.counts[new_int] += mass
            if t.hot is not None and mass.sum() > 0:
                rdqf.rebuild_hot(tenant=name)
        for e in ext:
            self._owner[int(e)] = recip
        self._m_rebalanced.inc(n_move)
        return int(n_move)

    # ----------------------------------------------------------------- misc
    def memory_report(self) -> dict:
        """Fleet byte accounting with per-shard device/host/disk splits."""
        self._require()
        reps = [sh.dqf.memory_report() for sh in self.shards]

        def tier_sum(key):
            names = sorted(set().union(*(r[key] for r in reps)))
            return {nm: sum(r[key].get(nm, 0) for r in reps)
                    for nm in names}

        out = {k: sum(r[k] for r in reps)
               for k in ("full", "hot", "full_vec", "quant", "total")}
        out["compression"] = (out["full_vec"] / out["quant"]
                              if out["quant"] else 1.0)
        out["device"] = tier_sum("device")
        out["host"] = tier_sum("host")
        out["disk"] = tier_sum("disk")
        out["per_shard"] = [{"device": r["device"], "host": r["host"],
                             "disk": r["disk"]} for r in reps]
        return out

    def _collect_shard_metrics(self) -> dict:
        """Registry callback: every shard's scrape, shard-labelled."""
        out = {}
        for s, sh in enumerate(self.shards):
            for key, v in sh.dqf.scrape().items():
                out[_shard_label(key, s)] = v
        return out

    def scrape(self) -> dict:
        """Fleet-wide flat metrics: sharded-level series plus every
        shard's own scrape with a ``shard=i`` label injected."""
        return self.registry.scrape()

    def exposition(self) -> str:
        return self.registry.exposition()

    def relayout_tier(self) -> list:
        """Per-shard tier relayout (no-op entries for resident shards)."""
        self._require()
        return [sh.dqf.relayout_tier() for sh in self.shards]

    def _require(self) -> None:
        if not self.shards:
            raise RuntimeError("call build() first")
