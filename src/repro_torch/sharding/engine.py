"""ShardedEngine — continuous-batching waves fanned across shards.

A port of ``repro/sharding/engine.py``: the scale-out of
:class:`repro_torch.serving.WaveEngine` over a
:class:`~repro_torch.sharding.ShardedDQF`.  The engine holds ONE wave of
``wave_size`` lanes whose queries are replicated to every shard.  Where
the reference vmaps one shard's tick over the shard axis, the port runs
the wave as S·W lanes, lane ``s·W + w`` searching shard s for wave lane w,
over the stacked ``(S, cap+1, ·)`` tables of
:meth:`ShardedDQF._sync_stacked`.  Each tick

* advances every lane ``tick_hops`` expansions: with ``cfg.fused`` ONE
  ``fused_hop`` launch whose per-lane table base ``s·(cap+1)`` picks the
  shard's block, else the composed per-hop loop over
  :class:`~repro_torch.core.beam_search.LaneTable` rows, adjacency and
  liveness (the single-shard engine's ``composed_tick``), and
* merges the full wave's per-shard pools ``(S, W, L)`` into global
  ``(W, k)`` results with ONE :func:`~repro_torch.sharding.merge.merge_topk`
  (one ``pool_merge`` launch), rows tombstoned mid-flight and shards out
  of the merge filtered on the device by the stacked liveness and the
  ``shard_merge`` mask.

A lane retires when it has gone inactive on **every** shard (inactive
lanes are exact no-ops, so the extra iterations on early-finishing shards
change nothing); its result rows come from the tick's merged pool, and
its global external ids feed the owning shards' tenant counters **once**
through :meth:`ShardedDQF.record`: each shard's Alg-2 clock advances by
the query count, as in a single-shard deployment.

The refill seeds free lanes from the common-padded ``(S, T, H+1, ·)``
registry hot stacks, flattened to S·T tables (lane → table ``s·T +
tidx[s, w]``), through :func:`~repro_torch.core.dynamic_search.
hot_phase_stacked`, then ``_seed_full_state`` against the common capacity
and each shard's liveness; only the refilled lanes are seeded, so
occupied lanes keep their state bit for bit.  With ``hot_mode="mxu"``
each shard scores its own hot rows with the top-k kernel (one launch a
shard and tenant), as :meth:`ShardedDQF.search` does.

Paged mode (``paged=True``, :mod:`repro_torch.serving.paged`): ONE host
:class:`~repro_torch.serving.paged.PagePool` (``name="sharded"``) whose
page-table row for lane w is the same on every shard; the S per-shard
slot arrays are one ``(S (W+1), ·)`` set (shard s's lane w at row
``s (W+1) + w``, row ``s (W+1) + W`` its scratch lane) and the S seen
pools one ``(S n_pages, page_cols)`` tensor, shard s reading page-table
row ``pt[w] + s·n_pages``.  A tick gathers the live bucket on every shard
and advances it with ONE ``fused_hop_paged`` launch over S·bucket lanes
(per-lane table base, shard-offset page table), or the composed paged
loop, and scatters it back in place.

Chaos: :meth:`_shard_masks` reads an installed
:class:`~repro_torch.chaos.FaultPlan`'s shard events into
:class:`~repro_torch.sharding.health.ShardHealth`; quarantined shards
freeze and failed or stalled shards miss the tick's merge (results over
the responding shards, ``status="degraded"``).  With no plan and nothing
quarantined the masks are all-True and the tick is bit-identical.

Serving under churn mirrors the single-shard engine: insert/delete swap
the stacked tables between ticks (shapes move only on capacity growth,
which re-pads the wave state); compaction requires a drained wave, and
with ``auto_compact`` the engine drains and runs
:meth:`ShardedDQF.compact` itself, rebalance included.

Placed shards (``ShardConfig.use_mesh``, one shard a rank): each rank
holds the wave state of its own shard only, T = 1 block of W lanes (the
unplaced engine's T = S), and advances it with one ``fused_hop`` (or
``fused_hop_paged``) launch at table base 0.  Each rank maps its ``(W,
L)`` pool to global ids with its own liveness and ``shard_merge`` mask,
and ONE ``all_gather`` a tick (:func:`~repro_torch.sharding.merge.
gather_packed`) brings every rank's pool, lane flags and hop counts, and
rank 0's clock, rank-major; every rank then runs the one ``merge_topk``
and holds the same ``(W, k)``.  The host state (queue, admission,
tenants, ``PagePool``, ``ShardHealth``, counters, writes) is replicated:
every rank takes the same decisions in the same order, so every clock
read that decides anything is one shared value, rank 0's (riding the
tick's gather, else one broadcast: in ``submit`` and in a refill outside
a tick), and a failed, stalled or quarantined shard's rank still takes
part in every collective, its rows masked out of the merge.  The results
equal the unplaced engine's over the same shards bit for bit.  An
:class:`~repro_torch.serving.status.AdmissionController` reads each
rank's own timings; attach one to a placed engine only with a shared
monitor.

Tiered or quantized shards are refused up front: serve those through
:meth:`ShardedDQF.search`.  The engine runs on ``sharded.device``.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import beam_search as bs
from repro_torch.core.dynamic_search import (_seed_full_state,
                                             hot_phase_mxu, hot_phase_stacked)
from repro_torch.core.features import hot_features
from repro_torch.core.types import INF_DIST, PAD_VALUE, PoolState, \
    SearchStats
from repro_torch.kernels import ops as kops
from repro_torch.obs import (ObsConfig, PerfSentinel, Timeline, TraceLog,
                             sample_decision)
from repro_torch.serving import paged as pg
from repro_torch.serving.engine import (LATENCY_WINDOW, EngineStats,
                                        _device_sync, _splice_lanes,
                                        composed_tick)
from repro_torch.serving.status import EngineConfig, QueryStatus, shed_victim
from repro_torch.tenancy import DEFAULT_TENANT

from .health import ShardHealth
from .merge import gather_packed, merge_topk
from .sharded import ShardedDQF

__all__ = ["ShardedEngine"]


class ShardedEngine:
    """Continuous-batching engine over a built :class:`ShardedDQF`."""

    def __init__(self, sharded: ShardedDQF, *, wave_size: int = 64,
                 tick_hops: int = 8,
                 latency_window: int = LATENCY_WINDOW,
                 auto_compact: bool = True, compact_ratio: float = 0.3,
                 paged: bool = False,
                 page_cols: int = pg.DEFAULT_PAGE_COLS,
                 min_bucket: int = pg.MIN_BUCKET,
                 obs: Optional[ObsConfig] = None,
                 engine_cfg: Optional[EngineConfig] = None, clock=None):
        sharded._require()
        if not sharded._stacked_ok:
            raise ValueError(
                "ShardedEngine needs resident float32 shards — tiered or "
                "quantized shards serve through ShardedDQF.search()")
        self.sharded = sharded
        self.cfg = sharded.cfg
        self.device = sharded.device
        self.S = sharded.num_shards
        mesh = sharded._mesh
        if mesh is not None and mesh.coordinate is None:
            raise RuntimeError("this rank holds no shard of the placed "
                               "index; serve it from the mesh's ranks")
        # the shards whose lanes this process ticks: its own when placed
        self._mine = sharded._local_shards()
        self.T = len(self._mine)
        self._group = (mesh.group(sharded.scfg.axis) if mesh is not None
                       else None)
        self.collectives = 0            # placed: all_gathers + broadcasts
        self._tick_time = None          # placed: this tick's shared clock
        self.wave = wave_size
        self.tick_hops = tick_hops
        self.auto_compact = auto_compact
        self.compact_ratio = compact_ratio
        self.paged = bool(paged)
        self.page_cols = int(page_cols)
        self.min_bucket = int(min_bucket)
        self.pagepool = None            # built after the stacked sync
        self.engine_cfg = engine_cfg if engine_cfg is not None \
            else EngineConfig()
        self._clock = clock if clock is not None else time.perf_counter
        self._shed_scale = 1.0      # tightened by AdmissionController
        self.queue: collections.deque = collections.deque()
        self.stats = EngineStats(
            latencies_ms=collections.deque(maxlen=latency_window),
            queue_wait_ms=collections.deque(maxlen=latency_window))
        self.obs = obs if obs is not None else ObsConfig()
        obs_on = bool(self.obs.enabled)
        self.registry = sharded.registry if obs_on else None
        if self.registry is not None:
            self.registry.register_callback("sharded_engine",
                                            self._collect_metrics)
        self.timeline = Timeline(enabled=obs_on and self.obs.timeline,
                                 capacity=self.obs.timeline_capacity)
        self.traces = TraceLog(self.obs.trace_capacity)
        self._trace_rate = float(self.obs.trace_rate) if obs_on else 0.0
        self._trace_seed = int(self.obs.trace_seed)
        self._lane_trace: list = [None] * wave_size
        # chaos is armed by install_chaos; the health tracker quarantines
        # shards after consecutive failures and the tick routes the merge
        # around them (results over the responding shards)
        self.chaos = None
        self.health = ShardHealth(
            self.S, quarantine_after=self.engine_cfg.quarantine_after,
            recover_after=self.engine_cfg.recover_after,
            registry=self.registry)
        self._last_responding = self.S
        self._lane_status: list = [None] * wave_size
        self._lane_degraded = [False] * wave_size
        self._d = sharded.shards[0].dqf.store.d
        self._stk = sharded._sync_stacked()
        self._cap = sharded._stk_cap
        self._epoch_key = sharded._epoch_key()
        self._remap_key = self._remap_epochs()
        if self.paged:
            self.pagepool = pg.PagePool(wave_size, self._cap,
                                        page_cols=page_cols,
                                        registry=self.registry,
                                        name="sharded")
        self._tree = (sharded.tree.arrays if sharded.tree is not None
                      else None)
        self._tick_fn = self._tick_paged_fn if self.paged \
            else self._tick_fixed_fn
        self._seed_fn = self._seed
        self.sentinel = None
        if obs_on and self.obs.sentinel and self.registry is not None:
            self.sentinel = PerfSentinel.from_config(self.obs, self.registry)
            self._tick_fn = self.sentinel.wrap("sharded_tick", self._tick_fn)
            self._seed_fn = self.sentinel.wrap(
                "sharded_admit" if self.paged else "sharded_seed",
                self._seed)
            self.sentinel.attach_capture(
                self, capture_ticks=self.obs.capture_ticks,
                bundle_dir=self.obs.capture_dir)
        self._hot_key = None            # common-padded registry stack cache
        self._hot_stk = None
        self._lane_meta = [None] * wave_size
        self._results: dict = {}
        self._state = None
        self._draining = False
        self._next_rid = 0

    # ------------------------------------------------------------ lane maps
    def _lane_shard(self, width: int) -> torch.Tensor:
        """(T·width,) int64 block of each stacked lane (block-major) in
        this process's stacked tables (T = S unplaced, 1 placed)."""
        return torch.arange(self.T, device=self.device).repeat_interleave(
            width)

    def _mask_lanes(self, mask: np.ndarray, width: int) -> torch.Tensor:
        """(T·width,) bool: a per-shard mask spread over this process's
        stacked lanes."""
        return torch.as_tensor(np.repeat(mask[self._mine], width),
                               device=self.device)

    # ------------------------------------------------------ the shared clock
    def _broadcast_clock(self) -> float:
        """Rank 0's clock reading on every rank (one broadcast)."""
        import torch.distributed as dist

        t = torch.tensor([self._clock()], dtype=torch.float64,
                         device=self.device)
        dist.broadcast(t, group=self._group,
                       src=dist.get_global_rank(self._group, 0))
        self.collectives += 1
        return float(t[0])

    def _now(self) -> float:
        """The clock every decision reads: the local clock unplaced; placed,
        this tick's shared reading, else a broadcast of rank 0's."""
        if self._group is None:
            return self._clock()
        if self._tick_time is None:
            return self._broadcast_clock()
        return self._tick_time

    @contextlib.contextmanager
    def _instant(self):
        """Placed: the clock reads inside share one value, rank 0's, from
        one broadcast (none when a tick's gather already brought it)."""
        if self._group is None or self._tick_time is not None:
            yield
            return
        self._tick_time = self._broadcast_clock()
        try:
            yield
        finally:
            self._tick_time = None

    # ----------------------------------------------------------------- ticks
    def _hop(self, beam: bs.BeamState, evals, queries, hot_first, hot_ratio,
             lane_shard, pt=None):
        """Advance S·B stacked lanes ``tick_hops`` expansions: one
        ``fused_hop`` (or ``fused_hop_paged`` with a page table ``pt``)
        launch with the per-lane table base, or the composed loop over
        lane views of the stacked tables.  ``beam.seen`` is updated in
        place (dense rows, or the page pool)."""
        cfg, stk = self.cfg, self._stk
        if cfg.fused:
            kw = dict(hops=self.tick_hops, max_hops=cfg.max_hops, k=cfg.k,
                      eval_gap=cfg.eval_gap, add_step=0,
                      tree_depth=cfg.tree_depth,
                      lane_base=(lane_shard * (self._cap + 1)).to(
                          torch.int32))
            hs = bs.to_hop_state(beam, evals_done=evals)
            args = (stk["adj_pad"], queries, stk["live_pad"], stk["x_pad"],
                    self._tree, hot_first, hot_ratio)
            if pt is None:
                hs = kops.fused_hop(hs, *args, **kw)
            else:
                hs = kops.fused_hop_paged(hs, pt, *args,
                                          page_cols=self.page_cols, **kw)
            return bs.from_hop_state(hs), hs.evals_done
        x, adj, live = (bs.LaneTable(stk[name], lane_shard)
                        for name in ("x_pad", "adj_pad", "live_pad"))
        if pt is None:
            expand = lambda s: bs.expand_step(x, adj, queries, s, live)
        else:
            shift = self.pagepool.page_shift
            expand = lambda s: pg.expand_step_paged(x, adj, queries, s, pt,
                                                    shift, live)
        run = composed_tick(cfg, self._tree, self.tick_hops, expand)
        return run(beam, evals, hot_first, hot_ratio)

    def _merge(self, ids, dists, lane_shard, merge_m: np.ndarray, width: int,
               active, hops):
        """Cross-shard merge of the stacked pools into ``(width, k)``
        global results: the gid gather, the stacked-liveness filter and
        the ``shard_merge`` mask, then one :func:`merge_topk`.  Returns the
        merged ids and dists and every shard's ``(S, width)`` lane flags
        and hops; placed, those come with the pools from the other ranks
        in one ``all_gather``, which also brings rank 0's clock."""
        g = bs.LaneTable(self._stk["gid_pad"], lane_shard).rows(ids)
        bad = (g < 0) | ~bs.LaneTable(self._stk["live_pad"],
                                      lane_shard).rows(ids)
        if not merge_m.all():
            bad |= ~self._mask_lanes(merge_m, width)[:, None]
        d = torch.where(bad, INF_DIST, dists)
        g = torch.where(bad, -1, g)
        L = ids.shape[1]
        if self._group is None:
            ids, dists = merge_topk(d.reshape(self.S, width, L),
                                    g.reshape(self.S, width, L), self.cfg.k)
            return (ids, dists, active.reshape(self.S, width),
                    hops.reshape(self.S, width))
        clock = torch.tensor([self._clock()], dtype=torch.float64,
                             device=self.device)
        d, g, active, hops, clock = gather_packed(
            [d, g.to(torch.int32), active, hops.to(torch.int32), clock],
            self._group, self.S)
        self.collectives += 1
        self._tick_time = float(clock[0, 0])
        ids, dists = merge_topk(d, g, self.cfg.k)
        return ids, dists, active, hops

    def _tick_fixed_fn(self, live_m: np.ndarray, merge_m: np.ndarray):
        """One fixed tick over the whole wave: hop, freeze quarantined
        shards, merge.  Returns every shard's active flags and hops ``(S,
        W)`` and the merged ``(W, k)`` ids and dists."""
        tl = self.timeline
        W = self.wave
        with tl.span("tick.hop", hops=self.tick_hops, shards=self.S):
            state, evals = self._hop(self._state, self._evals, self._q_stk,
                                     self._hot_first, self._hot_ratio,
                                     self._lanes)
            if not live_m.all():        # quarantined shards freeze
                state = state._replace(
                    active=state.active & self._mask_lanes(live_m, W))
            if tl.enabled:              # make the span cover device time
                _device_sync(self.device)
        self._state, self._evals = state, evals
        with tl.span("tick.merge", shards=self.S):
            m_ids, m_dists, act, hops = self._merge(
                state.pool.ids, state.pool.dists, self._lanes, merge_m, W,
                state.active, state.stats.hops)
            if tl.enabled:
                _device_sync(self.device)
        return act, hops, m_ids, m_dists

    def _tick_paged_fn(self, rows: torch.Tensor, pt: torch.Tensor,
                       live_m: np.ndarray, merge_m: np.ndarray):
        """One paged tick over the gathered bucket ``rows`` (T·Bk slot
        rows, block-major) with the block-offset page table ``pt``:
        gather, hop, scatter in place, freeze, merge.  Returns every
        shard's bucket active flags and hops ``(S, Bk)`` and the merged
        ids and dists ``(Bk, k)``."""
        tl = self.timeline
        S, T, W = self.S, self.T, self.wave
        Bk = rows.shape[0] // T
        lane_shard = self._lane_shard(Bk)
        ps = self._state
        with tl.span("tick.hop", hops=self.tick_hops, shards=S, bucket=Bk):
            wv = pg.gather_wave(ps, rows)
            beam, evals = self._hop(wv.beam, wv.evals, wv.queries,
                                    wv.hot_first, wv.hot_ratio, lane_shard,
                                    pt)
            pg.scatter_wave(ps, rows, beam, evals)
            ps.active.view(T, W + 1)[:, W] = False     # scratch lanes idle
            act = beam.active
            if not live_m.all():        # quarantined shards freeze
                ps.active.view(T, W + 1).logical_and_(torch.as_tensor(
                    live_m[self._mine], device=self.device)[:, None])
                act = act & self._mask_lanes(live_m, Bk)
            if tl.enabled:
                _device_sync(self.device)
        with tl.span("tick.merge", shards=S):
            m_ids, m_dists, act, hops = self._merge(
                beam.pool.ids, beam.pool.dists, lane_shard, merge_m, Bk,
                act, beam.stats.hops)
            if tl.enabled:
                _device_sync(self.device)
        return act, hops, m_ids, m_dists

    # ---------------------------------------------------------------- public
    def submit(self, queries: np.ndarray, *, tenant: str = DEFAULT_TENANT,
               deadline_ms: Optional[float] = None) -> list:
        """Enqueue queries for one tenant; returns their request ids.

        Same degradation contract as :meth:`WaveEngine.submit`:
        ``deadline_ms`` bounds end-to-end time (``status="deadline"``),
        and a bounded queue (``engine_cfg.max_queue``) sheds per
        ``shed_policy`` (``status="shed"``).
        """
        for sh in self.sharded.shards:
            t = sh.dqf.tenants.get(tenant)      # unknown → KeyError
            if t.hot is None:
                raise RuntimeError(
                    f"tenant {tenant!r} has no hot index on shard "
                    f"{sh.index} — warm() it before serving")
        gen = self.sharded.shards[0].dqf.tenants.get(tenant).gen
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self._d:
            raise ValueError(
                f"queries must be (B, {self._d}), got {queries.shape}")
        if deadline_ms is None:
            deadline_ms = self.engine_cfg.default_deadline_ms
        with self._instant():
            now = self._now()
        deadline = now + deadline_ms / 1e3 if deadline_ms is not None \
            else None
        ids = []
        for q in queries:
            rid = self._next_rid
            self._next_rid += 1
            entry = (rid, q, now, tenant, gen, deadline)
            limit = self.effective_max_queue()
            if limit is not None and len(self.queue) >= limit:
                victim = shed_victim(self.queue, entry,
                                     self.engine_cfg.shed_policy)
                self._results[victim[0]] = self._terminal_result(
                    victim[3], QueryStatus.SHED)
                self.stats.shed += 1
                self.stats.note_terminal(QueryStatus.SHED)
            else:
                self.queue.append(entry)
            ids.append(rid)
        return ids

    def effective_max_queue(self) -> Optional[int]:
        """Admission limit after SLO tightening (None = unbounded)."""
        mq = self.engine_cfg.max_queue
        if mq is None:
            return None
        return max(1, int(mq * self._shed_scale))

    def step(self) -> None:
        """Advance the engine exactly one tick (an open-loop caller); seeds
        the wave from the queue on first use."""
        if self._state is None:
            self._init_wave()
        self._tick()

    def run_until_drained(self, max_ticks: int = 10_000) -> dict:
        t0 = self._clock()
        if self._state is None or not self._any_live():
            self._init_wave()       # idle wave: (re)build for new capacity
        else:
            self._refill()          # step()-driven lanes are in flight
        while (self.queue or self._any_live()) \
                and self.stats.ticks < max_ticks:
            self._tick()
        if self._draining and not self._any_live():
            self._do_compact()
        wall = self._clock() - t0
        return {"results": self._results, "wall_s": wall,
                "qps": self.stats.qps(wall), "p99_ms": self.stats.p99_ms(),
                "queue_wait_p99_ms": self.stats.queue_wait_p99_ms(),
                "straggled": self.stats.straggled,
                "compactions": self.stats.compactions}

    def scrape(self) -> dict:
        return self.sharded.scrape()

    def export_timeline(self, path=None):
        """Chrome trace-event JSON of the recorded tick spans (Perfetto)."""
        return self.timeline.export(path)

    def debug_bundle(self, out_dir: str, *, reason: str = "") -> str:
        """Write a black-box debug bundle (:mod:`repro_torch.obs.bundle`)."""
        from repro_torch.obs import debug_bundle
        return debug_bundle(self, out_dir, reason=reason)

    def _collect_metrics(self) -> dict:
        s = self.stats
        live = (self.pagepool.live_count if self.paged
                else sum(m is not None for m in self._lane_meta))
        limit = self.effective_max_queue()
        out = {"sharded_engine_completed_total": float(s.completed),
               "sharded_engine_straggled_total": float(s.straggled),
               "sharded_engine_dropped_total": float(s.dropped),
               "sharded_engine_shed_total": float(s.shed),
               "sharded_engine_deadline_total": float(s.deadline_hit),
               "sharded_engine_degraded_total": float(s.degraded),
               "sharded_engine_admission_limit": float(
                   limit if limit is not None else -1),
               "sharded_engine_shards_responding": float(
                   self._last_responding),
               "sharded_engine_ticks_total": float(s.ticks),
               "sharded_engine_compactions_total": float(s.compactions),
               "sharded_engine_queue_depth": float(len(self.queue)),
               "sharded_engine_live_lanes": float(live),
               "sharded_engine_wave_size": float(self.wave),
               "sharded_engine_occupancy_ratio": live / float(self.wave),
               "sharded_engine_traces_recorded": float(self.traces.total),
               "sharded_engine_traces_dropped": float(self.traces.dropped)}
        for status, count in s.terminal.items():
            out["sharded_engine_terminal_status_total"
                f"{{status={status}}}"] = float(count)
        return out

    def _shard_masks(self):
        """Per-tick ``(live, merge)`` shard masks from chaos + health.

        Consults the armed fault plan for this tick's shard events, folds
        them into the quarantine state machine, and probes quarantined
        shards for re-admission (a plan-free engine probes clean, so a
        quarantined shard recovers after ``recover_after`` ticks once the
        fault source is gone).  With no chaos and nothing quarantined the
        fast path returns all-True without touching the state machine.
        """
        if self.chaos is None and not self.health.quarantined.any():
            self._last_responding = self.S
            live = np.ones(self.S, bool)
            return live, live
        tick = self.stats.ticks
        events = {}
        if self.chaos is not None:
            for s in range(self.S):
                if not self.health.quarantined[s]:
                    ev = self.chaos.shard_event(s, tick)
                    if ev is not None:
                        events[s] = ev
        live, merge = self.health.observe(events)
        for s in np.flatnonzero(self.health.quarantined):
            ok = (self.chaos.shard_ok(int(s), tick)
                  if self.chaos is not None else True)
            self.health.probe(int(s), ok)
        self._last_responding = self.health.responding(merge)
        return live, merge

    # -------------------------------------------------------------- internals
    def _any_live(self) -> bool:
        if self.paged:
            return self.pagepool.live_count > 0
        return any(m is not None for m in self._lane_meta)

    def _remap_epochs(self) -> tuple:
        return tuple(sh.dqf.store.remap_epoch
                     for sh in self.sharded.shards)

    def _maybe_refresh(self):
        """Re-capture the stacked tables after any shard mutated."""
        key = self.sharded._epoch_key()
        if key == self._epoch_key:
            return
        remapped = self._remap_epochs() != self._remap_key
        if remapped and self._any_live():
            raise RuntimeError(
                "a shard compacted while lanes are in flight — drain the "
                "engine before calling compact()")
        old_cap = self._cap
        self._stk = self.sharded._sync_stacked()
        self._cap = self.sharded._stk_cap
        if self._state is not None:
            if remapped:        # compacted outside the engine, drained
                self._reset_state()
            elif self._cap != old_cap:
                if self.paged:
                    self._grow_paged(old_cap, self._cap)
                else:
                    self._grow_state(old_cap, self._cap)
        self._epoch_key = key
        self._remap_key = self._remap_epochs()

    def _grow_state(self, old_cap: int, new_cap: int) -> None:
        """Re-pad the stacked wave state after common-capacity growth (the
        sentinel id moved): one new seen table, filled from the old one,
        which is then dropped."""
        st = self._state
        grown = torch.zeros((st.seen.shape[0], new_cap + 1),
                            dtype=torch.bool, device=self.device)
        grown[:, :old_cap] = st.seen[:, :old_cap]   # old sentinel dropped
        grown[:, new_cap] = True
        ids = torch.where(st.pool.ids == old_cap, new_cap,
                          st.pool.ids).to(torch.int32)
        self._state = st._replace(pool=st.pool._replace(ids=ids), seen=grown)

    def _grow_paged(self, old_cap: int, new_cap: int) -> None:
        """Re-page live lanes on every local shard after common-cap
        growth."""
        pool, S, pc = self.pagepool, self.T, self.page_cols
        live = pool.live_lanes()
        offs = lambda n_pages: torch.arange(
            S, device=self.device)[:, None, None] * n_pages
        if live.size:
            pt = torch.as_tensor(pool.page_table[live], device=self.device)
            dense = pg.dense_seen(
                self._state.seen_pages,
                (pt[None] + offs(pool.n_pages)).reshape(-1, pt.shape[1]),
                old_cap + 1).reshape(S, live.size, old_cap + 1)
        pool.reset(new_cap)
        pool.adopt(live)
        pages = torch.zeros((S * pool.n_pages, pc), dtype=torch.bool,
                            device=self.device)
        if live.size:
            rows = torch.zeros((S, live.size, pool.pages_per_lane * pc),
                               dtype=torch.bool, device=self.device)
            rows[:, :, :old_cap] = dense[:, :, :old_cap]
            rows[:, :, new_cap] = True
            pt = torch.as_tensor(pool.page_table[live], device=self.device)
            pages[(pt[None] + offs(pool.n_pages)).long()] = rows.reshape(
                S, live.size, -1, pc)
        ids = self._state.ids
        self._state = self._state._replace(
            ids=torch.where(ids == old_cap, new_cap, ids).to(torch.int32),
            seen_pages=pages)

    def _zero_state(self) -> bs.BeamState:
        """All-lanes-idle stacked wave state, (T·W, ·)."""
        B, L, n, dev = self.T * self.wave, self.cfg.full_pool, self._cap, \
            self.device
        z = lambda dtype: torch.zeros((B,), dtype=dtype, device=dev)
        pool = PoolState(
            ids=torch.full((B, L), n, dtype=torch.int32, device=dev),
            dists=torch.full((B, L), INF_DIST, dtype=torch.float32,
                             device=dev),
            expanded=torch.zeros((B, L), dtype=torch.bool, device=dev))
        seen = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
        seen[:, n] = True
        stats = SearchStats(dist_count=z(torch.int32),
                            update_count=z(torch.int32),
                            hops=z(torch.int32),
                            terminated_early=z(torch.bool))
        return bs.BeamState(pool, seen, stats, z(torch.bool))

    def _zero_paged(self) -> pg.PagedState:
        """All-idle paged state: T sets of ``W+1`` slot rows, one after
        another, and T page pools in one ``(T n_pages, page_cols)``."""
        return pg.zero_paged_state(
            self.T * (self.wave + 1) - 1, self.cfg.full_pool, self._d,
            self.T * self.pagepool.n_pages, self.page_cols, self._cap,
            device=self.device)

    def _reset_state(self) -> None:
        """Fresh idle wave state at the current capacity (old one freed
        first)."""
        self._state = None
        if self.paged:
            self.pagepool.reset(self._cap)
            self._state = self._zero_paged()
            return
        W, d, dev = self.wave, self._d, self.device
        SW = self.T * W
        self._lanes = self._lane_shard(W)
        self._q_stk = torch.zeros((SW, d), dtype=torch.float32, device=dev)
        self._hot_first = torch.zeros((SW,), dtype=torch.float32,
                                      device=dev)
        self._hot_ratio = torch.zeros((SW,), dtype=torch.float32,
                                      device=dev)
        self._evals = torch.zeros((SW,), dtype=torch.int32, device=dev)
        self._state = self._zero_state()

    def _init_wave(self):
        self._maybe_refresh()
        self._reset_state()
        self._refill()

    def _hot_stacks(self):
        """Common-padded ``(S, T, H+1, …)`` registry hot stacks of this
        process's shards (cached), with each (shard, tenant slot)'s hot
        row count.

        Each shard's :meth:`TenantRegistry.stacked` tables are re-padded
        to shared T/H/R/E; sentinel remaps (native ``H_s`` → common ``H``)
        keep the per-shard hot searches bit-identical to their
        native-shape runs.  Rebuilt only when a shard's stack or the
        common capacity changes.
        """
        shards = [self.sharded.shards[s] for s in self._mine]
        stks = [sh.dqf.tenants.stacked(sh.dqf.store) for sh in shards]
        key = tuple(sh.dqf.tenants._stack_key for sh in shards) + (
            self._cap,)
        if key == self._hot_key:
            return self._hot_stk
        S, d, dev = self.T, self._d, self.device
        T = max(s.x.shape[0] for s in stks)
        H = max(s.x.shape[1] - 1 for s in stks)
        R = max(s.adj.shape[2] for s in stks)
        E = max(s.entries.shape[1] for s in stks)
        xs = torch.full((S, T, H + 1, d), PAD_VALUE, dtype=torch.float32,
                        device=dev)
        adjs = torch.full((S, T, H + 1, R), H, dtype=torch.int32, device=dev)
        ents = torch.full((S, T, E), H, dtype=torch.int32, device=dev)
        mask = torch.zeros((S, T, H + 1), dtype=torch.bool, device=dev)
        hids = torch.full((S, T, H + 1), self._cap, dtype=torch.int32,
                          device=dev)
        for s, stk in enumerate(stks):
            t, h1 = stk.x.shape[:2]
            h = h1 - 1
            a, e = stk.adj, stk.entries
            xs[s, :t, :h1] = stk.x
            adjs[s, :t, :h1, :a.shape[2]] = torch.where(a >= h, H, a)
            ents[s, :t, :e.shape[1]] = torch.where(e >= h, H, e)
            mask[s, :t, :h1] = stk.mask
            hids[s, :t, :h1] = stk.ids
        sizes = mask.sum(dim=2).cpu().numpy()
        self._hot_stk = (xs, adjs, ents, mask, hids, sizes)
        self._hot_key = key
        return self._hot_stk

    def _seed(self, queries: np.ndarray, tidx: np.ndarray):
        """Hot phase + full-state seed of m admitted queries on every local
        shard: ``queries`` (m, d), ``tidx`` (T, m) tenant slots.  Returns
        the seeded stacked state (T·m lanes, block-major) and its hot
        features."""
        cfg = self.cfg
        S, m = tidx.shape
        xs, adjs, ents, mask, hids, sizes = self._hot_stacks()
        T, H1 = xs.shape[1], xs.shape[2]
        q = torch.as_tensor(queries, device=self.device).repeat(S, 1)
        table = torch.as_tensor(
            (np.arange(S)[:, None] * T + tidx).reshape(-1),
            device=self.device)
        lane_shard = self._lane_shard(m)
        with self.timeline.span("refill.hot_phase", lanes=S * m):
            if cfg.hot_mode == "graph":
                hot_pool, _ = hot_phase_stacked(
                    xs.view(S * T, H1, -1), adjs.view(S * T, H1, -1),
                    ents.view(S * T, -1), mask.view(S * T, H1), table, q,
                    pool_size=cfg.hot_pool, max_hops=cfg.max_hops,
                    mode="graph", fused=cfg.fused)
            else:       # each shard's own hot rows, one top-k a tenant
                P, dev = cfg.hot_pool, self.device
                hot_pool = PoolState(
                    ids=torch.empty((S * m, P), dtype=torch.int32,
                                    device=dev),
                    dists=torch.empty((S * m, P), dtype=torch.float32,
                                      device=dev),
                    expanded=torch.zeros((S * m, P), dtype=torch.bool,
                                         device=dev))
                for s in range(S):
                    for t in np.unique(tidx[s]).tolist():
                        j = torch.as_tensor(np.flatnonzero(tidx[s] == t),
                                            device=dev)
                        pool, _ = hot_phase_mxu(xs[s, t, :sizes[s, t]],
                                                q[j], pool_size=P)
                        hot_pool.ids[s * m + j] = pool.ids
                        hot_pool.dists[s * m + j] = pool.dists
            hf = hot_features(hot_pool, cfg.k)
            seeded = _seed_full_state(
                hot_pool, hids.view(S * T, H1)[table], self._cap,
                cfg.full_pool,
                bs.LaneTable(self._stk["live_pad"], lane_shard))
        return seeded, hf, q

    def _pop_requests(self, free: int) -> list:
        """Up to ``free`` live requests off the queue; dead (vanished
        tenant) and expired ones terminate at once."""
        reg0 = self.sharded.shards[0].dqf.tenants
        reqs = []
        now = self._now()
        while self.queue and len(reqs) < free:
            r = self.queue.popleft()
            name, gen = r[3], r[4]
            if name not in reg0 or reg0.get(name).gen != gen:
                self._results[r[0]] = self._terminal_result(
                    name, QueryStatus.DROPPED)
                self.stats.dropped += 1
                self.stats.note_terminal(QueryStatus.DROPPED)
            elif r[5] is not None and now >= r[5]:
                # expired while queued: terminate empty, never seed a lane
                self._results[r[0]] = self._terminal_result(
                    name, QueryStatus.DEADLINE)
                self.stats.deadline_hit += 1
                self.stats.note_terminal(QueryStatus.DEADLINE)
            else:
                reqs.append(r)
        return reqs

    def _tenant_slots(self, reqs: list) -> np.ndarray:
        """(T, m) each request's tenant slot on every local shard."""
        return np.asarray([[self.sharded.shards[s].dqf.tenants.slot_of(r[3])
                            for r in reqs] for s in self._mine], np.int64)

    def _admit_meta(self, lanes, reqs: list, t_seed: float) -> None:
        for lane, r in zip(lanes, reqs):
            lane = int(lane)
            rid, t_in = r[0], r[2]
            self._lane_meta[lane] = (rid, t_in, t_seed, r[3], r[4], r[5])
            self._lane_status[lane] = None
            self._lane_degraded[lane] = False
            self.stats.queue_wait_ms.append((t_seed - t_in) * 1e3)
            self._lane_trace[lane] = self._trace_begin(rid, r[3])

    def _refill_paged(self):
        """Admit queued requests into freshly allocated lanes (paged)."""
        reqs = self._pop_requests(self.pagepool.free_lane_count)
        if not reqs:
            return
        m = len(reqs)
        try:
            lanes = self.pagepool.alloc(m)
        except pg.PageAllocDenied:
            # injected denial: requeue in arrival order, retry next tick
            self.queue.extendleft(reversed(reqs))
            return
        S, W, pool = self.T, self.wave, self.pagepool
        seeded, hf, q = self._seed_fn(np.stack([r[1] for r in reqs]),
                                      self._tenant_slots(reqs))
        rows = (np.arange(S)[:, None] * (W + 1) + lanes[None]).reshape(-1)
        pt = (pool.page_table[lanes][None]
              + np.arange(S)[:, None, None] * pool.n_pages).reshape(
                  S * m, -1)
        put = lambda a: torch.as_tensor(a, device=self.device)
        pg.admit_wave(self._state, put(rows), put(pt), seeded, q, hf.first,
                      hf.first_div_kth,
                      torch.ones((S * m,), dtype=torch.bool,
                                 device=self.device),
                      page_cols=self.page_cols)
        self._admit_meta(lanes, reqs, self._now())

    def _trace_begin(self, rid: int, tenant: str):
        """Trace skeleton for a sampled admission (None when unsampled):
        the reference's deterministic ``(seed, rid)`` contract, admission
        fields only; the retirement fills the merged-result side."""
        if not sample_decision(self._trace_seed, rid, self._trace_rate):
            return None
        return {"rid": rid, "tenant": tenant,
                "seed_tick": self.stats.ticks, "shards": self.S}

    def _refill(self):
        """Seed free lanes from the queue: the hot phase and seed of the
        refilled lanes on every shard, spliced into the wave state in
        place (occupied lanes are never touched).  Placed, its clock reads
        are one shared value."""
        with self._instant():
            if self.paged:
                self._refill_paged()
            else:
                self._refill_fixed()

    def _refill_fixed(self):
        free = [i for i, m in enumerate(self._lane_meta) if m is None]
        reqs = self._pop_requests(len(free))
        if not reqs:
            return
        S, W, m = self.T, self.wave, len(reqs)
        lanes = np.asarray(free[:m])
        seeded, hf, q = self._seed_fn(np.stack([r[1] for r in reqs]),
                                      self._tenant_slots(reqs))
        rows = torch.as_tensor(
            (np.arange(S)[:, None] * W + lanes[None]).reshape(-1),
            device=self.device)
        _splice_lanes(self._state, rows, seeded)
        self._q_stk[rows] = q
        self._hot_first[rows] = hf.first
        self._hot_ratio[rows] = hf.first_div_kth
        self._evals[rows] = 0
        self._admit_meta(lanes, reqs, self._now())

    def _terminal_result(self, tenant: str, status: QueryStatus) -> dict:
        """Empty result for a request that never reached a lane
        (tenant vanished / shed at admission / expired while queued)."""
        k = self.cfg.k
        return {"ids": np.full(k, -1, np.int64),
                "dists": np.full(k, np.inf, np.float32),
                "hops": 0, "tenant": tenant, "degraded": False,
                "status": status.value, "shards_responding": 0}

    def _do_compact(self):
        """Drained compaction (and rebalance) at a safe tick boundary; the
        wave state is rebuilt against the new stacked maps."""
        self.sharded.compact()
        self.stats.compactions += 1
        self._draining = False
        self._stk = self.sharded._sync_stacked()
        self._cap = self.sharded._stk_cap
        self._epoch_key = self.sharded._epoch_key()
        self._remap_key = self._remap_epochs()
        self._reset_state()

    def _after_retire(self):
        """Background compaction: once a shard's tombstone ratio trips the
        trigger, stop refilling, drain, compact, then resume."""
        tl = self.timeline
        if self.auto_compact and not self._draining and any(
                sh.dqf.store.should_compact(self.compact_ratio)
                for sh in self.sharded.shards):
            self._draining = True
        if self._draining:
            if not self._any_live():
                self._do_compact()
                with tl.span("tick.refill"):
                    self._refill()
        else:
            with tl.span("tick.refill"):
                self._refill()

    def _tick(self):
        self._maybe_refresh()
        try:
            if self.paged:
                self._tick_paged()
            else:
                self._tick_fixed()
        finally:
            self._tick_time = None
        if self.sentinel is not None:
            self.sentinel.on_tick()

    def _tick_fixed(self):
        tl = self.timeline
        W = self.wave
        with tl.span("tick", tick=self.stats.ticks):
            live_m, merge_m = self._shard_masks()
            act, hops_t, m_ids, m_dists = self._tick_fn(live_m, merge_m)
            state = self._state
            self.stats.ticks += 1
            lane_live = act.cpu().numpy().any(axis=0)   # every shard's
            now = self._now()
            # per-query deadlines: lanes past deadline are force-expired
            # and retire this tick with their current best-k
            expired = [lane for lane, meta in enumerate(self._lane_meta)
                       if meta is not None and lane_live[lane]
                       and meta[5] is not None and now >= meta[5]]
            if expired:
                state.active.view(self.T, W)[
                    :, torch.as_tensor(expired, device=self.device)] = False
                lane_live[expired] = False
                for lane in expired:
                    self._lane_status[lane] = QueryStatus.DEADLINE
            retiring = [lane for lane, meta in enumerate(self._lane_meta)
                        if meta is not None and not lane_live[lane]]
            if retiring:
                with tl.span("tick.retire", retiring=len(retiring)):
                    self._retire(retiring, retiring, m_ids.cpu().numpy(),
                                 m_dists.cpu().numpy(),
                                 hops_t.cpu().numpy(), now)
            self._after_retire()

    def _tick_paged(self):
        """One bucketed tick over the live lanes (paged mode)."""
        tl = self.timeline
        T, W = self.T, self.wave
        with tl.span("tick", tick=self.stats.ticks):
            lanes_np, pt_np, n_live = self.pagepool.live_bucket(
                self.min_bucket)
            if n_live:
                live_m, merge_m = self._shard_masks()
                n_pages = self.pagepool.n_pages
                rows = (np.arange(T)[:, None] * (W + 1)
                        + lanes_np[None]).reshape(-1)
                pt = (pt_np[None] + np.arange(T)[:, None, None]
                      * n_pages).reshape(T * len(lanes_np), -1)
                put = lambda a: torch.as_tensor(a, device=self.device)
                act, hops_b, m_ids, m_dists = self._tick_fn(
                    put(rows), put(pt.astype(np.int32)), live_m, merge_m)
                self.stats.ticks += 1
                lane_live = act.cpu().numpy().any(axis=0)   # (Bk,)
                now = self._now()
                meta = [self._lane_meta[int(lane)]
                        for lane in lanes_np[:n_live]]
                # deadline force-expiry over live bucket rows
                expired = [j for j in range(n_live) if lane_live[j]
                           and meta[j] is not None and meta[j][5] is not None
                           and now >= meta[j][5]]
                if expired:
                    x = lanes_np[expired]
                    self._state.active.view(T, W + 1)[
                        :, torch.as_tensor(x, device=self.device)] = False
                    lane_live[expired] = False
                    for lane in x:
                        self._lane_status[int(lane)] = QueryStatus.DEADLINE
                retiring = [j for j in range(n_live) if not lane_live[j]
                            and meta[j] is not None]
                if retiring:
                    with tl.span("tick.retire", retiring=len(retiring)):
                        lanes = [int(lanes_np[j]) for j in retiring]
                        self._retire(lanes, retiring, m_ids.cpu().numpy(),
                                     m_dists.cpu().numpy(),
                                     hops_b.cpu().numpy(), now)
                        with tl.span("retire.free", lanes=len(lanes)):
                            self.pagepool.free(lanes)
            else:
                self.stats.ticks += 1
            self._after_retire()

    def _retire(self, lanes: list, cols: list, m_ids: np.ndarray,
                m_dists: np.ndarray, hops_all: np.ndarray, now: float):
        """Harvest merged results for the retiring ``lanes`` (wave lanes),
        whose merged rows and hop columns are ``cols``."""
        feed = {}                                   # (tenant, gen) -> [ids]
        for lane, j in zip(lanes, cols):
            rid, t_in, t_seed, tenant, gen, _ = self._lane_meta[lane]
            ids = m_ids[j].astype(np.int64)
            dists = np.where(ids < 0, np.inf, m_dists[j]).astype(np.float32)
            hops = int(hops_all[:, j].max())
            responding = self._last_responding
            degraded = self._lane_degraded[lane] or responding < self.S
            status = self._lane_status[lane] or (
                QueryStatus.DEGRADED if degraded else QueryStatus.OK)
            self._results[rid] = {"ids": ids, "dists": dists, "hops": hops,
                                  "tenant": tenant,
                                  "degraded": bool(degraded),
                                  "status": status.value,
                                  "shards_responding": responding}
            self.stats.completed += 1
            self.stats.note_terminal(status)
            if status is QueryStatus.DEADLINE:
                self.stats.deadline_hit += 1
            if degraded:
                self.stats.degraded += 1
            self.stats.total_hops += int(hops_all[:, j].sum())
            if hops >= self.cfg.max_hops:
                self.stats.straggled += 1
            self.stats.latencies_ms.append((now - t_in) * 1e3)
            tr = self._lane_trace[lane]
            if tr is not None:
                tr.update(
                    queue_wait_ms=(t_seed - t_in) * 1e3,
                    service_ms=(now - t_seed) * 1e3,
                    total_ms=(now - t_in) * 1e3,
                    full_hops=hops,
                    shard_hops=[int(h) for h in hops_all[:, j]],
                    straggled=hops >= self.cfg.max_hops,
                    ticks_in_flight=self.stats.ticks - tr["seed_tick"],
                    top_id=int(ids[0]))
                self.traces.add(tr)
                self._lane_trace[lane] = None
            self._lane_meta[lane] = None
            self._lane_status[lane] = None
            self._lane_degraded[lane] = False
            feed.setdefault((tenant, gen), []).append(ids)
        # merged global ids feed the owning shards' counters ONCE per
        # query, batched per (tenant, gen): one record and one rebuild
        # check a tenant a tick
        reg0 = self.sharded.shards[0].dqf.tenants
        for (tenant, gen), rows in feed.items():
            if tenant in reg0 and reg0.get(tenant).gen == gen:
                self.sharded.record(np.stack(rows), tenant=tenant)
                self.sharded.maybe_rebuild_hot(tenant=tenant)
