"""Ragged paged wave engine: continuous lane admission over paged state.

The fixed-shape :class:`~repro_torch.serving.engine.WaveEngine` ticks
``wave_size`` max-padded lanes no matter how many are live.  This engine
keeps the same search semantics — per-query results bit for bit equal to
the fixed engine's — but keeps its state the way ragged paged attention
keeps a KV cache (:mod:`repro_torch.serving.paged`):

* per-lane scratch lives in ``(P+1, ...)`` slot arrays and the big
  ``seen`` bitmaps in a shared page pool behind a per-lane page table
  with cu-len bookkeeping (a host free-list allocator hands out lane
  slots and pages);
* each tick gathers the *live* lanes into a dense bucket whose width is
  the live count rounded up to a power of two, advances it ``tick_hops``
  expansions — the composed per-hop loop or one launch of the fused hop
  kernel in its paged mode (``kernels/csrc/fused_hop.cu``) — and
  scatters the bucket back.  Work tracks live lanes, not capacity;
* admission and retirement are device scatters
  (:func:`repro_torch.serving.paged.admit_wave`), never a host round-trip
  of wave state, so lanes stream in and out continuously and a straggler
  holds one lane slot, not a wave.

Occupancy (``engine_occupancy_ratio`` = live lanes / lane capacity) is
published through the same :mod:`repro_torch.obs` registry as the fixed
engine, under the same collector key ``"engine"``.  The branches for
store mutation and tiered storage are those of
``repro/serving/paged_engine.py``: a tiered store keeps the composed tick
(its score table reads the host), pins the blocks of the live lanes'
pools, prefetches their next expansions, and marks lanes whose reads
degraded; a chaos plan's page-allocation denial requeues the admission
batch for the next tick.
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
                                             hot_phase_stacked)
from repro_torch.core.features import hot_features
from repro_torch.core.types import DQFConfig, PoolState
from repro_torch.kernels import ops as kops
from repro_torch.obs import (ObsConfig, PerfSentinel, Timeline, TraceLog,
                             device_annotation, sample_decision)
from repro_torch.serving import paged as pg
from repro_torch.serving.engine import (LATENCY_WINDOW, EngineStats,
                                        _device_sync, composed_tick,
                                        retire_batch)
from repro_torch.serving.status import EngineConfig, QueryStatus, shed_victim
from repro_torch.tenancy import DEFAULT_TENANT

__all__ = ["PagedWaveEngine"]


class PagedWaveEngine:
    """Continuous-admission serving engine over paged wave state.

    ``capacity`` is the lane-slot count (the admission ceiling — the
    analogue of the fixed engine's ``wave_size``); ``page_cols`` the seen
    page width; ``min_bucket`` the smallest tick bucket.  Everything else
    mirrors :class:`~repro_torch.serving.engine.WaveEngine`.
    """

    def __init__(self, dqf, *, capacity: int = 64, tick_hops: int = 8,
                 page_cols: int = pg.DEFAULT_PAGE_COLS,
                 min_bucket: int = pg.MIN_BUCKET,
                 latency_window: int = LATENCY_WINDOW,
                 auto_compact: bool = True, compact_ratio: float = 0.3,
                 prefetch: bool = True, obs: Optional[ObsConfig] = None,
                 engine_cfg: Optional[EngineConfig] = None, clock=None):
        if min_bucket < 1 or (min_bucket & (min_bucket - 1)):
            raise ValueError("min_bucket must be a power of two")
        self.dqf = dqf
        self.cfg: DQFConfig = dqf.cfg
        self.device = dqf.device
        self.capacity = int(capacity)
        self.tick_hops = tick_hops
        self.page_cols = int(page_cols)
        self.min_bucket = int(min_bucket)
        self.auto_compact = auto_compact
        self.compact_ratio = compact_ratio
        self.prefetch = prefetch
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
        self.registry = ((self.obs.registry
                          or getattr(dqf, "registry", None))
                         if obs_on else None)
        self._tick_ann = ((lambda: device_annotation("dqf.paged_tick"))
                          if obs_on else contextlib.nullcontext)
        self.timeline = Timeline(enabled=obs_on and self.obs.timeline,
                                 capacity=self.obs.timeline_capacity)
        self.traces = TraceLog(self.obs.trace_capacity)
        self._trace_rate = float(self.obs.trace_rate) if obs_on else 0.0
        self._trace_seed = int(self.obs.trace_seed)
        self._lane_trace: list = [None] * self.capacity
        if self.registry is not None:
            r = self.registry
            self._h_service = r.histogram(
                "engine_service_ms", "seed→retire service time (ms)")
            self._h_qwait = r.histogram(
                "engine_queue_wait_ms", "submit→seed queue wait (ms)")
            self._h_hops = r.histogram(
                "engine_hops", "full-phase hops per retired query",
                lo=1.0, hi=1e5)
            self._g_tick_hit = r.gauge(
                "tier_tick_hit_rate",
                "block-cache hit rate over the last tick window")
            r.register_callback("engine", self._collect_metrics)
        self._fused = bool(self.cfg.fused) and not dqf.store.tiered
        dqf._sync_device()
        self._d = dqf.store.d
        self._epoch = dqf.store.epoch
        self._remap_epoch = dqf.store.remap_epoch
        self._cap = dqf.store.capacity
        self.pagepool = pg.PagePool(self.capacity, dqf.store.capacity,
                                    page_cols=self.page_cols,
                                    registry=self.registry, name="paged")
        self._tick_fn = self._build_tick()
        self._hot_phase = hot_phase_stacked
        self._admit = pg.admit_wave
        # Perf sentinel.  The paged tick's schedule of shapes is the pow2
        # bucket ladder — min_bucket, 2·min_bucket, …, next_pow2(capacity)
        # — so its signature budget is declared up front: one extra
        # signature is a bucket leak, and the sentinel flags it
        # (``jit_schedule_violations_total``).
        self.sentinel = None
        self._n_widths = self._bucket_widths()
        if obs_on and self.obs.sentinel and self.registry is not None:
            self.sentinel = PerfSentinel.from_config(self.obs, self.registry)
            self._tick_fn = self.sentinel.wrap("paged_tick", self._tick_fn)
            self._hot_phase = self.sentinel.wrap("hot_phase_stacked",
                                                 hot_phase_stacked)
            self._admit = self.sentinel.wrap("paged_admit", pg.admit_wave)
            self.sentinel.expect("paged_tick", self._n_widths)
            self.sentinel.attach_capture(
                self, capture_ticks=self.obs.capture_ticks,
                bundle_dir=self.obs.capture_dir)
        self._lane_meta = [None] * self.capacity
        self._lane_status: list = [None] * self.capacity
        self._lane_degraded = [False] * self.capacity
        self._results: dict = {}
        self._state: Optional[pg.PagedState] = None
        self._queries = np.zeros((self.capacity + 1, self._d), np.float32)
        self._table = None
        self._table_key = None
        self._last_pinned = 0
        self._draining = False
        self._next_rid = 0

    def _bucket_widths(self) -> int:
        """Distinct pow2 tick-bucket widths: the schedule budget."""
        n, w = 1, self.min_bucket
        top = pg.bucket_width(self.capacity, self.capacity, self.min_bucket)
        while w < top:
            w *= 2
            n += 1
        return n

    # ------------------------------------------------------------------ tick
    def _build_tick(self):
        cfg = self.cfg
        tree = self.dqf.tree.arrays if self.dqf.tree is not None else None
        shift = self.pagepool.page_shift
        hops = self.tick_hops

        if self._fused:
            def fused_tick(ps: pg.PagedState, lanes, pt, table, adj_pad,
                           live_pad):
                wv = pg.gather_wave(ps, lanes)
                hs = kops.fused_hop_paged(
                    bs.to_hop_state(wv.beam, evals_done=wv.evals),
                    pt, adj_pad, wv.queries, live_pad, table, tree,
                    wv.hot_first, wv.hot_ratio, page_cols=self.page_cols,
                    hops=hops, max_hops=cfg.max_hops, k=cfg.k,
                    eval_gap=cfg.eval_gap, add_step=0,
                    tree_depth=cfg.tree_depth)
                beam, evals = bs.from_hop_state(hs), hs.evals_done
                ps = pg.scatter_wave(ps, lanes, beam, evals)
                return ps, (beam.active, beam.stats.hops,
                            beam.pool.ids, beam.pool.dists)

            return fused_tick

        def tick(ps: pg.PagedState, lanes, pt, table, adj_pad, live_pad):
            # The fixed engine's composed hop loop on a gathered bucket,
            # with page-table seen access.
            wv = pg.gather_wave(ps, lanes)
            run = composed_tick(cfg, tree, hops, lambda s:
                                pg.expand_step_paged(table, adj_pad,
                                                     wv.queries, s, pt,
                                                     shift, live_pad))
            beam, evals = run(wv.beam, wv.evals, wv.hot_first, wv.hot_ratio)
            ps = pg.scatter_wave(ps, lanes, beam, evals)
            return ps, (beam.active, beam.stats.hops,
                        beam.pool.ids, beam.pool.dists)

        return tick

    # ---------------------------------------------------------------- public
    def submit(self, queries: np.ndarray, *, tenant: str = DEFAULT_TENANT,
               deadline_ms: Optional[float] = None) -> list:
        """Enqueue queries for one tenant; returns their request ids.

        Deadline / bounded-admission semantics are identical to
        :meth:`WaveEngine.submit` (one shared status vocabulary).
        """
        t = self.dqf.tenants.get(tenant)       # unknown tenant → KeyError
        if t.hot is None:
            raise RuntimeError(
                f"tenant {tenant!r} has no hot index — warm() it before "
                "serving")
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self._d:
            raise ValueError(
                f"queries must be (B, {self._d}) for this index, got "
                f"{queries.shape}")
        if deadline_ms is None:
            deadline_ms = self.engine_cfg.default_deadline_ms
        now = self._clock()
        deadline = now + deadline_ms / 1e3 if deadline_ms is not None \
            else None
        ids = []
        for q in queries:
            rid = self._next_rid
            self._next_rid += 1
            entry = (rid, q, now, t.name, t.gen, deadline)
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
        """Advance one tick; seeds lanes from the queue on first use."""
        if self._state is None:
            self._init_wave()
        self._tick()

    def run_until_drained(self, max_ticks: int = 10_000) -> dict:
        t0 = self._clock()
        if self._state is None or not self._any_live():
            self._init_wave()
        else:
            self._refill()
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
        return self.registry.scrape() if self.registry is not None else {}

    def export_timeline(self, path: Optional[str] = None):
        """Chrome trace-event JSON of the recorded tick spans (Perfetto)."""
        return self.timeline.export(path)

    def debug_bundle(self, out_dir: str, *, reason: str = "") -> str:
        """Write a black-box debug bundle (see :mod:`repro_torch.obs.bundle`)."""
        from repro_torch.obs import debug_bundle
        return debug_bundle(self, out_dir, reason=reason)

    def _collect_metrics(self) -> dict:
        """Registry scrape-time collector (keyed ``"engine"``)."""
        s = self.stats
        limit = self.effective_max_queue()
        out = {"engine_completed_total": float(s.completed),
               "engine_straggled_total": float(s.straggled),
               "engine_dropped_total": float(s.dropped),
               "engine_shed_total": float(s.shed),
               "engine_deadline_total": float(s.deadline_hit),
               "engine_degraded_total": float(s.degraded),
               "engine_admission_limit": float(limit if limit is not None
                                               else -1),
               "engine_ticks_total": float(s.ticks),
               "engine_hops_total": float(s.total_hops),
               "engine_compactions_total": float(s.compactions),
               "engine_queue_depth": float(len(self.queue)),
               "engine_live_lanes": float(self.pagepool.live_count),
               "engine_lane_capacity": float(self.capacity),
               "engine_occupancy_ratio": self.pagepool.occupancy(),
               "engine_traces_recorded": float(self.traces.total),
               "engine_traces_dropped": float(self.traces.dropped)}
        for status, count in s.terminal.items():
            out[f"engine_terminal_status_total{{status={status}}}"] = \
                float(count)
        return out

    # -------------------------------------------------------------- internals
    def _any_live(self) -> bool:
        return self.pagepool.live_count > 0

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _zero_state(self) -> pg.PagedState:
        return pg.zero_paged_state(
            self.capacity, self.cfg.full_pool, self._d,
            self.pagepool.n_pages, self.page_cols, self.dqf.store.capacity,
            device=self.device)

    def _init_wave(self):
        self._state = None          # free the old pool before the new one
        self._maybe_refresh()
        self.pagepool.reset(self.dqf.store.capacity)
        self._state = self._zero_state()
        self._table_key = None
        self._refill()

    def _maybe_refresh(self):
        """Track the store epoch; mirror of WaveEngine._maybe_refresh."""
        st = self.dqf.store
        if st.epoch == self._epoch:
            return
        if st.remap_epoch != self._remap_epoch and self._any_live():
            raise RuntimeError(
                "store compacted while lanes are in flight — drain the "
                "engine before calling compact()")
        self.dqf._sync_device()
        if self._state is not None:
            if st.remap_epoch != self._remap_epoch:
                # external compaction, engine drained: rebuild from scratch
                self.pagepool.reset(st.capacity)
                self._state = self._zero_state()
            elif st.capacity != self._cap:
                self._grow_paged(self._cap, st.capacity)
            self._table_key = None
        self._cap = st.capacity
        self._epoch = st.epoch
        self._remap_epoch = st.remap_epoch

    def _grow_paged(self, old_cap: int, new_cap: int):
        """Re-page live lanes after capacity growth (sentinel id moved).

        Rare host round-trip: densify the live lanes' seen rows at the
        old width, rebuild the pool for the new width (``pages_per_lane``
        changed), re-adopt the same lane slots, and re-paginate.
        """
        pool = self.pagepool
        live = pool.live_lanes()
        if live.size:
            dense = pg.dense_seen(self._state.seen_pages,
                                  self._to_device(pool.page_table[live]),
                                  old_cap + 1).cpu().numpy()
        pool.reset(new_cap)
        pool.adopt(live)
        pc = self.page_cols
        pages_np = np.zeros((pool.n_pages, pc), bool)
        for j, lane in enumerate(live):
            row = np.zeros(pool.pages_per_lane * pc, bool)
            row[:old_cap] = dense[j, :old_cap]   # old sentinel col dropped
            row[new_cap] = True
            pages_np[pool.page_table[lane]] = row.reshape(-1, pc)
        ids = self._state.ids
        ids = torch.where(ids == old_cap, new_cap, ids).to(torch.int32)
        self._state = self._state._replace(ids=ids,
                                           seen_pages=self._to_device(pages_np))
        if self.sentinel is not None:
            # growth changed the paged shapes: a fresh ladder of bucket
            # signatures is legitimate, so the budget moves with it
            self.sentinel.expect(
                "paged_tick",
                self.sentinel.compile.executables("paged_tick")
                + self._n_widths)

    def _bind_table(self, lanes_np: np.ndarray):
        """Score table for this tick's bucket (PQ LUTs follow the bucket).

        Cached on ``(epoch, bucket lanes)``: steady-state ticks with an
        unchanged bucket reuse the bound table; any admission, retirement
        or store mutation rebinds.
        """
        key = (self._epoch, lanes_np.tobytes())
        if self._table is not None and key == self._table_key:
            return self._table
        qtable = self.dqf._quant_table()
        if qtable is None:
            self._table = self.dqf._row_table()
        else:
            self._table = qtable.with_queries(
                self._to_device(self._queries[lanes_np]))
        self._table_key = key
        return self._table

    def _refill(self):
        """Admit queued requests into freshly allocated lanes.

        The admission batch is padded to a power-of-two bucket and seeded
        with the stacked-tenant hot phase;
        :func:`repro_torch.serving.paged.admit_wave` writes the seeded
        lanes device-side.  Requests whose tenant was evicted (or
        re-created — the ``gen`` check) while queued drop at once.
        """
        reg = self.dqf.tenants
        free = self.pagepool.free_lane_count
        reqs = []
        now = self._clock()
        while self.queue and len(reqs) < free:
            r = self.queue.popleft()
            name, gen = r[3], r[4]
            if name not in reg or reg.get(name).gen != gen:
                self._results[r[0]] = self._terminal_result(
                    name, QueryStatus.DROPPED)
                self.stats.dropped += 1
                self.stats.note_terminal(QueryStatus.DROPPED)
            elif r[5] is not None and now >= r[5]:
                self._results[r[0]] = self._terminal_result(
                    name, QueryStatus.DEADLINE)
                self.stats.deadline_hit += 1
                self.stats.note_terminal(QueryStatus.DEADLINE)
            else:
                reqs.append(r)
        if not reqs:
            return
        m = len(reqs)
        mp = pg.bucket_width(m, self.capacity, self.min_bucket)
        try:
            with self.timeline.span("refill.alloc", lanes=m):
                lanes = self.pagepool.alloc(m)
        except pg.PageAllocDenied:
            # transient injected denial: requeue in arrival order and try
            # again next tick — the requests stay live, never lost
            self.queue.extendleft(reversed(reqs))
            return
        lanes_pad = np.full(mp, self.capacity, np.int32)
        lanes_pad[:m] = lanes
        pt_pad = self.pagepool.page_table[lanes_pad]
        qs = np.zeros((mp, self._d), np.float32)
        qs[:m] = np.stack([r[1] for r in reqs])
        tidx = np.zeros(mp, np.int32)
        tidx[:m] = [reg.slot_of(r[3]) for r in reqs]
        stk = reg.stacked(self.dqf.store)
        tidx_d = self._to_device(tidx)
        q_d = self._to_device(qs)
        with self.timeline.span("refill.hot_phase", lanes=mp):
            hot_pool, hot_stats = self._hot_phase(
                stk.x, stk.adj, stk.entries, stk.mask, tidx_d, q_d,
                pool_size=self.cfg.hot_pool, max_hops=self.cfg.max_hops,
                mode=self.cfg.hot_mode, fused=self._fused)
            hf = hot_features(hot_pool, self.cfg.k)
            seeded = _seed_full_state(hot_pool, stk.ids[tidx_d.long()],
                                      self.dqf.store.capacity,
                                      self.cfg.full_pool,
                                      self.dqf._dev["live_pad"])
        admit_mask = np.zeros(mp, bool)
        admit_mask[:m] = True
        self._state = self._admit(
            self._state, self._to_device(lanes_pad), self._to_device(pt_pad), seeded,
            q_d, hf.first, hf.first_div_kth, self._to_device(admit_mask),
            page_cols=self.page_cols)
        # same sampling contract as the fixed engine: pure in (seed, rid),
        # hot-phase stats come to the host only when a lane is sampled
        sampled = [sample_decision(self._trace_seed, r[0], self._trace_rate)
                   for r in reqs]
        if any(sampled):
            hot_hops = hot_stats.hops.cpu().numpy()
            hot_dist = hot_stats.dist_count.cpu().numpy()
        t_seed = self._clock()
        for j, lane in enumerate(lanes):
            lane = int(lane)
            self._queries[lane] = reqs[j][1]
            rid, t_in = reqs[j][0], reqs[j][2]
            self._lane_meta[lane] = (rid, t_in, t_seed, reqs[j][3],
                                     reqs[j][4], reqs[j][5])
            self._lane_status[lane] = None
            self._lane_degraded[lane] = False
            wait_ms = (t_seed - t_in) * 1e3
            self.stats.queue_wait_ms.append(wait_ms)
            if self.registry is not None:
                self._h_qwait.observe(wait_ms)
            if sampled[j]:
                self._lane_trace[lane] = {
                    "rid": rid, "tenant": reqs[j][3],
                    "hot_hops": int(hot_hops[j]),
                    "hot_dist_evals": int(hot_dist[j]),
                    "seed_tick": self.stats.ticks,
                }
            else:
                self._lane_trace[lane] = None
        self._table_key = None

    def _terminal_result(self, tenant: str, status: QueryStatus) -> dict:
        k = self.cfg.k
        return {"ids": np.full(k, self.dqf.store.capacity, np.int32),
                "dists": np.full(k, np.inf, np.float32),
                "hops": 0, "tenant": tenant, "degraded": False,
                "status": status.value}

    def _tier_begin_tick(self):
        """Tier housekeeping (a tiered store only): pins follow the
        allocator's pages — the pin set comes from the page-table-live
        lanes, so a retired lane's blocks become evictable the moment its
        pages free — then frontier prefetch from the slot arrays."""
        st = self.dqf.store
        if not st.tiered:
            return
        cache = st.full_phase_cache()
        for c in st.tier_caches():      # stale rows from out-of-band
            c.take_degraded_rows()      # searches don't map to lanes
        live = self.pagepool.live_lanes()
        if live.size:
            live_d = self._to_device(live.astype(np.int64))
            ids = self._state.ids[live_d].cpu().numpy()
            ids = ids[ids < st.n]
            bids = cache.blocks_of_rows(ids)
            cache.pin_blocks(bids)
            self._last_pinned = int(len(bids))
        else:
            cache.pin_blocks(())
            self._last_pinned = 0
        cache.apply_prefetch()
        cache.maintain()
        if self.registry is not None:
            self._g_tick_hit.set(cache.stats_snapshot()["hit_rate"])
        if self.prefetch and live.size:
            sub = bs.BeamState(
                PoolState(ids=self._state.ids[live_d],
                          dists=self._state.dists[live_d],
                          expanded=self._state.expanded[live_d]),
                None, None, self._state.active[live_d])
            nxt = bs.next_expansions(sub, st.capacity).cpu().numpy()
            nxt = nxt[nxt < st.n]
            if nxt.size:
                nbrs = self.dqf.full.adj[nxt]
                cache.prefetch_async(cache.blocks_of_rows(
                    np.concatenate([nxt, nbrs[nbrs >= 0]])))
        self._table_key = None      # cache arena moved: rebind the table

    def _do_compact(self):
        """Drained compaction at a safe tick boundary; serving resumes."""
        self.dqf.compact()
        self.stats.compactions += 1
        self._draining = False
        st = self.dqf.store
        self._epoch = st.epoch
        self._remap_epoch = st.remap_epoch
        self._cap = st.capacity
        self.pagepool.reset(st.capacity)
        self._state = self._zero_state()
        self._table_key = None

    def _tick(self):
        tl = self.timeline
        with tl.span("tick", tick=self.stats.ticks):
            with tl.span("tick.housekeeping"):
                self._maybe_refresh()
            with tl.span("tick.tier"):
                self._tier_begin_tick()
            lanes_np, pt_np, n_live = self.pagepool.live_bucket(
                self.min_bucket)
            if n_live:
                table = self._bind_table(lanes_np)
                with tl.span("tick.launch", bucket=len(lanes_np),
                             live=n_live):
                    with self._tick_ann():
                        (self._state,
                         (act, hops_b, ids_b, dists_b)) = self._tick_fn(
                            self._state, self._to_device(lanes_np),
                            self._to_device(pt_np), table,
                            self.dqf._dev["adj_pad"],
                            self.dqf._dev["live_pad"])
                        if tl.enabled:  # make the span cover device time
                            _device_sync(self.device)
                self.stats.ticks += 1
                active = act.cpu().numpy().copy()  # deadlines clear it
                now = self._clock()
                # degraded tier reads: host-fetch batch rows are bucket
                # rows here — map them through lanes_np to lane slots
                if self.dqf.store.tiered:
                    for c in self.dqf.store.tier_caches():
                        for row in c.take_degraded_rows():
                            if row < n_live and self._lane_meta[
                                    lanes_np[row]] is not None:
                                self._lane_degraded[lanes_np[row]] = True
                # per-query deadlines: force-expire overdue bucket rows so
                # they retire this tick with their current best-k
                expired = [j for j in range(n_live)
                           if active[j]
                           and self._lane_meta[lanes_np[j]] is not None
                           and self._lane_meta[lanes_np[j]][5] is not None
                           and now >= self._lane_meta[lanes_np[j]][5]]
                if expired:
                    lanes_x = lanes_np[expired]
                    self._state.active[self._to_device(
                        lanes_x.astype(np.int64))] = False
                    active[expired] = False
                    for lane in lanes_x:
                        self._lane_status[int(lane)] = QueryStatus.DEADLINE
                retiring = [j for j in range(n_live) if not active[j]
                            and self._lane_meta[lanes_np[j]] is not None]
                if retiring:
                    with tl.span("tick.retire", retiring=len(retiring)):
                        self._retire(lanes_np, retiring,
                                     ids_b.cpu().numpy(),
                                     dists_b.cpu().numpy(),
                                     hops_b.cpu().numpy(), now)
            else:
                self.stats.ticks += 1
            if self.auto_compact and not self._draining \
                    and self.dqf.store.should_compact(self.compact_ratio):
                self._draining = True
            if self._draining:
                if not self._any_live():
                    self._do_compact()
                    with tl.span("tick.refill"):
                        self._refill()
            else:
                with tl.span("tick.refill"):
                    self._refill()
        if self.sentinel is not None:
            self.sentinel.on_tick()

    def _retire(self, lanes_np: np.ndarray, retiring: list,
                ids_b: np.ndarray, dists_b: np.ndarray,
                hops_b: np.ndarray, now: float):
        """Harvest results for retiring bucket rows, then free their lanes."""
        rl = [int(lanes_np[j]) for j in retiring]
        batch_ids, batch_dists = retire_batch(
            self.dqf.store, self.dqf._rerank_k, self.cfg.k,
            ids_b[retiring], dists_b[retiring], self._queries[rl])
        # sampled-lane stats move once per retiring tick, never per lane
        if any(self._lane_trace[ln] is not None for ln in rl):
            dist_all = self._state.dist_count.cpu().numpy()
            term_all = self._state.terminated.cpu().numpy()
        for i, j in enumerate(retiring):
            lane = rl[i]
            rid, t_in, t_seed, tenant, gen, _ = self._lane_meta[lane]
            ids, dists = batch_ids[i], batch_dists[i]
            hops = int(hops_b[j])
            degraded = self._lane_degraded[lane]
            status = self._lane_status[lane] or (
                QueryStatus.DEGRADED if degraded else QueryStatus.OK)
            self._results[rid] = {"ids": ids, "dists": dists, "hops": hops,
                                  "tenant": tenant,
                                  "degraded": bool(degraded),
                                  "status": status.value}
            self.stats.completed += 1
            self.stats.note_terminal(status)
            if status is QueryStatus.DEADLINE:
                self.stats.deadline_hit += 1
            if degraded:
                self.stats.degraded += 1
            self.stats.total_hops += hops
            straggled = hops >= self.cfg.max_hops
            if straggled:
                self.stats.straggled += 1
            service_ms = (now - t_seed) * 1e3
            self.stats.latencies_ms.append((now - t_in) * 1e3)
            if self.registry is not None:
                self._h_service.observe(service_ms)
                self._h_hops.observe(hops)
            tr = self._lane_trace[lane]
            if tr is not None:
                tr.update(
                    queue_wait_ms=(t_seed - t_in) * 1e3,
                    service_ms=service_ms,
                    total_ms=(now - t_in) * 1e3,
                    full_hops=hops,
                    full_dist_evals=int(dist_all[lane]),
                    terminated_early=bool(term_all[lane]),
                    straggled=straggled,
                    rerank_k=int(self.dqf._rerank_k),
                    ticks_in_flight=self.stats.ticks - tr["seed_tick"],
                    top_id=int(ids[0]))
                self.traces.add(tr)
                self._lane_trace[lane] = None
            self._lane_meta[lane] = None
            self._lane_status[lane] = None
            self._lane_degraded[lane] = False
            if tenant in self.dqf.tenants \
                    and self.dqf.tenants.get(tenant).gen == gen:
                self.dqf.record(ids[None, :], tenant=tenant)
                self.dqf.maybe_rebuild_hot(tenant=tenant)
        with self.timeline.span("retire.free", lanes=len(rl)):
            self.pagepool.free(rl)
