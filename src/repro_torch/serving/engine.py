"""Continuous-batching serving engine for DQF search.

Beam search is lane-batched: a lane that terminates early (decision tree)
stops doing useful work while its batch siblings finish.  The wave engine
turns per-lane termination into throughput:

* the engine holds a fixed wave of ``wave_size`` lanes;
* each tick advances the whole wave ``tick_hops`` expansions — one launch
  of the fused hop kernel (``DQFConfig(fused=True)``) or the composed
  per-hop loop;
* lanes that finished (pool exhausted / tree verdict / hop cap) retire,
  and their slots are refilled from the request queue without disturbing
  live lanes (per-lane state reset, device-side);
* stragglers: a lane that reaches ``max_hops`` is force-retired with its
  current best-k (bounded tail latency), counted in ``stats.straggled``.

With a quantized Full Index (``cfg.quant``) the wave scores its lanes
against the compressed score table; each lane gets an exact float32
rerank of its pool head at retirement, off the hot path of live lanes.

The engine is *multi-tenant* (:mod:`repro_torch.tenancy`): ``submit``
takes a ``tenant=``, lanes of different tenants ride the same wave, and
the refill hot phase reads each lane's own block of the registry's
stacked hot tables.  A retiring lane feeds its tenant's query counter
and, when that tenant's Alg-2 trigger is due, rebuilds its hot index
(the full phase is tenant-agnostic, so in-flight lanes are undisturbed).

The engine watches ``dqf.store.epoch`` and re-captures the padded device
tables after a mutation; compaction is legal only on a drained engine,
which runs it itself once the tombstone ratio crosses ``compact_ratio``.
The branches for store mutation and tiered storage are those of
``repro/serving/engine.py``.  Over a tiered store the tick stays composed
(its score table reads the host between launches); at each tick boundary
the engine pins the blocks in-flight lanes still read, applies finished
prefetches, admits the hottest missed blocks, publishes the tick's hit
rate (``tier_tick_hit_rate``), and requests the blocks of the wave's next
expansions from the cache's prefetch thread; a lane whose host read
exhausted its retries retires with ``status="degraded"``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import beam_search as bs
from repro_torch.core.decision_tree import predict
from repro_torch.core.dynamic_search import (_seed_full_state,
                                             hot_phase_stacked)
from repro_torch.core.features import feature_matrix, hot_features
from repro_torch.core.types import (INF_DIST, DQFConfig, HotFeatures,
                                    PoolState, SearchStats)
from repro_torch.kernels import ops as kops
from repro_torch.obs import (ObsConfig, PerfSentinel, Timeline, TraceLog,
                             device_annotation, sample_decision)
from repro_torch.serving.status import EngineConfig, QueryStatus, shed_victim
from repro_torch.tenancy import DEFAULT_TENANT

__all__ = ["WaveEngine", "EngineStats", "retire_batch"]

# Retirement latencies kept for p99 (windowed, so a long-running engine's
# memory stays bounded; ~4k samples give a stable tail estimate).
LATENCY_WINDOW = 4096


def retire_batch(store, rerank_k: int, k: int, pool_ids: np.ndarray,
                 pool_dists: np.ndarray, queries: np.ndarray):
    """Final results for a batch of retiring lanes (host side).

    Drops sentinel/padding ids and rows tombstoned while the lanes were
    in flight; with a quantized table (``rerank_k > 0``) the pool heads
    are re-scored exactly in float32.  One vectorized pass covers every
    retiring lane — ``(m, L)`` pools in, ``(m, k)`` results out.  Shared
    by the fixed-wave and paged engines.
    """
    st = store
    m, L = pool_ids.shape
    # filter whole pools first (mid-flight deletes can hit the head),
    # then compact surviving candidates left, pool order preserved
    keep = (pool_ids < st.n)
    keep &= st.alive[np.minimum(pool_ids, st.n - 1)]
    order = np.argsort(~keep, axis=1, kind="stable")
    rr = min(max(rerank_k, k), L)
    cand = np.take_along_axis(pool_ids, order, 1)[:, :rr]
    cd = np.take_along_axis(pool_dists, order, 1)[:, :rr]
    valid = np.take_along_axis(keep, order, 1)[:, :rr]
    if rerank_k:
        safe = np.where(valid, cand, 0)
        cd = np.sum((st.x[safe] - queries[:, None, :]) ** 2, axis=-1)
        cd[~valid] = np.inf
        top = np.argsort(cd, axis=1, kind="stable")[:, :k]
        ids = np.take_along_axis(cand, top, 1)
        dists = np.take_along_axis(cd, top, 1)
        valid = np.take_along_axis(valid, top, 1)
    else:                                   # pools are sorted already
        ids, dists, valid = cand[:, :k], cd[:, :k], valid[:, :k]
    if ids.shape[1] < k:                    # rr < k: pad the tail
        pad = k - ids.shape[1]
        ids = np.concatenate(
            [ids, np.zeros((m, pad), ids.dtype)], axis=1)
        dists = np.concatenate(
            [dists, np.zeros((m, pad), dists.dtype)], axis=1)
        valid = np.concatenate(
            [valid, np.zeros((m, pad), bool)], axis=1)
    ids = np.where(valid, ids, st.capacity).astype(np.int32)
    dists = np.where(valid, dists, np.inf).astype(np.float32)
    return ids, dists


def _splice_lanes(state: bs.BeamState, lanes: torch.Tensor,
                  seeded: bs.BeamState) -> bs.BeamState:
    """Write freshly seeded lanes into the wave state, in place on the
    device: only the refilled rows move, live lanes are never touched.
    ``lanes`` are distinct free lanes."""
    for dst, src in ((state.pool.ids, seeded.pool.ids),
                     (state.pool.dists, seeded.pool.dists),
                     (state.pool.expanded, seeded.pool.expanded),
                     (state.seen, seeded.seen),
                     (state.stats.dist_count, seeded.stats.dist_count),
                     (state.stats.update_count, seeded.stats.update_count),
                     (state.stats.hops, seeded.stats.hops),
                     (state.stats.terminated_early,
                      seeded.stats.terminated_early)):
        dst[lanes] = src
    state.active[lanes] = True
    return state


def _device_sync(device: torch.device) -> None:
    """Wait for the device (a timeline span then covers device time)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def composed_tick(cfg: DQFConfig, tree, hops: int, expand):
    """The engines' composed tick body: ``hops`` calls of ``expand`` (one
    beam expansion of every lane), each followed by the hop cap and the
    serving tree check (an immediate stop, the ``add_step=0`` case)."""

    def run(state: bs.BeamState, evals, hot_first, hot_ratio):
        for _ in range(hops):
            s = expand(state)
            s = s._replace(active=s.active & (s.stats.hops < cfg.max_hops))
            if tree is not None:
                due = (s.stats.dist_count // cfg.eval_gap) > evals
                due = due & s.active
                feats = feature_matrix(HotFeatures(hot_first, hot_ratio),
                                       s.pool, s.stats, cfg.k)
                stop = (predict(tree, feats, cfg.tree_depth) < 0.5) & due
                evals = torch.where(due, s.stats.dist_count // cfg.eval_gap,
                                    evals)
                s = s._replace(
                    active=s.active & ~stop,
                    stats=s.stats._replace(
                        terminated_early=s.stats.terminated_early
                        | (stop & s.active)))
            state = s
        return state, evals

    return run


@dataclasses.dataclass
class EngineStats:
    completed: int = 0
    straggled: int = 0
    dropped: int = 0            # requests whose tenant was evicted queued
    shed: int = 0               # rejected by bounded admission
    deadline_hit: int = 0       # deadline expiries (queued or in-flight)
    degraded: int = 0           # served through a degraded path
    ticks: int = 0
    total_hops: int = 0
    compactions: int = 0        # background drain-and-compact cycles
    # terminal-status tallies keyed by QueryStatus value — the single
    # source for engine_terminal_status_total{status=...}
    terminal: dict = dataclasses.field(default_factory=dict)
    latencies_ms: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))
    # submit→seed wait, recorded when the lane is seeded; splitting it from
    # the end-to-end latency separates queueing from service time
    queue_wait_ms: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))

    def note_terminal(self, status: "QueryStatus") -> None:
        self.terminal[status.value] = self.terminal.get(status.value, 0) + 1

    def qps(self, wall_s: float) -> float:
        return self.completed / wall_s if wall_s > 0 else 0.0

    def p99_ms(self) -> float:
        """p99 over the most recent ``latencies_ms.maxlen`` retirements.

        NaN on an empty window — 0.0 would read as "infinitely fast" in a
        dashboard; NaN propagates and comparisons against it are False.
        """
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(self.latencies_ms, 99))

    def queue_wait_p99_ms(self) -> float:
        """p99 submit→seed wait over the recent window (NaN when empty)."""
        if not self.queue_wait_ms:
            return float("nan")
        return float(np.percentile(self.queue_wait_ms, 99))


class WaveEngine:
    """Continuous-batching engine over a built DQF instance."""

    def __init__(self, dqf, *, wave_size: int = 64, tick_hops: int = 8,
                 latency_window: int = LATENCY_WINDOW,
                 auto_compact: bool = True, compact_ratio: float = 0.3,
                 prefetch: bool = True, obs: Optional[ObsConfig] = None,
                 engine_cfg: Optional[EngineConfig] = None, clock=None):
        self.dqf = dqf
        self.cfg: DQFConfig = dqf.cfg
        self.device = dqf.device
        self.wave = wave_size
        self.tick_hops = tick_hops
        self.auto_compact = auto_compact
        self.compact_ratio = compact_ratio
        self.prefetch = prefetch
        # robustness knobs (repro_torch.serving.status): bounded admission
        # with load shedding + per-query deadlines.  ``clock`` is the time
        # source of all deadline/latency bookkeeping — injectable, so
        # degradation tests are deterministic.
        self.engine_cfg = engine_cfg if engine_cfg is not None \
            else EngineConfig()
        self._clock = clock if clock is not None else time.perf_counter
        self._shed_scale = 1.0      # tightened by AdmissionController
        self.queue: collections.deque = collections.deque()
        self.stats = EngineStats(
            latencies_ms=collections.deque(maxlen=latency_window),
            queue_wait_ms=collections.deque(maxlen=latency_window))
        # observability (repro_torch.obs): registry publishing, sampled
        # per-query traces, tick timeline.  ``obs.enabled=False`` is the
        # bare hot path (no registry, no sampling, null spans).
        self.obs = obs if obs is not None else ObsConfig()
        obs_on = bool(self.obs.enabled)
        self._obs_on = obs_on
        self.registry = ((self.obs.registry
                          or getattr(dqf, "registry", None))
                         if obs_on else None)
        self.timeline = Timeline(enabled=obs_on and self.obs.timeline,
                                 capacity=self.obs.timeline_capacity)
        self.traces = TraceLog(self.obs.trace_capacity)
        self._trace_rate = float(self.obs.trace_rate) if obs_on else 0.0
        self._trace_seed = int(self.obs.trace_seed)
        self._lane_trace: list = [None] * wave_size
        self._last_pinned = 0
        self._tick_ann = ((lambda: device_annotation("dqf.wave_tick"))
                          if obs_on else contextlib.nullcontext)
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
        # Fused tick: one launch of the fused hop per tick.  Tiered stores
        # stay composed — their host faults cannot run inside the kernel.
        self._fused = bool(self.cfg.fused) and not dqf.store.tiered
        dqf._sync_device()
        self._d = dqf.store.d
        self._epoch = dqf.store.epoch
        self._remap_epoch = dqf.store.remap_epoch
        self._cap = dqf.store.capacity
        self._tick_fn = self._build_tick()
        self._hot_phase = hot_phase_stacked
        # Perf sentinel: scrape time series, signature accounting on the
        # tick and the hot phase, optional SLO burn-rate alerts with
        # triggered full-rate trace capture.
        self.sentinel = None
        if obs_on and self.obs.sentinel and self.registry is not None:
            self.sentinel = PerfSentinel.from_config(self.obs, self.registry)
            self._tick_fn = self.sentinel.wrap("wave_tick", self._tick_fn)
            self._hot_phase = self.sentinel.wrap("hot_phase_stacked",
                                                 hot_phase_stacked)
            self.sentinel.attach_capture(
                self, capture_ticks=self.obs.capture_ticks,
                bundle_dir=self.obs.capture_dir)
        # per-lane (request_id, t_enqueue, t_seed, tenant_name, tenant_gen,
        # deadline_abs-or-None)
        self._lane_meta = [None] * wave_size
        # per-lane degradation state: a status override set before the
        # lane retires (deadline force-expiry) and a degraded flag
        self._lane_status: list = [None] * wave_size
        self._lane_degraded = [False] * wave_size
        self._results: dict = {}
        self._state = None
        self._draining = False      # refills paused: compaction pending
        self._next_rid = 0          # monotonic: ids never collide

    # ------------------------------------------------------------------ tick
    def _build_tick(self):
        cfg = self.cfg
        tree = self.dqf.tree.arrays if self.dqf.tree is not None else None

        if self._fused:
            def fused_tick(state: bs.BeamState, table, adj_pad, live_pad,
                           queries, hot_first, hot_ratio, evals_done):
                # One launch advances the whole wave ``tick_hops`` hops;
                # the serving tick's immediate-stop tree check is the
                # ``add_step=0`` case of the kernel's deadline logic, with
                # a fresh stop_at each tick.
                hs = kops.fused_hop(
                    bs.to_hop_state(state, evals_done=evals_done),
                    adj_pad, queries, live_pad, table, tree,
                    hot_first, hot_ratio, hops=self.tick_hops,
                    max_hops=cfg.max_hops, k=cfg.k, eval_gap=cfg.eval_gap,
                    add_step=0, tree_depth=cfg.tree_depth)
                return bs.from_hop_state(hs), hs.evals_done

            return fused_tick

        def tick(state: bs.BeamState, table, adj_pad, live_pad, queries,
                 hot_first, hot_ratio, evals_done):
            # ``table`` is the float32 x_pad or a quantized score table
            # view (the wave's PQ LUTs ride along)
            run = composed_tick(cfg, tree, self.tick_hops, lambda s:
                                bs.expand_step(table, adj_pad, queries, s,
                                               live_pad))
            return run(state, evals_done, hot_first, hot_ratio)

        return tick

    # ---------------------------------------------------------------- public
    def submit(self, queries: np.ndarray, *, tenant: str = DEFAULT_TENANT,
               deadline_ms: Optional[float] = None) -> list:
        """Enqueue queries for one tenant; returns their request ids.

        Mixed-tenant waves are the point: interleave ``submit`` calls for
        different tenants and one tick serves them all.

        ``deadline_ms`` bounds each query's end-to-end time (defaulting to
        ``engine_cfg.default_deadline_ms``): a queued request past its
        deadline terminates empty, an in-flight lane force-retires with
        its current best-k — either way ``status="deadline"``.  Every
        submitted id terminates with *some* explicit status: a bounded
        queue (``engine_cfg.max_queue``) sheds per ``shed_policy`` and the
        victim's result lands immediately with ``status="shed"``.
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
        """Advance the engine exactly one tick (open-loop drivers).

        Seeds the wave from the queue on first use; afterwards each call
        runs one tick + retire + refill.  Interleave with ``submit`` to
        serve an arrival process instead of a closed batch.
        """
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
            self._do_compact()      # trigger fired on the final retirements
        wall = self._clock() - t0
        return {"results": self._results, "wall_s": wall,
                "qps": self.stats.qps(wall), "p99_ms": self.stats.p99_ms(),
                "queue_wait_p99_ms": self.stats.queue_wait_p99_ms(),
                "straggled": self.stats.straggled,
                "compactions": self.stats.compactions}

    def scrape(self) -> dict:
        """One flat metrics dict across engine, store and tenants."""
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
        live = sum(m is not None for m in self._lane_meta)
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
               "engine_live_lanes": float(live),
               "engine_wave_size": float(self.wave),
               "engine_occupancy_ratio": live / float(self.wave),
               "engine_traces_recorded": float(self.traces.total),
               "engine_traces_dropped": float(self.traces.dropped)}
        for status, count in s.terminal.items():
            out[f"engine_terminal_status_total{{status={status}}}"] = \
                float(count)
        return out

    # -------------------------------------------------------------- internals
    def _any_live(self) -> bool:
        return any(m is not None for m in self._lane_meta)

    def _maybe_refresh(self):
        """Track the store epoch: re-capture device tables after mutations.

        Inserts and deletes are safe mid-wave (ids are stable, shapes only
        move when capacity grows, and grown state is re-padded); a
        compaction remaps internal ids, so in-flight lanes would retire
        garbage — the engine refuses and asks to drain first.
        """
        st = self.dqf.store
        if st.epoch == self._epoch:
            return
        if st.remap_epoch != self._remap_epoch and self._any_live():
            raise RuntimeError(
                "store compacted while lanes are in flight — drain the "
                "engine before calling compact()")
        self.dqf._sync_device()
        old_cap = self._cap
        if self._state is not None:
            if st.capacity != old_cap:
                self._state = self._grow_state(self._state, old_cap,
                                               st.capacity)
            self._update_table()
        self._cap = st.capacity
        self._epoch = st.epoch
        self._remap_epoch = st.remap_epoch

    @staticmethod
    def _grow_state(state: bs.BeamState, old_cap: int,
                    new_cap: int) -> bs.BeamState:
        """Re-pad wave state after capacity growth (sentinel id moved)."""
        W = state.seen.shape[0]
        grown = torch.zeros((W, new_cap + 1), dtype=torch.bool,
                            device=state.seen.device)
        grown[:, :old_cap] = state.seen[:, :old_cap]  # old sentinel dropped
        grown[:, new_cap] = True
        ids = state.pool.ids
        ids = torch.where(ids == old_cap, new_cap, ids).to(torch.int32)
        return state._replace(pool=state.pool._replace(ids=ids), seen=grown)

    def _zero_state(self) -> bs.BeamState:
        """All-lanes-idle wave state (no scoring — lanes splice in later)."""
        W, L = self.wave, self.cfg.full_pool
        n = self.dqf.store.capacity
        dev = self.device
        z = lambda dtype: torch.zeros((W,), dtype=dtype, device=dev)
        pool = PoolState(
            ids=torch.full((W, L), n, dtype=torch.int32, device=dev),
            dists=torch.full((W, L), INF_DIST, dtype=torch.float32,
                             device=dev),
            expanded=torch.zeros((W, L), dtype=torch.bool, device=dev))
        seen = torch.zeros((W, n + 1), dtype=torch.bool, device=dev)
        seen[:, n] = True
        stats = SearchStats(dist_count=z(torch.int32),
                            update_count=z(torch.int32),
                            hops=z(torch.int32),
                            terminated_early=z(torch.bool))
        return bs.BeamState(pool, seen, stats, z(torch.bool))

    def _init_wave(self):
        self._maybe_refresh()
        W, d = self.wave, self._d
        self._queries = np.zeros((W, d), np.float32)
        self._hot_first = np.zeros((W,), np.float32)
        self._hot_ratio = np.zeros((W,), np.float32)
        self._evals = np.zeros((W,), np.int32)
        self._state = None          # free the old wave before the new one
        self._state = self._zero_state()
        self._update_table()
        self._refill()

    def _update_table(self):
        """Re-snapshot the wave's score table (PQ LUTs follow the queries)."""
        qtable = self.dqf._quant_table()
        if qtable is None:
            self._table = self.dqf._row_table()
        else:
            self._table = qtable.with_queries(self._to_device(self._queries))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _refill(self):
        """Seed free lanes from the queue (hot phase runs per refill batch).

        The hot phase runs over the registry's *stacked* tables: each lane
        reads its own tenant's block by ``tenant_idx``, so one refill batch
        mixes tenants freely.  Requests whose tenant was evicted while they
        sat in the queue (or whose name was re-created as a *different*
        tenant — the ``gen`` check) retire at once with an empty result.
        """
        reg = self.dqf.tenants
        free = [i for i, m in enumerate(self._lane_meta) if m is None]
        reqs = []
        now = self._clock()
        while self.queue and len(reqs) < len(free):
            r = self.queue.popleft()
            name, gen = r[3], r[4]
            if name not in reg or reg.get(name).gen != gen:
                # dead request: drop, keep popping so live ones behind it
                # still fill this wave's free lanes
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
        if not reqs:
            return
        lanes = free[:len(reqs)]
        q = self._to_device(np.stack([r[1] for r in reqs]))
        stk = reg.stacked(self.dqf.store)
        tidx = self._to_device(np.asarray([reg.slot_of(r[3]) for r in reqs],
                                    np.int32))
        with self.timeline.span("refill.hot_phase", lanes=len(reqs)):
            hot_pool, hot_stats = self._hot_phase(
                stk.x, stk.adj, stk.entries, stk.mask, tidx, q,
                pool_size=self.cfg.hot_pool, max_hops=self.cfg.max_hops,
                mode=self.cfg.hot_mode, fused=self._fused)
            hf = hot_features(hot_pool, self.cfg.k)
            seeded = _seed_full_state(hot_pool, stk.ids[tidx.long()],
                                      self.dqf.store.capacity,
                                      self.cfg.full_pool,
                                      self.dqf._dev["live_pad"])
        # Trace sampling is a pure function of (seed, rid): no flags ride
        # the queue, and the hot-phase stats come to the host only when
        # a lane of this refill batch is sampled.
        sampled = [sample_decision(self._trace_seed, r[0], self._trace_rate)
                   for r in reqs]
        if any(sampled):
            hot_hops = hot_stats.hops.cpu().numpy()
            hot_dist = hot_stats.dist_count.cpu().numpy()
        cache = (self.dqf.store.full_phase_cache()
                 if self.dqf.store.tiered else None)
        t_seed = self._clock()
        # splice the new lanes into the wave state on the device: only the
        # refilled rows move
        self._state = _splice_lanes(
            self._state, self._to_device(np.asarray(lanes, np.int64)), seeded)
        first = hf.first.cpu().numpy()
        ratio = hf.first_div_kth.cpu().numpy()
        for j, lane in enumerate(lanes):
            self._queries[lane] = reqs[j][1]
            self._hot_first[lane] = first[j]
            self._hot_ratio[lane] = ratio[j]
            self._evals[lane] = 0
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
                    "tier_miss0": (cache.counters["misses"]
                                   if cache is not None else 0),
                }
            else:
                self._lane_trace[lane] = None
        self._update_table()

    def _terminal_result(self, tenant: str, status: QueryStatus) -> dict:
        """Empty result for a request that never reached a lane
        (tenant vanished / shed at admission / expired while queued)."""
        k = self.cfg.k
        return {"ids": np.full(k, self.dqf.store.capacity, np.int32),
                "dists": np.full(k, np.inf, np.float32),
                "hops": 0, "tenant": tenant, "degraded": False,
                "status": status.value}

    def _retire_batch(self, pool_ids: np.ndarray, pool_dists: np.ndarray,
                      queries: np.ndarray):
        """Final results for all lanes retiring this tick (host side)."""
        return retire_batch(self.dqf.store, self.dqf._rerank_k, self.cfg.k,
                            pool_ids, pool_dists, queries)

    def _tier_begin_tick(self):
        """Tier housekeeping at the tick boundary, then frontier prefetch
        (a tiered store only): pin the blocks in-flight lanes still read,
        apply finished prefetches, admit the hottest missed blocks, and
        request the predicted next-hop blocks while the tick runs."""
        st = self.dqf.store
        if not st.tiered:
            return
        cache = st.full_phase_cache()
        for c in st.tier_caches():      # stale rows from out-of-band
            c.take_degraded_rows()      # searches don't map to lanes
        live = [i for i, m in enumerate(self._lane_meta) if m is not None]
        if live:
            ids = self._state.pool.ids.cpu().numpy()[live]
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
        if self.prefetch and live:
            nxt = bs.next_expansions(self._state, st.capacity).cpu().numpy()
            nxt = nxt[nxt < st.n]
            if nxt.size:
                nbrs = self.dqf.full.adj[nxt]
                cache.prefetch_async(cache.blocks_of_rows(
                    np.concatenate([nxt, nbrs[nbrs >= 0]])))
        self._update_table()

    def _do_compact(self):
        """Drained compaction at a safe tick boundary; serving resumes."""
        self.dqf.compact()
        self.stats.compactions += 1
        self._draining = False
        st = self.dqf.store
        self._epoch = st.epoch
        self._remap_epoch = st.remap_epoch
        self._cap = st.capacity
        # internal ids were remapped; every lane is idle, so the wave
        # state is rebuilt rather than patched
        self._state = self._zero_state()
        self._update_table()

    def _tick(self):
        tl = self.timeline
        with tl.span("tick", tick=self.stats.ticks):
            with tl.span("tick.housekeeping"):
                self._maybe_refresh()
            with tl.span("tick.tier"):
                self._tier_begin_tick()
            with tl.span("tick.launch", hops=self.tick_hops):
                with self._tick_ann():
                    state, evals = self._tick_fn(
                        self._state, self._table, self.dqf._dev["adj_pad"],
                        self.dqf._dev["live_pad"], self._to_device(self._queries),
                        self._to_device(self._hot_first),
                        self._to_device(self._hot_ratio), self._to_device(self._evals))
                    if tl.enabled:      # make the span cover device time
                        _device_sync(self.device)
            self._state = state
            self._evals = evals.cpu().numpy().copy()   # refill mutates it
            self.stats.ticks += 1
            active = state.active.cpu().numpy().copy()  # deadlines clear it
            now = self._clock()
            # degraded tier reads: the tick's host fetches record the batch
            # rows (== wave lanes here) whose blocks exhausted retries
            if self.dqf.store.tiered:
                for c in self.dqf.store.tier_caches():
                    for row in c.take_degraded_rows():
                        if row < self.wave \
                                and self._lane_meta[row] is not None:
                            self._lane_degraded[row] = True
            # per-query deadlines: lanes past deadline are force-expired
            # and retire this tick with their current best-k
            expired = [lane for lane, meta in enumerate(self._lane_meta)
                       if meta is not None and active[lane]
                       and meta[5] is not None and now >= meta[5]]
            if expired:
                state.active[self._to_device(np.asarray(expired, np.int64))] = \
                    False
                active[expired] = False
                for lane in expired:
                    self._lane_status[lane] = QueryStatus.DEADLINE
            retiring = [lane for lane, meta in enumerate(self._lane_meta)
                        if meta is not None and not active[lane]]
            with tl.span("tick.retire", retiring=len(retiring)):
                self._retire_lanes(state, retiring, now)
            # Background compaction: once the tombstone ratio trips the
            # trigger, stop refilling, let live lanes drain, compact at
            # the safe boundary, then resume.
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

    def _retire_lanes(self, state: bs.BeamState, retiring: list,
                      now: float) -> None:
        """Harvest results + stats for every lane retiring this tick."""
        if not retiring:
            return
        # one vectorized rerank pass for every lane retiring this tick
        pool_ids = state.pool.ids.cpu().numpy()
        pool_dists = state.pool.dists.cpu().numpy()
        batch_ids, batch_dists = self._retire_batch(
            pool_ids[retiring], pool_dists[retiring],
            self._queries[retiring])
        # whole-array transfers once per retiring tick (never per lane);
        # the extra stats arrays move only when a sampled lane retires
        hops_all = state.stats.hops.cpu().numpy()
        if any(self._lane_trace[ln] is not None for ln in retiring):
            dist_all = state.stats.dist_count.cpu().numpy()
            upd_all = state.stats.update_count.cpu().numpy()
            term_all = state.stats.terminated_early.cpu().numpy()
        cache = (self.dqf.store.full_phase_cache()
                 if self.dqf.store.tiered else None)
        for j, lane in enumerate(retiring):
            rid, t_in, t_seed, tenant, gen, _ = self._lane_meta[lane]
            ids, dists = batch_ids[j], batch_dists[j]
            hops = int(hops_all[lane])
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
                miss0 = tr.pop("tier_miss0")
                tr.update(
                    queue_wait_ms=(t_seed - t_in) * 1e3,
                    service_ms=service_ms,
                    total_ms=(now - t_in) * 1e3,
                    full_hops=hops,
                    full_dist_evals=int(dist_all[lane]),
                    full_updates=int(upd_all[lane]),
                    terminated_early=bool(term_all[lane]),
                    straggled=straggled,
                    rerank_k=int(self.dqf._rerank_k),
                    ticks_in_flight=self.stats.ticks - tr["seed_tick"],
                    tier_misses=(cache.counters["misses"] - miss0
                                 if cache is not None else 0),
                    pinned_blocks=self._last_pinned)
                self.traces.add(tr)
                self._lane_trace[lane] = None
            self._lane_meta[lane] = None
            self._lane_status[lane] = None
            self._lane_degraded[lane] = False
            # Preference feedback: the retiring lane's results feed its
            # tenant's counter, and a due Alg-2 clock rebuilds that
            # tenant's hot index (safe mid-wave: hot tables are only read
            # at refill).  Evicted-mid-flight tenants retire silently; the
            # ``gen`` check keeps a re-created namesake's counter clean.
            if tenant in self.dqf.tenants \
                    and self.dqf.tenants.get(tenant).gen == gen:
                self.dqf.record(ids[None, :], tenant=tenant)
                self.dqf.maybe_rebuild_hot(tenant=tenant)
