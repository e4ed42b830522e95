"""Batched graph beam search (paper §4.3.1, Algorithm 3) in PyTorch.

Every query is a lane: a fixed-size sorted candidate pool per lane, one
expansion per lane per step, dense gathers for neighbor ids and vectors,
and a dense per-lane ``seen`` bitmap.  Lanes that exhaust their pool (or
are stopped by the decision tree, see :mod:`repro_torch.core.dynamic_search`)
go inactive; the loop ends when every lane is done.

Conventions (see :mod:`repro_torch.core.types`): ids are global rows with
sentinel ``n``; ``x_pad`` has an extra huge-valued row ``n``; ``adj_pad``
has an extra row ``n`` of sentinels, so expanding the sentinel is a no-op.
The ``seen`` bitmap of a :class:`BeamState` is updated in place by
:func:`expand_step` and the fused loop.

Tables may be shared ``(n+1, ·)``, per lane ``(B, n+1, ·)``, or a
:class:`LaneTable` — lane b reads block ``lane_idx[b]`` of a stacked
``(T, n+1, ·)`` table without the per-lane copy ever being made (the
stacked multi-tenant hot phase, the stacked shards of
:mod:`repro_torch.sharding`); entries may be shared ``(E,)`` or per lane
``(B, E)``; liveness shared ``(n+1,)`` or a :class:`LaneTable` over a
stacked ``(T, n+1)`` table (:func:`live_at`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import HopState, first_true, sq_l2

from .types import INF_DIST, INT_MAX, PoolState, SearchResult, SearchStats

__all__ = [
    "BeamState", "init_state", "expand_step", "beam_loop", "beam_search",
    "pad_dataset", "pad_adjacency", "table_n", "as_view", "score_rows",
    "to_hop_state", "from_hop_state", "fused_beam_loop", "topk_from_pool",
    "LaneTable", "next_expansions", "live_at",
]


class BeamState(NamedTuple):
    pool: PoolState            # (B, L)
    seen: torch.Tensor         # (B, n+1) bool — ever inserted into pool
    stats: SearchStats         # (B,) counters
    active: torch.Tensor       # (B,) bool


class LaneTable(NamedTuple):
    """Lane b's table is block ``lane_idx[b]`` of a stacked table.

    Rows are gathered by ``(lane_idx[b], id)`` where they are read, so a
    wave over a ``(T, n+1, w)`` stack never materializes the ``(B, n+1,
    w)`` per-lane copy.  Scores like a score table (``n``,
    ``gather_score``), exactly in float32.  Over a ``(T, n+1)`` table
    (liveness, id maps) ``rows`` gives lane b's entries ``(B, C)``.
    """

    table: torch.Tensor      # (T, n+1, w) or (T, n+1)
    lane_idx: torch.Tensor   # (B,) int64

    @property
    def n(self) -> int:
        return self.table.shape[1] - 1

    def rows(self, cols: torch.Tensor) -> torch.Tensor:
        """(B, C, w): lane b's rows ``cols[b, c]``."""
        return self.table[self.lane_idx[:, None], cols.long()]

    def gather_score(self, queries: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
        return sq_l2(self.rows(cols), queries[:, None, :])


def live_at(live_pad, ids: torch.Tensor) -> torch.Tensor:
    """(B, C) liveness of lane b's ids ``ids[b, c]``: from a shared
    ``(n+1,)`` table, or lane b's block of a :class:`LaneTable` over a
    stacked ``(T, n+1)`` one."""
    if isinstance(live_pad, LaneTable):
        return live_pad.rows(ids)
    return live_pad[ids.long()]


def pad_dataset(x: torch.Tensor, pad_value: float = 1e9) -> torch.Tensor:
    """Append the sentinel row ``n`` of huge values."""
    pad = torch.full((1, x.shape[1]), pad_value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=0)


def pad_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """Append sentinel row ``n`` whose neighbors are all the sentinel."""
    n = adj.shape[0]
    pad = torch.full((1, adj.shape[1]), n, dtype=adj.dtype, device=adj.device)
    return torch.cat([adj, pad], dim=0)


def table_n(x_pad) -> int:
    """Real row count of a padded ``(n+1, d)`` vector table *or* of a
    quantized score table (:mod:`repro_torch.quant`)."""
    if isinstance(x_pad, torch.Tensor):
        return x_pad.shape[-2] - 1
    return x_pad.n


def as_view(x_pad, queries: torch.Tensor):
    """Bind per-query search state (the PQ LUTs); identity otherwise."""
    if isinstance(x_pad, torch.Tensor):
        return x_pad
    return x_pad.with_queries(queries)


def score_rows(x_pad, queries: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """(B, C) squared L2 of query b vs table row ``cols[b, c]``.

    Exact float32 for a plain tensor table, shared ``(n+1, d)`` or per
    lane ``(B, n+1, d)``; a score table scores itself (from its codes, or
    a :class:`LaneTable` from its stacked rows).
    """
    if isinstance(x_pad, torch.Tensor):
        if x_pad.dim() == 3:                                 # per lane
            rows = torch.arange(cols.shape[0], device=cols.device)
            g = x_pad[rows[:, None], cols.long()]
        else:
            g = x_pad[cols.long()]
        return sq_l2(g, queries[:, None, :])
    return x_pad.gather_score(queries, cols)


def _adj_rows(adj_pad, p: torch.Tensor) -> torch.Tensor:
    """(B, R) adjacency row ``p[b]`` of lane b's graph."""
    if isinstance(adj_pad, LaneTable):
        return adj_pad.table[adj_pad.lane_idx, p.long()]
    if adj_pad.dim() == 3:                                   # per lane
        return adj_pad[torch.arange(p.shape[0], device=p.device), p.long()]
    return adj_pad[p.long()]


def _merge_pool(pool: PoolState, cand_ids, cand_dists, cand_expanded,
                lane_update: torch.Tensor) -> tuple[PoolState, torch.Tensor]:
    """Merge candidates into the sorted pool; returns new pool + #insertions.

    ``lane_update`` masks whole lanes (inactive lanes keep their pool).
    """
    L = pool.ids.shape[1]
    worst = pool.dists[:, -1]
    inserted = (cand_dists < worst[:, None]).sum(dim=1, dtype=torch.int32)
    ids = torch.cat([pool.ids, cand_ids], dim=1)
    dists = torch.cat([pool.dists, cand_dists], dim=1)
    exp = torch.cat([pool.expanded, cand_expanded], dim=1)
    order = torch.sort(dists, dim=1, stable=True).indices[:, :L]
    keep = lane_update[:, None]
    merged = PoolState(
        torch.where(keep, ids.gather(1, order), pool.ids),
        torch.where(keep, dists.gather(1, order), pool.dists),
        torch.where(keep, exp.gather(1, order), pool.expanded))
    return merged, torch.where(lane_update, inserted, 0)


def init_state(x_pad, queries: torch.Tensor, entries: torch.Tensor,
               pool_size: int,
               live_pad: Optional[torch.Tensor] = None) -> BeamState:
    """Seed every lane's pool with the entry points (Alg 3 line 1).

    ``entries`` is shared ``(E,)`` or per lane ``(B, E)``; per-lane entry
    slots equal to the sentinel (stacked-table padding) score INF and
    never enter the frontier.
    """
    n = table_n(x_pad)
    B = queries.shape[0]
    E = entries.shape[-1]
    dev = queries.device
    if E > pool_size:
        raise ValueError(f"entries ({E}) exceed pool size ({pool_size})")
    if entries.dim() == 1:
        ids0 = entries[None, :].expand(B, E).to(torch.int32)
    else:
        ids0 = entries.to(torch.int32)
    d2 = score_rows(x_pad, queries, ids0)
    d2 = torch.where(ids0 == n, INF_DIST, d2)
    if live_pad is not None:
        d2 = torch.where(live_at(live_pad, ids0), d2, INF_DIST)
    order = torch.sort(d2, dim=1, stable=True).indices
    ids0 = ids0.gather(1, order)
    d2 = d2.gather(1, order)
    pad = pool_size - E
    pool = PoolState(
        ids=torch.cat([ids0, torch.full((B, pad), n, dtype=torch.int32,
                                        device=dev)], dim=1),
        dists=torch.cat([d2, torch.full((B, pad), INF_DIST,
                                        dtype=torch.float32, device=dev)],
                        dim=1),
        expanded=torch.zeros((B, pool_size), dtype=torch.bool, device=dev))
    seen = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    seen[torch.arange(B, device=dev)[:, None], ids0.long()] = True
    seen[:, n] = True
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    stats = SearchStats(
        dist_count=(ids0 != n).sum(dim=1, dtype=torch.int32),
        update_count=zeros, hops=zeros.clone(),
        terminated_early=torch.zeros((B,), dtype=torch.bool, device=dev))
    return BeamState(pool, seen, stats,
                     torch.ones((B,), dtype=torch.bool, device=dev))


def expand_step(x_pad, adj_pad: torch.Tensor, queries: torch.Tensor,
                state: BeamState,
                live_pad: Optional[torch.Tensor] = None) -> BeamState:
    """One expansion per active lane (Alg 3 lines 4-9, batched).

    With ``live_pad``, tombstoned neighbors are treated like sentinels.
    ``state.seen`` is updated in place.
    """
    n = table_n(x_pad)
    B = state.pool.ids.shape[0]
    rows = torch.arange(B, device=queries.device)

    unexp = (~state.pool.expanded) & (state.pool.ids != n)
    lane = state.active & unexp.any(dim=1)
    slot = first_true(unexp)
    p = torch.where(lane, state.pool.ids[rows, slot], n)
    expanded = state.pool.expanded.clone()
    expanded[rows, slot] = state.pool.expanded[rows, slot] | lane

    nbrs = _adj_rows(adj_pad, p)                             # (B, R)
    already = state.seen.gather(1, nbrs.long())
    valid = (nbrs != n) & (~already) & lane[:, None]
    if live_pad is not None:
        valid &= live_at(live_pad, nbrs)
    cols = torch.where(valid, nbrs, n)
    seen = state.seen
    seen[rows[:, None], cols.long()] = True

    d2 = score_rows(x_pad, queries, cols)
    d2 = torch.where(valid, d2, INF_DIST)

    pool = PoolState(state.pool.ids, state.pool.dists, expanded)
    pool, inserted = _merge_pool(pool, cols.to(torch.int32), d2,
                                 torch.zeros_like(valid), lane)
    stats = SearchStats(
        dist_count=state.stats.dist_count
        + torch.where(lane, valid.sum(dim=1, dtype=torch.int32), 0),
        update_count=state.stats.update_count + inserted,
        hops=state.stats.hops + lane.to(torch.int32),
        terminated_early=state.stats.terminated_early)
    still = ((~pool.expanded) & (pool.ids != n)).any(dim=1)
    return BeamState(pool, seen, stats, state.active & still)


def next_expansions(state: BeamState, sentinel: int) -> torch.Tensor:
    """(B,) id each active lane expands next (``sentinel`` when none):
    :func:`expand_step`'s frontier pick, for a host that prefetches the
    next hop's rows while the current one runs."""
    unexp = (~state.pool.expanded) & (state.pool.ids != sentinel)
    has = unexp.any(dim=1) & state.active
    rows = torch.arange(state.pool.ids.shape[0], device=unexp.device)
    return torch.where(has, state.pool.ids[rows, first_true(unexp)],
                       sentinel)


def to_hop_state(state: BeamState, evals_done=None, stop_at=None) -> HopState:
    """Flatten a :class:`BeamState` into the fused kernel's ``HopState``."""
    B = state.active.shape[0]
    dev = state.active.device
    if evals_done is None:
        evals_done = torch.zeros((B,), dtype=torch.int32, device=dev)
    if stop_at is None:
        stop_at = torch.full((B,), INT_MAX, dtype=torch.int32, device=dev)
    return HopState(
        ids=state.pool.ids, dists=state.pool.dists,
        expanded=state.pool.expanded, seen=state.seen, active=state.active,
        dist_count=state.stats.dist_count,
        update_count=state.stats.update_count, hops=state.stats.hops,
        terminated=state.stats.terminated_early, evals_done=evals_done,
        stop_at=stop_at)


def from_hop_state(hs: HopState) -> BeamState:
    """Rebundle a fused-kernel ``HopState`` into a :class:`BeamState`."""
    return BeamState(
        pool=PoolState(ids=hs.ids, dists=hs.dists, expanded=hs.expanded),
        seen=hs.seen,
        stats=SearchStats(dist_count=hs.dist_count,
                          update_count=hs.update_count, hops=hs.hops,
                          terminated_early=hs.terminated),
        active=hs.active)


def fused_beam_loop(x_pad, adj_pad, queries, state: BeamState,
                    max_hops: int, live_pad: Optional[torch.Tensor] = None,
                    *, fused_hops: int = 8, tree=None, hot=None, k: int = 1,
                    eval_gap: int = 1, add_step: int = 0,
                    tree_depth: int = 1) -> BeamState:
    """:func:`beam_loop` through the fused wave-hop kernel.

    On the card one :func:`repro_torch.kernels.ops.fused_hop` launch of
    ``max(max_hops, 1)`` hops carries every lane to retirement (a lane hops
    at most that often: an active lane expands once before the cap
    applies, as in :func:`beam_loop`; an inactive lane leaves the kernel's
    loop), so the host never waits between hops.  On the CPU the plain version runs
    ``fused_hops`` hops at a time until no lane is active.  Inactive lanes
    are exact no-ops, so both equal the composed per-hop loop bit for bit.
    With ``tree`` and ``hot`` (the frozen hot-phase features) the kernel
    also runs the decision-tree check of the dynamic full phase.  A
    :class:`LaneTable` pair (``x_pad``, ``adj_pad``) runs through the
    kernel's per-lane table base, with ``live_pad`` shared ``(n+1,)`` or
    a :class:`LaneTable` over the stacked ``(T, n+1)`` liveness.
    """
    hf, hr = (hot.first.contiguous(), hot.first_div_kth.contiguous()) \
        if hot is not None else (None, None)
    lane_base = None
    if isinstance(x_pad, LaneTable):
        if not isinstance(adj_pad, LaneTable):
            raise TypeError("a LaneTable search needs a LaneTable adjacency")
        lane_base = (x_pad.lane_idx * (x_pad.n + 1)).to(torch.int32)
        x_pad, adj_pad = x_pad.table, adj_pad.table
        if isinstance(live_pad, LaneTable):
            live_pad = live_pad.table
    elif isinstance(live_pad, LaneTable):
        raise TypeError("a stacked liveness table needs LaneTable tables")
    hs = to_hop_state(state)
    kw = dict(max_hops=max_hops, k=k, eval_gap=eval_gap, add_step=add_step,
              tree_depth=tree_depth, lane_base=lane_base)
    if kops._device_type(hs.ids) == "cuda":
        hs = kops.fused_hop(hs, adj_pad, queries, live_pad, x_pad, tree, hf,
                            hr, hops=max(max_hops, 1), **kw)
    else:
        while bool(hs.active.any()):
            hs = kops.fused_hop(hs, adj_pad, queries, live_pad, x_pad, tree,
                                hf, hr, hops=fused_hops, **kw)
    return from_hop_state(hs)


def beam_loop(x_pad, adj_pad, queries, state: BeamState, max_hops: int,
              live_pad: Optional[torch.Tensor] = None) -> BeamState:
    """Run expansions until every lane has exhausted its pool or hops."""
    s = state
    while bool(s.active.any()):
        s = expand_step(x_pad, adj_pad, queries, s, live_pad)
        s = s._replace(active=s.active & (s.stats.hops < max_hops))
    return s


def topk_from_pool(pool: PoolState, k: int):
    """Pool is sorted: the k best are its prefix (Alg 3 line 11)."""
    return pool.ids[:, :k], pool.dists[:, :k]


def beam_search(x_pad: torch.Tensor, adj_pad: torch.Tensor,
                entries: torch.Tensor, queries: torch.Tensor, *,
                pool_size: int, k: int, max_hops: int = 512,
                live_pad: Optional[torch.Tensor] = None,
                fused: bool = False, fused_hops: int = 8) -> SearchResult:
    """Traditional beam search (Algorithm 3), batched over queries.

    ``fused=True`` runs the expansion loop through the fused wave-hop
    kernel (bit-identical results).
    """
    state = init_state(x_pad, queries, entries, pool_size, live_pad)
    if fused:
        state = fused_beam_loop(x_pad, adj_pad, queries, state, max_hops,
                                live_pad, fused_hops=fused_hops)
    else:
        state = beam_loop(x_pad, adj_pad, queries, state, max_hops,
                          live_pad=live_pad)
    ids, dists = topk_from_pool(state.pool, k)
    return SearchResult(ids=ids, dists=dists, stats=state.stats)
