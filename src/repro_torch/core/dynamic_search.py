"""Dynamic dual-index search with decision-tree early termination (Alg 4).

Phase 1 searches the hot index — either the paper's NSSG subgraph
(``hot_mode="graph"``) or the brute-force top-k scorer over the hot rows
(``hot_mode="mxu"``, :func:`repro_torch.kernels.ops.fused_topk_l2`).  Its
pool seeds phase 2 over the full graph, where every lane re-evaluates the
decision tree each time its (full-phase) distance count crosses a multiple
of ``eval_gap``; a stop verdict (+ an optional ``add_step`` grace) retires
the lane.  Over a quantized Full Index phase 2 scans the codes and the
pool's head is re-scored exactly (``_exact_rerank``).

All ids in phase 2 are global.  The hot graph uses local ids 0..H-1 with
its own sentinel H; ``hot_ids_pad`` maps local→global.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import sq_l2

from . import beam_search as bs
from .decision_tree import TreeArrays, predict
from .features import feature_matrix, hot_features
from .types import (INF_DIST, INT_MAX, HotFeatures, PoolState, SearchResult,
                    SearchStats)

__all__ = ["dynamic_search", "search_from_hot", "hot_phase",
           "hot_phase_graph", "hot_phase_mxu", "hot_phase_stacked",
           "DynamicState"]


class DynamicState(NamedTuple):
    beam: bs.BeamState
    evals_done: torch.Tensor   # (B,) int32 — DT evaluations performed
    stop_at: torch.Tensor      # (B,) int32 — dist_count deadline (add_step)


def _hot_loop(x, adj, queries, state: bs.BeamState, max_hops: int,
              fused: bool) -> bs.BeamState:
    """The hot phase's expansions: through the fused hop (f32, no tree, no
    liveness; one launch on the card) or the composed per-hop loop, the
    reference's mirror.  Both give the same bits."""
    if fused:
        return bs.fused_beam_loop(x, adj, queries, state, max_hops)
    return bs.beam_loop(x, adj, queries, state, max_hops)


def hot_phase_graph(x_hot_pad, adj_hot_pad, hot_entries, queries, *,
                    pool_size: int, max_hops: int, fused: bool = False):
    """Phase 1, paper-faithful: beam search over the hot NSSG."""
    state = bs.init_state(x_hot_pad, queries, hot_entries, pool_size)
    state = _hot_loop(x_hot_pad, adj_hot_pad, queries, state, max_hops,
                      fused)
    return state.pool, state.stats


def hot_phase_mxu(x_hot, queries, *, pool_size: int):
    """Phase 1, beyond-paper: exact brute-force top-k over the hot rows.

    The tensors' device picks the scorer: the CUDA kernel on the card, its
    plain version on the CPU.
    """
    H = x_hot.shape[0]
    B = queries.shape[0]
    dev = queries.device
    dists, ids = kops.fused_topk_l2(queries, x_hot, k=pool_size)
    pool = PoolState(
        ids=ids, dists=dists,
        expanded=torch.zeros((B, pool_size), dtype=torch.bool, device=dev))
    zeros = lambda: torch.zeros((B,), dtype=torch.int32, device=dev)
    stats = SearchStats(
        dist_count=torch.full((B,), H, dtype=torch.int32, device=dev),
        update_count=zeros(), hops=zeros(),
        terminated_early=torch.zeros((B,), dtype=torch.bool, device=dev))
    return pool, stats


_STACKED_CHUNK = 1 << 25    # (lanes, H, d) elements per mxu scoring chunk


def hot_phase_stacked(xs_hot, adjs_hot, entries_hot, mask_hot, tenant_idx,
                      queries, *, pool_size: int, max_hops: int,
                      mode: str = "graph", fused: bool = False):
    """Phase 1 over the *stacked* per-tenant hot tables (``repro_torch.
    tenancy``).

    ``xs_hot (T, H+1, d)``, ``adjs_hot (T, H+1, R)``, ``entries_hot
    (T, E)`` and ``mask_hot (T, H+1)`` hold every tenant's hot index;
    ``tenant_idx (B,)`` routes each query to its tenant's block, so a
    mixed-tenant batch runs as one search.  Lane b reads its rows and
    adjacency by ``(tenant_idx[b], local id)`` where it uses them
    (:class:`~repro_torch.core.beam_search.LaneTable`); the per-lane
    ``(B, H+1, ·)`` copies of the reference are never made; with
    ``fused`` the graph mode runs through the fused hop's per-lane table
    base.  Returns the local-id pool and stats, as :func:`hot_phase`
    (local sentinel = H).

    ``mode="mxu"`` brute-forces each lane against its tenant's hot rows as
    a plain batched sum of squares (the reference's ``jnp.sum``, here in
    :func:`~repro_torch.kernels.ref.sq_l2` order), one tenant and a chunk
    of its lanes at a time; ties go to the smaller local id.
    """
    tidx = tenant_idx.long()
    ent = entries_hot[tidx]                                # (B, E)
    if mode == "graph":
        x = bs.LaneTable(xs_hot, tidx)
        state = bs.init_state(x, queries, ent, pool_size)
        state = _hot_loop(x, bs.LaneTable(adjs_hot, tidx), queries, state,
                          max_hops, fused)
        return state.pool, state.stats
    B = queries.shape[0]
    H = xs_hot.shape[1] - 1
    dev = queries.device
    valid = mask_hot[tidx][:, :H]                          # (B, H)
    d2 = torch.empty((B, H), dtype=torch.float32, device=dev)
    step = max(1, _STACKED_CHUNK // max(H * xs_hot.shape[2], 1))
    for t in torch.unique(tidx).tolist():
        lanes = torch.nonzero(tidx == t).flatten()
        for s in range(0, lanes.numel(), step):
            chunk = lanes[s:s + step]
            d2[chunk] = sq_l2(xs_hot[t, None, :H, :],
                              queries[chunk, None, :])
    d2 = torch.where(valid, d2, INF_DIST)
    take = min(pool_size, H)
    order = torch.sort(d2, dim=1, stable=True).indices[:, :take]
    dists = d2.gather(1, order)
    ids = torch.where(dists >= INF_DIST, H, order).to(torch.int32)
    pad = pool_size - take
    pool = PoolState(
        ids=torch.cat([ids, torch.full((B, pad), H, dtype=torch.int32,
                                       device=dev)], dim=1),
        dists=torch.cat([dists, torch.full((B, pad), INF_DIST,
                                           dtype=torch.float32, device=dev)],
                        dim=1),
        expanded=torch.zeros((B, pool_size), dtype=torch.bool, device=dev))
    zeros = lambda: torch.zeros((B,), dtype=torch.int32, device=dev)
    stats = SearchStats(
        dist_count=valid.sum(dim=1, dtype=torch.int32),
        update_count=zeros(), hops=zeros(),
        terminated_early=torch.zeros((B,), dtype=torch.bool, device=dev))
    return pool, stats


def _exact_rerank(x_pad, queries, pool: PoolState, *, k: int,
                  rerank_k: int, live_pad: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-score the pool's best ``rerank_k`` entries in float32, keep top-k.

    The quantized full phase ranks the pool by approximate distances; this
    recovers the exact order among the head of the pool.
    """
    n = bs.table_n(x_pad)
    rr = min(max(rerank_k, k), pool.ids.shape[1])
    ids = pool.ids[:, :rr]
    d2 = bs.score_rows(x_pad, queries, ids)
    d2 = torch.where(ids == n, INF_DIST, d2)
    if live_pad is not None:
        d2 = torch.where(bs.live_at(live_pad, ids), d2, INF_DIST)
    order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    return ids.gather(1, order), d2.gather(1, order)


def hot_phase(x_hot_pad, adj_hot_pad, hot_entries, queries, *, pool_size,
              max_hops, mode: str = "graph", fused: bool = False):
    """Phase 1 by ``mode`` ("graph" or "mxu"); ``fused`` runs the graph
    mode through the fused hop."""
    if mode == "graph":
        return hot_phase_graph(x_hot_pad, adj_hot_pad, hot_entries, queries,
                               pool_size=pool_size, max_hops=max_hops,
                               fused=fused)
    return hot_phase_mxu(x_hot_pad[:-1], queries, pool_size=pool_size)


def _seed_full_state(hot_pool: PoolState, hot_ids_pad: torch.Tensor,
                     n: int, pool_size: int,
                     live_pad: Optional[torch.Tensor] = None) -> bs.BeamState:
    """Map the hot pool to global ids and seed the phase-2 state.

    Alg 4 line 11: all entries arrive unexpanded; line 12: counters reset.
    ``live_pad`` masks hot results whose global row was tombstoned: shared
    ``(n+1,)``, or a :class:`~repro_torch.core.beam_search.LaneTable` over
    stacked ``(T, n+1)`` tables.  ``hot_ids_pad`` is the shared ``(H+1,)``
    local→global map, or per-lane ``(B, H+1)`` rows gathered from a
    stacked table.
    """
    B, s_l = hot_pool.ids.shape
    dev = hot_pool.ids.device
    if hot_ids_pad.dim() == 2:                              # per lane
        gids = hot_ids_pad.gather(1, hot_pool.ids.long())
    else:
        gids = hot_ids_pad[hot_pool.ids.long()]
    gids = torch.where(hot_pool.dists >= INF_DIST, n, gids).to(torch.int32)
    dists = hot_pool.dists
    if live_pad is not None:
        dead = ~bs.live_at(live_pad, gids)
        gids = torch.where(dead, n, gids)
        dists = torch.where(dead, INF_DIST, dists)
    take = min(s_l, pool_size)
    order = torch.sort(dists, dim=1, stable=True).indices[:, :take]
    gids = gids.gather(1, order)
    gdist = dists.gather(1, order)
    pad = pool_size - take
    pool = PoolState(
        ids=torch.cat([gids, torch.full((B, pad), n, dtype=torch.int32,
                                        device=dev)], dim=1),
        dists=torch.cat([gdist, torch.full((B, pad), INF_DIST,
                                           dtype=torch.float32, device=dev)],
                        dim=1),
        expanded=torch.zeros((B, pool_size), dtype=torch.bool, device=dev))
    seen = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    seen[torch.arange(B, device=dev)[:, None], pool.ids.long()] = True
    seen[:, n] = True
    zeros = lambda: torch.zeros((B,), dtype=torch.int32, device=dev)
    stats = SearchStats(
        dist_count=zeros(), update_count=zeros(), hops=zeros(),
        terminated_early=torch.zeros((B,), dtype=torch.bool, device=dev))
    return bs.BeamState(pool, seen, stats,
                        torch.ones((B,), dtype=torch.bool, device=dev))


def _full_phase(x_pad, adj_pad, queries, state: bs.BeamState,
                hot: HotFeatures, tree: Optional[TreeArrays], *,
                k: int, eval_gap: int, add_step: int, tree_depth: int,
                max_hops: int,
                live_pad: Optional[torch.Tensor] = None) -> bs.BeamState:
    """Phase 2 with periodic decision-tree termination checks."""
    B = queries.shape[0]
    dev = queries.device
    ds = DynamicState(
        beam=state,
        evals_done=torch.zeros((B,), dtype=torch.int32, device=dev),
        stop_at=torch.full((B,), INT_MAX, dtype=torch.int32, device=dev))
    while bool(ds.beam.active.any()):
        s = bs.expand_step(x_pad, adj_pad, queries, ds.beam, live_pad)
        s = s._replace(active=s.active & (s.stats.hops < max_hops))
        evals_done, stop_at = ds.evals_done, ds.stop_at
        if tree is not None:
            due = (s.stats.dist_count // eval_gap) > evals_done
            due = due & s.active
            feats = feature_matrix(hot, s.pool, s.stats, k)
            verdict_stop = predict(tree, feats, tree_depth) < 0.5
            newly = due & verdict_stop & (stop_at == INT_MAX)
            stop_at = torch.where(newly, s.stats.dist_count + add_step,
                                  stop_at)
            evals_done = torch.where(due, s.stats.dist_count // eval_gap,
                                     evals_done)
            stop_now = s.stats.dist_count >= stop_at
            s = s._replace(
                active=s.active & ~stop_now,
                stats=s.stats._replace(
                    terminated_early=s.stats.terminated_early
                    | (stop_now & s.active)))
        ds = DynamicState(s, evals_done, stop_at)
    return ds.beam


def dynamic_search(
    x_pad: torch.Tensor,           # (n+1, d) padded dataset
    adj_pad: torch.Tensor,         # (n+1, R) padded full adjacency
    x_hot_pad: torch.Tensor,       # (H+1, d) padded hot vectors
    adj_hot_pad: torch.Tensor,     # (H+1, Rh) padded hot adjacency
    hot_ids_pad: torch.Tensor,     # (H+1,) local→global (pad slot → n)
    hot_entries: torch.Tensor,     # (E,) local entry ids into the hot graph
    tree: Optional[TreeArrays],
    queries: torch.Tensor,         # (B, d)
    *,
    k: int,
    hot_pool_size: int,
    full_pool_size: int,
    eval_gap: int,
    add_step: int,
    tree_depth: int,
    max_hops: int = 512,
    hot_mode: str = "graph",
    qtable=None,
    rerank_k: int = 0,
    live_pad: Optional[torch.Tensor] = None,
    fused: bool = False,
    fused_hops: int = 8,
) -> tuple[SearchResult, SearchStats, HotFeatures]:
    """Algorithm 4 end to end. Returns (result, hot_phase_stats, hot_feats).

    ``result.stats`` covers the full phase only (after the line-12 reset).
    When ``qtable`` is given, phase 2 scores against the compressed codes
    (the hot phase stays float32) and, with ``rerank_k > 0``, the pool's
    head is re-scored exactly from ``x_pad`` before the final top-k.
    ``fused=True`` runs both phases' expansions through the fused wave-hop
    kernel (on the card one launch a phase), with bit-identical results.
    The tensors' device picks kernel or plain version.
    """
    hot_pool, hot_stats = hot_phase(
        x_hot_pad, adj_hot_pad, hot_entries, queries,
        pool_size=hot_pool_size, max_hops=max_hops, mode=hot_mode,
        fused=fused)
    res, hfeats = search_from_hot(
        x_pad, adj_pad, hot_pool, hot_ids_pad, tree, queries, k=k,
        full_pool_size=full_pool_size, eval_gap=eval_gap, add_step=add_step,
        tree_depth=tree_depth, max_hops=max_hops, qtable=qtable,
        rerank_k=rerank_k, live_pad=live_pad, fused=fused,
        fused_hops=fused_hops)
    return res, hot_stats, hfeats


def search_from_hot(x_pad, adj_pad, hot_pool: PoolState,
                    hot_ids_pad: torch.Tensor, tree: Optional[TreeArrays],
                    queries: torch.Tensor, *, k: int, full_pool_size: int,
                    eval_gap: int, add_step: int, tree_depth: int,
                    max_hops: int = 512, qtable=None, rerank_k: int = 0,
                    live_pad=None, fused: bool = False, fused_hops: int = 8
                    ) -> tuple[SearchResult, HotFeatures]:
    """Algorithm 4 after its hot phase: the hot features, the seed, the
    full phase with its tree checks, the top-k (or the exact rerank).
    Returns (result, hot_feats).

    :func:`dynamic_search` runs it after :func:`hot_phase`.  A stacked
    search runs it over stacked tables: ``x_pad``, ``adj_pad`` and
    ``live_pad`` each a :class:`~repro_torch.core.beam_search.LaneTable`,
    ``hot_ids_pad`` per-lane ``(B, H+1)`` rows, ids local to each lane's
    block (sentinel n).
    """
    n = bs.table_n(x_pad)
    hfeats = hot_features(hot_pool, k)
    state = _seed_full_state(hot_pool, hot_ids_pad, n, full_pool_size,
                             live_pad)
    table = x_pad if qtable is None else qtable.with_queries(queries)
    if fused:
        state = bs.fused_beam_loop(
            table, adj_pad, queries, state, max_hops, live_pad,
            fused_hops=fused_hops, tree=tree, hot=hfeats, k=k,
            eval_gap=eval_gap, add_step=add_step, tree_depth=tree_depth)
    else:
        state = _full_phase(
            table, adj_pad, queries, state, hfeats, tree, k=k,
            eval_gap=eval_gap, add_step=add_step, tree_depth=tree_depth,
            max_hops=max_hops, live_pad=live_pad)
    if qtable is not None and rerank_k > 0:
        ids, dists = _exact_rerank(x_pad, queries, state.pool, k=k,
                                   rerank_k=rerank_k, live_pad=live_pad)
    else:
        ids, dists = bs.topk_from_pool(state.pool, k)
    return SearchResult(ids=ids, dists=dists, stats=state.stats), hfeats
