"""Plain PyTorch versions of the port's kernels.

These are the semantics contracts: each hand-written kernel in
:mod:`repro_torch.kernels` is held against the function of the same name
here, bit for bit, on the card.  On the CPU they are the execution path
(:mod:`repro_torch.kernels.ops` sends a CPU tensor here and nowhere else).

Mirrors ``repro/kernels/ref.py`` expression by expression, with these
deliberate choices:

* every squared-L2 score and every PQ lookup sum goes through
  :func:`halving_sum`, a pairwise sum whose order the code fixes, so the
  CUDA kernel can repeat it exactly;
* the three sums of :func:`pairwise_l2` run over d in index order;
* every ``jnp.argsort`` becomes ``torch.sort(..., stable=True)``, and
  ``lax.top_k`` a stable sort whose ties go to the smaller id;
* :func:`pq_adc` sums the looked-up values in :func:`halving_sum` order,
  as the search's PQ scorer does, not in the order of the TPU kernel's
  one-hot matmul.

The ``seen`` bitmap of a :class:`HopState` is updated in place: at a
million rows it is a megabyte per lane, and a functional copy per hop would
move more bytes than the hop itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["HopState", "halving_sum", "sq_l2", "sq8_score", "pq_score",
           "sq8_score_rows", "pq_score_rows",
           "pairwise_l2", "sq8_pairwise_l2", "pq_adc", "pool_merge",
           "gather_distances", "fused_topk_l2", "fused_hop_body", "fused_hop",
           "fused_hop_paged", "tree_predict", "next_pow2"]

# Mirrors of repro_torch.core.types constants (kernels sit below core).
INF_DIST = float(torch.tensor(3.0e38, dtype=torch.float32))
INT_MAX = torch.iinfo(torch.int32).max
EPS = 1e-12          # == repro_torch.core.features.EPS


class HopState(NamedTuple):
    """Flat per-lane search state the fused wave-hop kernel advances."""

    ids: torch.Tensor           # (B, L) int32 pool ids, sentinel = n
    dists: torch.Tensor         # (B, L) float32, INF_DIST for empty slots
    expanded: torch.Tensor      # (B, L) bool
    seen: torch.Tensor          # (B, n+1) bool, updated in place
    active: torch.Tensor        # (B,) bool
    dist_count: torch.Tensor    # (B,) int32
    update_count: torch.Tensor  # (B,) int32
    hops: torch.Tensor          # (B,) int32
    terminated: torch.Tensor    # (B,) bool — stopped by the decision tree
    evals_done: torch.Tensor    # (B,) int32 — tree evaluations performed
    stop_at: torch.Tensor       # (B,) int32 — dist_count deadline (add_step)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def halving_sum(s: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise halving sum.

    Zero-pad the width to a power of two, then add the upper half onto the
    lower half until one value is left.  The order is fixed by this code
    alone, so the CUDA kernel repeats it with ``__fadd_rn`` and both give
    the same bits.
    """
    d = s.shape[-1]
    width = next_pow2(d)
    if width != d:
        s = torch.nn.functional.pad(s, (0, width - d))
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def sq_l2(g: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Squared L2 over the last axis: square each component, then
    :func:`halving_sum`."""
    diff = g - q
    return halving_sum(diff * diff)


def sq8_score(codes, scale, zero, queries, cols) -> torch.Tensor:
    """(B, C) squared L2 of query b vs the int8 row ``cols[b, c]`` decoded
    as ``code * scale + zero`` (two roundings, as the kernel decodes)."""
    return sq8_score_rows(codes[cols.long()], scale, zero, queries)


def sq8_score_rows(g, scale, zero, queries) -> torch.Tensor:
    """:func:`sq8_score` of already gathered (B, C, d) int8 rows."""
    return sq_l2(g.to(torch.float32) * scale + zero, queries[:, None, :])


def pq_score(codes, luts, cols) -> torch.Tensor:
    """(B, C) PQ asymmetric distance ``Σ_m luts[b, m, codes[cols[b, c], m]]``
    summed in :func:`halving_sum` order."""
    return pq_score_rows(codes[cols.long()], luts)


def pq_score_rows(g, luts) -> torch.Tensor:
    """:func:`pq_score` of already gathered (B, C, M) code rows."""
    c = g.long()
    B, M = luts.shape[0], luts.shape[1]
    rows = torch.arange(B, device=luts.device)[:, None, None]
    sub = torch.arange(M, device=luts.device)[None, None, :]
    return halving_sum(luts[rows, sub, c])


# ------------------------------------------------------ brute-force scorer
_CHUNK_ELEMS = 1 << 25       # elements per chunk of the plain top-k and pq_adc


def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot products summed over the last axis in index order."""
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for c in range(a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, N) squared L2 as ``(|q|² + |x|²) − 2 q·x``.

    The association is that of ``repro/kernels/ref.py::pairwise_l2``; each
    of the three sums runs over d in index order, one product and one add
    per component (two roundings), so ``csrc/fused_topk_l2.cu`` repeats it
    bit for bit.  The result may be slightly negative or differ from
    ``Σ(x − q)²`` by an ulp: that is the contract.
    """
    q_sq = _seq_dot(q, q)                                  # (B,)
    x_sq = _seq_dot(x, x)                                  # (N,)
    dot = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32,
                      device=q.device)
    for c in range(q.shape[1]):
        dot = dot + q[:, None, c] * x[None, :, c]
    return (q_sq[:, None] + x_sq[None, :]) - 2.0 * dot


def sq8_pairwise_l2(q: torch.Tensor, codes: torch.Tensor,
                    scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """(B, N) squared L2 of float32 queries against int8 rows decoded as
    ``code * scale + zero`` (two roundings, as :func:`sq8_score`), then
    :func:`pairwise_l2`."""
    return pairwise_l2(q, codes.to(torch.float32) * scale + zero)


def pq_adc(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, N) PQ asymmetric distances ``Σ_m luts[b, m, codes[i, m]]``.

    ``luts`` is (B, M, K) float32, ``codes`` (N, M) integer.  The M
    looked-up values are summed in :func:`halving_sum` order, so row i of
    the result equals :func:`pq_score` of row i.  Rows are taken in chunks:
    one gather over all N rows would hold B·N·M values.
    """
    B, M = luts.shape[0], luts.shape[1]
    N = codes.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=luts.device)
    sub = torch.arange(M, device=luts.device)
    step = max(1, _CHUNK_ELEMS // max(B * M, 1))
    for s in range(0, N, step):
        c = codes[s:s + step].long()                       # (n, M)
        out[:, s:s + c.shape[0]] = halving_sum(luts[:, sub, c])
    return out


def pool_merge(pool_dists: torch.Tensor, pool_ids: torch.Tensor,
               cand_dists: torch.Tensor, cand_ids: torch.Tensor):
    """Merge (B, C) candidates into a (B, L) pool and keep the L smallest,
    sorted: a stable sort of ``[pool | candidates]``, so equal keys keep
    their input order (``repro/kernels/ref.py::pool_merge``).  -0.0 ties
    +0.0 and every NaN ties every other above +inf, as JAX orders them:
    the sort runs over keys with one zero and one NaN, since on a CUDA
    tensor ``torch.sort`` orders NaNs by their bits (a negative NaN
    first).  The output keeps each key's own bits."""
    L = pool_dists.shape[1]
    d = torch.cat([pool_dists, cand_dists], dim=1)
    i = torch.cat([pool_ids, cand_ids], dim=1)
    key = torch.where(d == 0, torch.zeros_like(d), d)
    key = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), key)
    order = torch.sort(key, dim=1, stable=True).indices[:, :L]
    return d.gather(1, order), i.gather(1, order)


def gather_distances(queries: torch.Tensor, x_pad: torch.Tensor,
                     nbrs: torch.Tensor) -> torch.Tensor:
    """(B, R) squared L2 of query b against ``x_pad[nbrs[b, r]]`` by
    :func:`sq_l2`, the f32 score of the fused hop.  Ids lie in [0, n];
    the sentinel row n holds ``PAD_VALUE`` and scores finite and huge."""
    return sq_l2(x_pad[nbrs.long()], queries[:, None, :])


def fused_topk_l2(q: torch.Tensor, x: torch.Tensor, *, k: int):
    """(dists, ids), both (B, k): the k nearest rows of x per query.

    Order is (dist, id): ties go to the smaller id, as ``lax.top_k`` breaks
    them.  With k > N the tail is +inf / id N.  Rows are taken in chunks
    and each chunk is merged into a running top-k by a stable sort of
    [running | chunk], which keeps the memory bounded and gives the same
    order as one sort over all N.
    """
    B, N = q.shape[0], x.shape[0]
    kk = min(k, N)
    dev = q.device
    run_d = torch.empty((B, 0), dtype=torch.float32, device=dev)
    run_i = torch.empty((B, 0), dtype=torch.int32, device=dev)
    step = max(1, _CHUNK_ELEMS // max(B, 1))
    for s in range(0, N, step):
        d2 = pairwise_l2(q, x[s:s + step])
        ids = torch.arange(s, s + d2.shape[1], dtype=torch.int32,
                           device=dev).expand(B, -1)
        cat_d = torch.cat([run_d, d2], dim=1)
        cat_i = torch.cat([run_i, ids], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :kk]
        run_d, run_i = cat_d.gather(1, order), cat_i.gather(1, order)
    if kk < k:
        run_d = torch.cat([run_d, torch.full((B, k - kk), float("inf"),
                                             device=dev)], dim=1)
        run_i = torch.cat([run_i, torch.full((B, k - kk), N,
                                             dtype=torch.int32, device=dev)],
                          dim=1)
    return run_d, run_i


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 when none), as ``jnp.argmax``."""
    return mask.to(torch.uint8).argmax(dim=1)


def tree_predict(tree, feats: torch.Tensor, depth: int) -> torch.Tensor:
    """P(continue) for (B, 6) feature rows; ``tree`` = (feature, threshold,
    left, right, value)."""
    feature, threshold, left, right, value = tree
    node = torch.zeros(feats.shape[0], dtype=torch.long, device=feats.device)
    for _ in range(depth):
        f = feature[node].clamp(min=0).long()
        val = feats.gather(1, f[:, None])[:, 0]
        node = torch.where(val <= threshold[node], left[node],
                           right[node]).long()
    return value[node]


def _gather_score(mode: str, t0, t1, t2, queries, cols):
    """(B, C) distances of query b vs table row ``cols[b, c]``: the same
    scorers as the composed path's (``beam_search.score_rows``,
    ``SQTable.gather_score``, ``PQView.gather_score``)."""
    if mode == "f32":
        return sq_l2(t0[cols.long()], queries[:, None, :])
    if mode == "sq8":
        return sq8_score(t0, t1, t2, queries, cols)
    if mode == "pq":
        return pq_score(t0, t1, cols)
    raise ValueError(f"unknown score mode {mode!r}")


def fused_hop_body(hs: HopState, adj_pad, queries, live_pad, mode: str,
                   t0, t1, t2, tree, hot_first, hot_ratio, *, max_hops: int,
                   k: int, eval_gap: int, add_step: int,
                   tree_depth: int, lane_base=None) -> HopState:
    """One fused hop: expand → gather → score → merge → terminate.

    A verbatim mirror of ``repro/kernels/ref.py::fused_hop_body``:
    :func:`repro_torch.core.beam_search.expand_step` followed by the loop
    body bookkeeping (hop cap, then the decision-tree check).  Inactive
    lanes are exact no-ops.  With ``lane_base`` the tables are stacked
    (see :func:`fused_hop`) and lane b reads rows ``lane_base[b] + id``.
    """
    n = adj_pad.shape[-2] - 1
    B, L = hs.ids.shape
    rows = torch.arange(B, device=hs.ids.device)
    off = torch.zeros((B,), dtype=torch.long, device=hs.ids.device)
    if lane_base is not None:            # stacked tables, flattened
        off = lane_base.long()
        adj_pad = adj_pad.reshape(-1, adj_pad.shape[-1])
        t0 = t0.reshape(-1, t0.shape[-1])
        if live_pad is not None:
            live_pad = live_pad.reshape(-1)

    # --- expansion target ---
    unexp = (~hs.expanded) & (hs.ids != n)
    lane = hs.active & unexp.any(dim=1)
    slot = first_true(unexp)
    p = torch.where(lane, hs.ids[rows, slot], n)
    expanded = hs.expanded.clone()
    expanded[rows, slot] = hs.expanded[rows, slot] | lane

    # --- adjacency gather + dedup (read every seen byte before writing) ---
    nbrs = adj_pad[p.long() + off]                         # (B, R)
    already = hs.seen.gather(1, nbrs.long())
    valid = (nbrs != n) & (~already) & lane[:, None]
    if live_pad is not None:
        valid &= live_pad[nbrs.long() + off[:, None]]
    cols = torch.where(valid, nbrs, n)
    seen = hs.seen
    seen[rows[:, None], cols.long()] = True

    # --- score ---
    d2 = _gather_score(mode, t0, t1, t2, queries, cols.long() + off[:, None])
    d2 = torch.where(valid, d2, INF_DIST)

    # --- merge (stable, == beam_search._merge_pool) ---
    worst = hs.dists[:, -1]
    inserted = (d2 < worst[:, None]).sum(dim=1, dtype=torch.int32)
    cat_i = torch.cat([hs.ids, cols.to(torch.int32)], dim=1)
    cat_d = torch.cat([hs.dists, d2], dim=1)
    cat_e = torch.cat([expanded, torch.zeros_like(valid)], dim=1)
    order = torch.sort(cat_d, dim=1, stable=True).indices[:, :L]
    lane_c = lane[:, None]
    ids = torch.where(lane_c, cat_i.gather(1, order), hs.ids)
    dists = torch.where(lane_c, cat_d.gather(1, order), hs.dists)
    expanded = torch.where(lane_c, cat_e.gather(1, order), expanded)

    # --- counters + liveness ---
    dist_count = hs.dist_count + torch.where(
        lane, valid.sum(dim=1, dtype=torch.int32), 0)
    update_count = hs.update_count + torch.where(lane, inserted, 0)
    hops_ct = hs.hops + lane.to(torch.int32)
    still = ((~expanded) & (ids != n)).any(dim=1)
    active = hs.active & still & (hops_ct < max_hops)

    # --- decision-tree termination (loop-body semantics) ---
    terminated = hs.terminated
    evals_done, stop_at = hs.evals_done, hs.stop_at
    if tree is not None:
        due = ((dist_count // eval_gap) > evals_done) & active
        first = dists[:, 0]
        kth = dists[:, min(k, L) - 1]
        feats = torch.stack(
            [hot_first, hot_ratio, first, first / (kth + EPS),
             dist_count.to(torch.float32), update_count.to(torch.float32)],
            dim=1)
        verdict_stop = tree_predict(tree, feats, tree_depth) < 0.5
        newly = due & verdict_stop & (stop_at == INT_MAX)
        stop_at = torch.where(newly, dist_count + add_step, stop_at)
        evals_done = torch.where(due, dist_count // eval_gap, evals_done)
        stop_now = dist_count >= stop_at
        terminated = terminated | (stop_now & active)
        active = active & ~stop_now

    return HopState(ids, dists, expanded, seen, active, dist_count,
                    update_count, hops_ct, terminated, evals_done, stop_at)


def fused_hop(hs: HopState, adj_pad, queries, live_pad, mode: str, t0,
              t1=None, t2=None, tree=None, hot_first=None, hot_ratio=None,
              *, hops: int, max_hops: int, k: int = 1, eval_gap: int = 1,
              add_step: int = 0, tree_depth: int = 1,
              lane_base=None) -> HopState:
    """Advance a wave ``hops`` fused expansions (plain version).

    ``mode`` selects the scorer: ``"f32"`` (``t0`` = padded float32 rows),
    ``"sq8"`` (``t0``/``t1``/``t2`` = int8 codes, scale, zero) or ``"pq"``
    (``t0``/``t1`` = uint8 codes, per-query LUTs).  ``tree`` is the
    unpacked decision-tree arrays ``(feature, threshold, left, right,
    value)`` or None, with ``hot_first``/``hot_ratio`` the frozen hot-phase
    features.  ``hs.seen`` is updated in place.

    ``lane_base`` (B,) int32, or None: the per-lane table base of the
    stacked multi-tenant hot phase.  ``adj_pad`` is then (T, n+1, R),
    ``t0`` (T, n+1, w) and ``live_pad`` (T, n+1), and lane b reads row
    ``lane_base[b] + id`` of their flattened ``(T (n+1), ·)`` views; ids
    stay local (sentinel n) and ``hs.seen`` is (B, n+1).
    """
    for _ in range(hops):
        hs = fused_hop_body(hs, adj_pad, queries, live_pad, mode, t0, t1,
                            t2, tree, hot_first, hot_ratio,
                            max_hops=max_hops, k=k,
                            eval_gap=eval_gap, add_step=add_step,
                            tree_depth=tree_depth, lane_base=lane_base)
    return hs


def fused_hop_paged(hs: HopState, pt, adj_pad, queries, live_pad, mode: str,
                    t0, t1=None, t2=None, tree=None, hot_first=None,
                    hot_ratio=None, *, page_cols: int, hops: int,
                    max_hops: int, k: int = 1, eval_gap: int = 1,
                    add_step: int = 0, tree_depth: int = 1,
                    lane_base=None) -> HopState:
    """Paged-seen hop (plain version): gather pages dense, hop, scatter back.

    ``hs.seen`` is the whole page pool ``(n_pages, page_cols)`` and ``pt``
    the per-lane page table ``(B, pages_per_lane)``: bit ``v`` of lane
    ``b`` lives at ``pool[pt[b, v // page_cols], v % page_cols]``.  Each
    lane's pages are gathered into a dense ``(B, n+1)`` bitmap, the
    :func:`fused_hop` loop runs, and the pages are written back into the
    pool in place, columns past ``n`` of each lane's last page written as
    zeros (inactive lanes included).  Rows of ``pt`` that repeat (padding
    lanes aliasing one scratch lane) must carry identical state, so every
    copy writes the same bytes.
    """
    n1 = adj_pad.shape[-2]
    B, ppl = pt.shape
    pool = hs.seen
    idx = pt.long()
    dense = pool[idx].reshape(B, ppl * page_cols)[:, :n1].contiguous()
    out = fused_hop(hs._replace(seen=dense), adj_pad, queries, live_pad,
                    mode, t0, t1, t2, tree, hot_first, hot_ratio, hops=hops,
                    max_hops=max_hops, k=k, eval_gap=eval_gap,
                    add_step=add_step, tree_depth=tree_depth,
                    lane_base=lane_base)
    pages = torch.nn.functional.pad(out.seen, (0, ppl * page_cols - n1))
    pool[idx] = pages.reshape(B, ppl, page_cols)
    return out._replace(seen=pool)
