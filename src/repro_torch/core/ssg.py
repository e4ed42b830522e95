"""Satellite System Graph construction (paper §4.2.1, Algorithm 1).

Same algorithm as ``repro/core/ssg.py``, written as batched tensor code so
a million-row build runs on the card:

* :func:`ssg_prune` forms every node's candidate set (KNN ∪ KNN of KNN,
  distinct, self removed), orders it by distance with ties toward the
  smaller id, keeps the nearest ``candidate_cap``, and runs the greedy
  angle filter for a block of nodes at once: one step per candidate
  position over a precomputed cosine matrix;
* :func:`ensure_connected` finds the reachable set by level-synchronous
  BFS and repairs orphans one root at a time, in the reference's order.

Host-side draws (:func:`medoid`, the entry points) are the reference's
numpy calls, so the same seed gives the same entries.

The incremental maintenance of a mutable graph (:func:`link_new_rows`,
:func:`patch_dead_edges`, :func:`compact_adjacency`,
:func:`repair_free_adjacency` and their helpers) is the reference's host
numpy, copied expression for expression (its own :func:`_angle_keep`, not
the batched :func:`_angle_filter`, whose sums differ), so the same inputs
give the same adjacency bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ref import sq_l2

from .knng import build_knng

__all__ = ["SSGParams", "SSGIndex", "ssg_prune", "build_ssg",
           "ensure_connected", "medoid", "greedy_search_host",
           "link_new_rows", "patch_dead_edges", "compact_adjacency",
           "repair_free_adjacency"]

_BLOCK_ELEMS = 1 << 27      # largest (rows, candidates, d) block gathered
_GREEDY_ROWS = 8192         # rows per greedy-filter block
_SPARE_HOSTS = 8            # hosts tried per orphan once a repair stalls


@dataclasses.dataclass(frozen=True)
class SSGParams:
    knn_k: int = 32
    out_degree: int = 32          # R
    alpha_deg: float = 60.0       # SSG angle threshold
    candidate_cap: int = 220      # cap |C|
    seed: int = 0


@dataclasses.dataclass
class SSGIndex:
    """Host-side index artifact: adjacency + entry points."""

    adj: np.ndarray          # (n, R) int32, pad = n (or -1 free slots)
    entries: np.ndarray      # (E,) int32 entry points (medoid + random)
    n: int


def medoid(x: np.ndarray, sample: int = 4096, seed: int = 0) -> int:
    """Approximate medoid: the sampled point closest to the dataset mean."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(sample, n), replace=False)
    mean = x.mean(axis=0)
    d = np.sum((x[idx] - mean) ** 2, axis=1)
    return int(idx[np.argmin(d)])


def _angle_keep(vec: np.ndarray, dist: np.ndarray, R: int,
                cos_a: float) -> list[int]:
    """SSG greedy angle filter (Alg 1 lines 10-20) over distance-sorted
    candidate offset vectors ``vec``; returns kept candidate indices.
    One row at a time in numpy, as the reference computes it."""
    d = vec.shape[1]
    norm = np.sqrt(np.maximum(dist, 1e-12))
    kept: list[int] = []
    kept_dir = np.empty((R, d), np.float32)
    for i in range(vec.shape[0]):
        if len(kept) >= R:
            break
        u = vec[i] / norm[i]
        if kept:
            cos = kept_dir[: len(kept)] @ u
            if np.any(cos > cos_a):                   # angle < alpha → drop
                continue
        kept_dir[len(kept)] = u
        kept.append(i)
    return kept


def _cos_above(cos: torch.Tensor, cos_a: float) -> torch.Tensor:
    """``cos > cos_a`` with ``cos_a`` compared exactly as a float64, as the
    reference's numpy comparison does, without widening ``cos``."""
    t = float(np.float32(cos_a))
    return cos >= t if t > cos_a else cos > t


def _candidates(xt, kt, b0, b1, cap):
    """Nearest ``cap`` distinct candidates of rows [b0, b1): ids, d2, valid."""
    n = xt.shape[0]
    nb = kt[b0:b1]
    cand = torch.cat([nb, kt[nb].reshape(b1 - b0, -1)], dim=1)
    self_id = torch.arange(b0, b1, device=xt.device)[:, None]
    cand = torch.where(cand == self_id, n, cand)
    cand, _ = torch.sort(cand, dim=1)
    invalid = cand == n
    invalid[:, 1:] |= cand[:, 1:] == cand[:, :-1]
    d2 = sq_l2(xt[cand.clamp(max=n - 1)], xt[b0:b1, None, :])
    d2 = torch.where(invalid, float("inf"), d2)
    d2, order = torch.sort(d2, dim=1, stable=True)
    order = order[:, :cap]
    return (cand.gather(1, order), d2[:, :cap],
            ~invalid.gather(1, order))


def _angle_filter(xt, rows, cand, d2, valid, R, cos_a):
    """Greedy SSG angle filter (Alg 1 lines 10-20) for a block of rows."""
    n = xt.shape[0]
    b, cap = cand.shape
    vec = xt[cand.clamp(max=n - 1)] - xt[rows][:, None, :]
    norm = torch.sqrt(torch.clamp(d2, min=1e-12))
    u = vec / norm[..., None]
    close = _cos_above(torch.bmm(u, u.transpose(1, 2)), cos_a)
    kept = torch.zeros((b, cap), dtype=torch.bool, device=xt.device)
    cnt = torch.zeros((b,), dtype=torch.int32, device=xt.device)
    for i in range(cap):
        blocked = (close[:, i, :i] & kept[:, :i]).any(dim=1)
        ok = valid[:, i] & (cnt < R) & ~blocked
        kept[:, i] = ok
        cnt += ok.to(torch.int32)
    slot = torch.where(kept, torch.cumsum(kept, dim=1) - 1, R)
    out = torch.full((b, R + 1), n, dtype=torch.int64, device=xt.device)
    out.scatter_(1, slot, torch.where(kept, cand, n))
    return out[:, :R]


def ssg_prune(x, knng, params: SSGParams, device="cpu") -> np.ndarray:
    """Algorithm 1 over all nodes. Returns padded (n, R) adjacency, pad=n."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    kt = torch.as_tensor(np.asarray(knng, np.int64), device=xt.device)
    n, d = xt.shape
    R = params.out_degree
    cap = params.candidate_cap
    cos_a = float(np.cos(np.deg2rad(params.alpha_deg)))
    C = kt.shape[1] * (kt.shape[1] + 1)
    cand_all = torch.empty((n, min(cap, C)), dtype=torch.int64,
                           device=xt.device)
    d2_all = torch.empty(cand_all.shape, dtype=torch.float32,
                         device=xt.device)
    valid_all = torch.empty(cand_all.shape, dtype=torch.bool,
                            device=xt.device)
    blk = max(1, _BLOCK_ELEMS // (C * d))
    for b0 in range(0, n, blk):
        b1 = min(b0 + blk, n)
        cand_all[b0:b1], d2_all[b0:b1], valid_all[b0:b1] = _candidates(
            xt, kt, b0, b1, cap)
    adj = torch.empty((n, R), dtype=torch.int64, device=xt.device)
    for b0 in range(0, n, _GREEDY_ROWS):
        b1 = min(b0 + _GREEDY_ROWS, n)
        rows = torch.arange(b0, b1, device=xt.device)
        adj[b0:b1] = _angle_filter(xt, rows, cand_all[b0:b1],
                                   d2_all[b0:b1], valid_all[b0:b1], R, cos_a)
    return adj.to(torch.int32).cpu().numpy()


def _bfs(adj, seen, start):
    """Mark everything reachable from ``start`` that is not yet ``seen``
    (in place), level by level.  Works on numpy arrays or on tensors."""
    lib = torch if isinstance(adj, torch.Tensor) else np
    n = adj.shape[0]
    seen[start] = True
    frontier = start
    while frontier.shape[0]:
        nb = adj[frontier].reshape(-1)
        nb = nb[nb < n]
        nb = lib.unique(nb[~seen[nb]])
        seen[nb] = True
        frontier = nb


def _nearest_hosts(xt, missing, reach, k: int, chunk: int = 1024):
    """(M, k) nearest reachable ids of each missing row, nearest first.

    Candidates come from the matmul expansion; their order from the
    direct squared differences, as the reference computes them.
    """
    x_r = xt[reach]
    r_sq = (x_r * x_r).sum(dim=1)
    out = torch.empty((missing.shape[0], min(k, reach.shape[0])),
                      dtype=torch.int64, device=xt.device)
    for s in range(0, missing.shape[0], chunk):
        q = xt[missing[s:s + chunk]]
        d2 = r_sq[None, :] - 2.0 * (q @ x_r.T)
        cand = reach[torch.topk(d2, out.shape[1], dim=1,
                                largest=False).indices]
        exact = sq_l2(xt[cand], q[:, None, :])
        exact, order = torch.sort(exact, dim=1, stable=True)
        out[s:s + chunk] = cand.gather(1, order)
    return out


def ensure_connected(x, adj, entry: int, max_rounds: int = 32,
                     device="cpu") -> np.ndarray:
    """NSG-style repair: make every node reachable from ``entry``.

    Each round marks the reachable set and, in id order, attaches every
    orphan to its nearest reachable node (a free slot first; else the
    farthest unprotected edge is evicted), absorbing the orphan's own
    subtree for the rest of the round, until a fixed point.

    One departure from the reference, taken only once a round leaves as
    many nodes missing as the round before: from then on, when every slot
    of the nearest host already holds a repair edge, the orphan goes to
    the nearest of its ``_SPARE_HOSTS`` nearest reachable nodes that still
    has a free or unprotected slot.  The reference evicts a repair edge
    there, which re-orphans the node that edge attached: when more orphans
    share one nearest host than it has slots, the same nodes are orphaned
    round after round and the repair never converges.  The round's
    nearest hosts are found in one batch on the device; the per-orphan
    bookkeeping is host numpy.
    """
    x = np.ascontiguousarray(x, np.float32)
    xt = torch.as_tensor(x, device=device)
    a = np.array(adj, np.int64)
    n, R = a.shape
    protected = np.zeros((n, R), bool)
    stalled, last_missing = False, n + 1
    for _ in range(max_rounds):
        seen_t = torch.zeros(n, dtype=torch.bool, device=xt.device)
        _bfs(torch.as_tensor(a, device=xt.device), seen_t,
             torch.tensor([entry], device=xt.device))
        missing = torch.nonzero(~seen_t)[:, 0]
        if missing.numel() == 0:
            return a.astype(np.int32)
        stalled = stalled or missing.numel() >= last_missing
        last_missing = missing.numel()
        hosts = _nearest_hosts(xt, missing, torch.nonzero(seen_t)[:, 0],
                               _SPARE_HOSTS if stalled else 1).cpu().numpy()
        seen = seen_t.cpu().numpy()
        for m, cands in zip(missing.cpu().numpy(), hosts):
            if seen[m]:
                continue
            host = int(cands[0])
            for c in cands:
                if not protected[c].all():
                    host = int(c)
                    break
            row = a[host]
            free = np.flatnonzero(row == n)
            if free.size:
                slot = free[0]
            else:
                dd = np.sum((x[np.minimum(row, n - 1)] - x[host]) ** 2,
                            axis=1)
                dd[protected[host]] = -2.0
                slot = int(np.argmax(dd))
            a[host, slot] = m
            protected[host, slot] = True
            _bfs(a, seen, np.array([m]))
    seen = np.zeros(n, bool)
    _bfs(a, seen, np.array([entry]))
    if not seen.all():
        raise RuntimeError("connectivity repair did not converge")
    return a.astype(np.int32)


def build_ssg(x, params: SSGParams | None = None, n_entry: int = 8,
              knng: np.ndarray | None = None, device="cpu") -> SSGIndex:
    """Full NSSG build: EFANNA-stage KNNG → SSG prune → connectivity repair."""
    params = params or SSGParams()
    x = np.ascontiguousarray(x, np.float32)
    if knng is None:
        knng = build_knng(x, params.knn_k, seed=params.seed, device=device)
    adj = ssg_prune(x, knng, params, device=device)
    med = medoid(x, seed=params.seed)
    adj = ensure_connected(x, adj, med, device=device)
    rng = np.random.default_rng(params.seed + 1)
    extra = rng.choice(x.shape[0], size=max(0, n_entry - 1), replace=False)
    entries = np.unique(np.concatenate([[med], extra])).astype(np.int32)
    return SSGIndex(adj=adj, entries=entries, n=x.shape[0])


# --------------------------------------------------------------------------
# Incremental maintenance over a *free-slot* adjacency (host numpy).
#
# A build-once graph pads unused slots with the sentinel ``n``; once rows can
# be appended that value collides with ids minted later, so every mutable-
# graph op below uses ``-1`` for empty slots instead (a value no insert can
# ever mint).  ``VectorStore.pad_adjacency`` maps ``-1`` back to the device
# sentinel at upload time.
# --------------------------------------------------------------------------

def greedy_search_host(x: np.ndarray, adj: np.ndarray, entries: np.ndarray,
                       q: np.ndarray, *, pool_size: int = 48,
                       max_hops: int = 256,
                       alive: Optional[np.ndarray] = None) -> np.ndarray:
    """Host-side best-first search; returns visited-pool ids, nearest first.

    The insert path's candidate generator: the existing graph is searched
    from ``entries`` and the candidate pool doubles as the new node's
    neighborhood sample.  Invalid (< 0 / >= n) and tombstoned neighbors are
    skipped.
    """
    n = x.shape[0]
    ent = np.unique(np.asarray(entries, np.int64))
    ent = ent[(ent >= 0) & (ent < n)]
    if alive is not None:
        ent = ent[alive[ent]]
    if ent.size == 0:
        return np.empty(0, np.int64)
    d0 = np.sum((x[ent] - q) ** 2, axis=1)
    order = np.argsort(d0, kind="stable")
    pool_ids = ent[order][:pool_size]
    pool_d = d0[order][:pool_size]
    expanded = np.zeros(pool_ids.shape[0], bool)
    seen = set(pool_ids.tolist())
    for _ in range(max_hops):
        todo = np.flatnonzero(~expanded)
        if todo.size == 0:
            break
        i = int(todo[np.argmin(pool_d[todo])])
        expanded[i] = True
        nbrs = adj[pool_ids[i]]
        nbrs = nbrs[(nbrs >= 0) & (nbrs < n)]
        if alive is not None:
            nbrs = nbrs[alive[nbrs]]
        nbrs = np.array([v for v in nbrs.tolist() if v not in seen],
                        np.int64)
        if nbrs.size == 0:
            continue
        seen.update(nbrs.tolist())
        nd = np.sum((x[nbrs] - q) ** 2, axis=1)
        ids = np.concatenate([pool_ids, nbrs])
        ds = np.concatenate([pool_d, nd])
        ex = np.concatenate([expanded, np.zeros(nbrs.shape[0], bool)])
        keep = np.argsort(ds, kind="stable")[:pool_size]
        pool_ids, pool_d, expanded = ids[keep], ds[keep], ex[keep]
    return pool_ids


def _reprune_row(x: np.ndarray, adj: np.ndarray, p: int,
                 cand: np.ndarray, params: SSGParams) -> None:
    """Rewrite row ``p`` as the SSG angle-prune of candidate set ``cand``."""
    R = adj.shape[1]
    cos_a = np.cos(np.deg2rad(params.alpha_deg))
    cand = np.unique(cand[(cand >= 0) & (cand != p)])
    vec = x[cand] - x[p]
    dist = np.einsum("cd,cd->c", vec, vec)
    order = np.argsort(dist, kind="stable")[: params.candidate_cap]
    cand, vec, dist = cand[order], vec[order], dist[order]
    ids = cand[_angle_keep(vec, dist, R, cos_a)]
    adj[p] = -1
    adj[p, : ids.size] = ids


def link_new_rows(x: np.ndarray, adj: np.ndarray, new_ids: np.ndarray,
                  params: SSGParams, entries: np.ndarray,
                  alive: Optional[np.ndarray] = None) -> None:
    """Local re-link for inserted rows (in place on a free-slot adjacency).

    For each new node ``p``: search-based candidates (the greedy pool plus
    its members' out-neighbors), SSG angle-prune for ``p``'s out-edges, then
    reverse-link — each chosen neighbor gains an edge back to ``p``, via a
    free slot or an SSG re-prune of its neighborhood when full.  The nearest
    kept neighbor is *forced* to keep its back-edge (evicting its farthest
    edge if the angle prune dropped ``p``) so every inserted node has at
    least one in-edge and stays reachable.  Only the touched vertices are
    rewritten.
    """
    n = x.shape[0]
    pool_size = min(params.candidate_cap,
                    max(32, 2 * params.knn_k, params.out_degree))
    for p in np.asarray(new_ids, np.int64):
        pool = greedy_search_host(x, adj, entries, x[p],
                                  pool_size=pool_size, alive=alive)
        cand = [pool]
        for c in pool:
            nb = adj[c]
            cand.append(nb[(nb >= 0) & (nb < n)])
        cand = np.concatenate(cand)
        if alive is not None and cand.size:
            cand = cand[alive[cand]]
        if cand.size == 0:
            # empty graph (first insert): fall back to the entry set
            cand = np.asarray(entries, np.int64)
        _reprune_row(x, adj, int(p), cand.astype(np.int64), params)
        for j, q in enumerate(adj[p]):
            if q < 0:
                break
            row = adj[q]
            free = np.flatnonzero(row < 0)
            if p in row[: row.shape[0] - free.shape[0]]:
                continue
            if free.size:
                adj[q, free[0]] = p
            else:
                _reprune_row(x, adj, int(q),
                             np.concatenate([row, [p]]), params)
                if j == 0 and p not in adj[q]:
                    # guarantee one in-edge: evict q's farthest kept edge
                    row = adj[q]
                    valid = np.flatnonzero(row >= 0)
                    d2 = np.sum((x[row[valid]] - x[q]) ** 2, axis=1)
                    adj[q, valid[np.argmax(d2)]] = p


def patch_dead_edges(x: np.ndarray, adj: np.ndarray, dead_ids: np.ndarray,
                     alive: np.ndarray) -> None:
    """Tombstone patch-through (in place): every in-neighbor of a dead node
    drops the dead edge and inherits the *live frontier* behind it, so paths
    that ran through the tombstone stay walkable even though search no
    longer expands it.  The frontier walk follows chains of dead nodes and
    is bounded to keep deletes cheap."""
    n, R = adj.shape
    dead = np.zeros(n, bool)
    dead[np.asarray(dead_ids, np.int64)] = True
    valid = adj >= 0
    hit = np.zeros_like(valid)
    hit[valid] = dead[adj[valid]]
    for u in np.flatnonzero(hit.any(axis=1)):
        if dead[u]:
            continue                     # dead rows are dropped at compaction
        row = adj[u]
        keep = [v for v in row if v >= 0 and alive[v]]
        inherited: list[int] = []
        for v in row:
            if not (v >= 0 and dead[v]):
                continue
            # BFS through not-alive nodes to the live frontier behind v.
            stack, seen_dead = [int(v)], {int(v)}
            while stack and len(inherited) < R and len(seen_dead) <= 4 * R:
                nb = adj[stack.pop()]
                for w in nb[(nb >= 0) & (nb < n)].tolist():
                    if alive[w]:
                        if w != u and w not in keep and w not in inherited:
                            inherited.append(w)
                    elif w not in seen_dead:
                        seen_dead.add(w)
                        stack.append(w)
        if inherited:
            d2 = np.sum((x[inherited] - x[u]) ** 2, axis=1)
            inherited = [inherited[i] for i in np.argsort(d2, kind="stable")]
        new_row = (keep + inherited)[:R]
        adj[u] = -1
        adj[u, : len(new_row)] = new_row


def compact_adjacency(adj: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """Rewrite a free-slot adjacency under a compaction remap.

    ``remap[old] = new`` internal id or ``-1`` for dropped rows.  Dropped
    rows disappear; edges to dropped rows become free slots (left-aligned).
    """
    kept = remap >= 0
    a = adj[kept]
    valid = a >= 0
    m = np.where(valid, remap[np.maximum(a, 0)], -1).astype(np.int32)
    order = np.argsort(m < 0, axis=1, kind="stable")      # live edges first
    return np.ascontiguousarray(np.take_along_axis(m, order, 1))


def repair_free_adjacency(x: np.ndarray, adj: np.ndarray, entry: int,
                          device="cpu") -> np.ndarray:
    """:func:`ensure_connected` for a free-slot adjacency (after
    compaction); the reachability search runs on ``device``."""
    n = adj.shape[0]
    padded = np.where(adj < 0, n, adj).astype(np.int32)
    repaired = ensure_connected(x, padded, entry, device=device)
    return np.where(repaired >= n, -1, repaired).astype(np.int32)
