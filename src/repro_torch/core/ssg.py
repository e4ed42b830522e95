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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.ref import sq_l2

from .knng import build_knng

__all__ = ["SSGParams", "SSGIndex", "ssg_prune", "build_ssg",
           "ensure_connected", "medoid"]

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
