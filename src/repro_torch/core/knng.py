"""K-nearest-neighbor graph construction (the paper's EFANNA stage).

Two builders, as in ``repro/core/knng.py``, written as batched tensor code
that runs on the device of the caller's choice:

* :func:`exact_knn` — chunked brute force on ``torch.matmul`` (float32,
  TF32 off), ties broken toward the smaller id as ``lax.top_k`` does;
* :func:`nn_descent` — NN-descent from a random graph.  Every random draw
  is made by a host numpy generator in the reference's order, so the same
  seed gives the same initial graph, samples and reverse edges; the joins,
  distances and merges run on the device.

Both return ``(n, k)`` neighbor ids excluding self, as numpy int32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import sq_l2

__all__ = ["exact_knn", "nn_descent", "build_knng", "smallest_k"]

# Elements of the largest (rows, candidates, d) float32 block one step
# gathers at once (512 MiB).
_BLOCK_ELEMS = 1 << 27


def smallest_k(d2: torch.Tensor, k: int):
    """(values, ids) of the k smallest entries per row, ties toward the
    smaller column (the order ``lax.top_k`` of the negated row gives)."""
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def exact_knn(x, k: int, chunk: int = 1024, device="cpu"):
    """Exact KNN ids ``(n, k)`` and squared distances, chunked over rows."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    n = xt.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    x_sq = (xt * xt).sum(dim=-1)
    ids_out = np.empty((n, k), np.int32)
    d_out = np.empty((n, k), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        c = xt[s:e]
        d2 = x_sq[None, :] - 2.0 * (c @ xt.T)
        rows = torch.arange(s, e, device=xt.device)
        d2[torch.arange(e - s, device=xt.device), rows] = float("inf")
        vals, idx = smallest_k(d2, k)
        ids_out[s:e] = idx.to(torch.int32).cpu().numpy()
        d_out[s:e] = (vals + (c * c).sum(dim=-1)[:, None]).cpu().numpy()
    return ids_out, d_out


def _gather_dists(xt: torch.Tensor, ids: torch.Tensor, row0: int = 0):
    """d2(x[row0 + i], x[ids[i, j]]) in row blocks to bound memory."""
    b_all, c = ids.shape
    out = torch.empty((b_all, c), dtype=torch.float32, device=xt.device)
    blk = max(1, _BLOCK_ELEMS // max(1, c * xt.shape[1]))
    for s in range(0, b_all, blk):
        e = min(s + blk, b_all)
        out[s:e] = sq_l2(xt[ids[s:e]], xt[row0 + s:row0 + e, None, :])
    return out


def _reverse_sample(ids: torch.Tensor, n: int, s: int, rng) -> torch.Tensor:
    """Sample of reverse edges: for each node, s nodes that point at it.

    Same result as the reference's first-come-first-served loop over a
    random permutation of the edges: for every destination, the first
    ``s`` edges in permutation order, found by a stable sort on the
    destination; unfilled slots are then drawn in row-major order.
    """
    dev = ids.device
    k = ids.shape[1]
    perm = torch.as_tensor(rng.permutation(n * k), device=dev)
    p = perm[: min(n * k, 4 * n * s)]
    dst = ids.reshape(-1)[p]
    src = p // k
    dsorted, order = torch.sort(dst, stable=True)
    first = torch.searchsorted(dsorted, dsorted)
    rank = torch.arange(p.numel(), device=dev) - first
    keep = rank < s
    rev = torch.full((n, s), -1, dtype=torch.int64, device=dev)
    rev[dsorted[keep], rank[keep]] = src[order][keep]
    mask = rev < 0
    draws = rng.integers(0, n, size=int(mask.sum()))
    rev[mask] = torch.as_tensor(draws, device=dev)
    return rev


def nn_descent(x, k: int, *, rounds: int = 8, sample: int = 16,
               seed: int = 0, tol: float = 0.001,
               device="cpu") -> np.ndarray:
    """NN-descent: ``(n, k) int32`` approximate KNN ids.

    Each round joins every node's current neighborhood with a sample of
    its neighbors' neighborhoods and of its reverse neighbors, and keeps
    the k nearest distinct ids.
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    xt = torch.as_tensor(x, device=device)
    dev = xt.device

    init = rng.integers(0, n - 1, size=(n, k), dtype=np.int64)
    init += init >= np.arange(n)[:, None]             # skip self
    ids = torch.as_tensor(init, device=dev)
    dists = _gather_dists(xt, ids)
    dists, order = torch.sort(dists, dim=1, stable=True)
    ids = ids.gather(1, order)

    s = min(sample, k)
    for _ in range(rounds):
        cols = torch.as_tensor(rng.permutation(k)[:s], device=dev)
        rev = _reverse_sample(ids, n, s, rng)
        new_ids = torch.empty_like(ids)
        new_d = torch.empty_like(dists)
        C = k + s + s * k + s
        blk = max(1, _BLOCK_ELEMS // (C * xt.shape[1]))
        for b0 in range(0, n, blk):
            b1 = min(b0 + blk, n)
            picked = ids[b0:b1][:, cols]                         # (b, s)
            non = ids[picked.reshape(-1)].reshape(b1 - b0, s * k)
            cand = torch.cat([picked, non, rev[b0:b1]], dim=1)
            self_id = torch.arange(b0, b1, device=dev)[:, None]
            cand = torch.where(cand == self_id, ids[b0:b1, :1], cand)
            cd = _gather_dists(xt, cand, row0=b0)
            all_ids = torch.cat([ids[b0:b1], cand], dim=1)
            all_d = torch.cat([dists[b0:b1], cd], dim=1)
            si, o = torch.sort(all_ids, dim=1, stable=True)
            sd = all_d.gather(1, o)
            dup = torch.zeros_like(si, dtype=torch.bool)
            dup[:, 1:] = si[:, 1:] == si[:, :-1]
            sd[dup] = float("inf")
            sd, o2 = torch.sort(sd, dim=1, stable=True)
            new_ids[b0:b1] = si.gather(1, o2[:, :k])
            new_d[b0:b1] = sd[:, :k]
        changed = float((new_ids != ids).float().mean())
        ids, dists = new_ids, new_d
        if changed < tol:
            break
    return ids.to(torch.int32).cpu().numpy()


def build_knng(x, k: int, *, exact_threshold: int = 60_000, seed: int = 0,
               device="cpu") -> np.ndarray:
    """EFANNA-stage dispatcher: exact below the threshold, NN-descent above."""
    if x.shape[0] <= exact_threshold:
        ids, _ = exact_knn(x, k, device=device)
        return ids
    return nn_descent(x, k, seed=seed, device=device)
