"""Product quantization (PQ) with asymmetric distance computation (ADC),
copied from ``repro/quant/pq.py``.

The d dims are split into M subspaces of d/M dims; each subspace gets a
K-centroid k-means codebook, so a vector compresses to M byte codes.  At
query time the query stays float: a (M, K) LUT of exact subspace distances
is built once per query and a database distance is M lookups and adds.

Training and encoding are numpy with the reference's arithmetic (plain
Lloyd k-means per subspace, assignment in chunks of the same rows), so the
same seed gives byte-equal codebooks and codes.  Two changes make a
million-row training take seconds instead of minutes without changing a
bit: the assignment chunks run on a thread pool (each chunk is the same
BLAS call on the same inputs as the reference's), and the centroid sums
are per-column ``np.bincount`` calls, which add the rows into float64 in
row order exactly as ``np.add.at`` does.  :func:`pq_luts` is plain torch
on the search's device.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.kernels.ref import sq_l2

from .types import PQCodebook

__all__ = ["train_pq", "pq_encode", "pq_decode", "pq_luts"]

_ASSIGN_CHUNK = 65536


def _assign(sub: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """Nearest-centroid ids (N,) for one subspace, chunked over rows."""
    out = np.empty(sub.shape[0], np.int64)
    c_sq = np.sum(cents * cents, axis=1)

    def chunk(s: int) -> None:
        d2 = sub[s:s + _ASSIGN_CHUNK] @ cents.T
        d2 *= 2.0
        np.subtract(c_sq[None, :], d2, out=d2)     # + ||x||² (const/row)
        out[s:s + _ASSIGN_CHUNK] = np.argmin(d2, axis=1)

    starts = range(0, sub.shape[0], _ASSIGN_CHUNK)
    if len(starts) <= 1:
        for s in starts:
            chunk(s)
    else:
        with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as ex:
            list(ex.map(chunk, starts))
    return out


def _cluster_sums(sub: np.ndarray, asg: np.ndarray, k: int) -> np.ndarray:
    """(k, dsub) float64 sums of the rows of each cluster, added in row
    order (the bits of ``np.add.at(sums, asg, sub)``)."""
    return np.stack([np.bincount(asg, weights=sub[:, c], minlength=k)
                     for c in range(sub.shape[1])], axis=1)


def train_pq(x: np.ndarray, *, m: int, k: int = 256, iters: int = 15,
             seed: int = 0) -> PQCodebook:
    """Lloyd k-means per subspace; empty clusters are reseeded."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by pq_m={m}")
    if k > 256:
        raise ValueError("PQ codes are stored as uint8; need k <= 256")
    k = min(k, n)
    dsub = d // m
    rng = np.random.default_rng(seed)
    centroids = np.empty((m, k, dsub), np.float32)
    for j in range(m):
        sub = np.ascontiguousarray(x[:, j * dsub:(j + 1) * dsub])
        cents = sub[rng.choice(n, size=k, replace=False)].copy()
        for _ in range(iters):
            asg = _assign(sub, cents)
            sums = _cluster_sums(sub, asg, k)
            counts = np.bincount(asg, minlength=k)
            filled = counts > 0
            cents[filled] = (sums[filled]
                             / counts[filled, None]).astype(np.float32)
            n_empty = int((~filled).sum())
            if n_empty:
                cents[~filled] = sub[rng.choice(n, size=n_empty)]
        centroids[j] = cents
    return PQCodebook(centroids=centroids)


def pq_encode(x: np.ndarray, cb: PQCodebook) -> np.ndarray:
    """(N, d) float32 → (N, M) uint8 codes."""
    x = np.asarray(x, np.float32)
    m, _, dsub = cb.centroids.shape
    codes = np.empty((x.shape[0], m), np.uint8)
    for j in range(m):
        sub = np.ascontiguousarray(x[:, j * dsub:(j + 1) * dsub])
        codes[:, j] = _assign(sub, cb.centroids[j]).astype(np.uint8)
    return codes


def pq_decode(codes: np.ndarray, cb: PQCodebook) -> np.ndarray:
    """(N, M) codes → (N, d) float32 centroid reconstruction."""
    m = cb.centroids.shape[0]
    parts = [cb.centroids[j][codes[:, j].astype(np.int64)] for j in range(m)]
    return np.concatenate(parts, axis=1).astype(np.float32)


def pq_luts(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(B, M, K) exact subspace squared-L2 LUTs, summed over each
    subspace's dims in :func:`repro_torch.kernels.ref.halving_sum` order."""
    B = queries.shape[0]
    m, _, dsub = centroids.shape
    qs = queries.to(torch.float32).reshape(B, m, 1, dsub)
    return sq_l2(centroids[None], qs)
