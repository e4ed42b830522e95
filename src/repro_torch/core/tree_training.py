"""Decision-tree training-data collection (paper §4.3.2).

The full phase runs *without* a tree for ``max_hops`` composed steps (the
reference's ``lax.scan`` becomes a Python loop over :func:`expand_step`),
recording the live feature matrix and the k-th result distance at every
hop.  On the host a sample is emitted wherever a tree evaluation would
have been due, labeled 1 ("continue") iff the k-th distance still improves
afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import beam_search as bs
from .dynamic_search import _seed_full_state, hot_phase
from .features import feature_matrix, hot_features

__all__ = ["collect_training_data", "TraceRecord"]


class TraceRecord(NamedTuple):
    feats: torch.Tensor       # (T, B, 6)
    kth: torch.Tensor         # (T, B) current k-th result distance
    dist_count: torch.Tensor  # (T, B)
    active: torch.Tensor      # (T, B)


def _trace_full_phase(x_pad, adj_pad, queries, state, hfeats, *, k, hops,
                      live_pad=None) -> TraceRecord:
    recs = []
    s = state
    for _ in range(hops):
        s = bs.expand_step(x_pad, adj_pad, queries, s, live_pad)
        feats = feature_matrix(hfeats, s.pool, s.stats, k)
        kth = s.pool.dists[:, min(k, s.pool.dists.shape[1]) - 1]
        recs.append((feats, kth, s.stats.dist_count, s.active))
    return TraceRecord(*(torch.stack(r) for r in zip(*recs)))


def collect_training_data(
    x_pad, adj_pad, x_hot_pad, adj_hot_pad, hot_ids_pad, hot_entries,
    queries: np.ndarray, *, k: int, hot_pool_size: int, full_pool_size: int,
    eval_gap: int, max_hops: int, hot_mode: str = "graph",
    improve_tol: float = 1e-6, batch: int = 256, live_pad=None,
):
    """Returns (features (N,6), labels (N,)) for CART training.

    ``x_pad`` may be a quantized score table: when the deployed search
    scans compressed codes, the tree must see the same (approximate)
    distance distributions at train time.
    """
    feats_out, labels_out = [], []
    n = bs.table_n(x_pad)
    for s in range(0, queries.shape[0], batch):
        q = torch.as_tensor(np.asarray(queries[s: s + batch], np.float32),
                            device=adj_pad.device)
        hot_pool, _ = hot_phase(
            x_hot_pad, adj_hot_pad, hot_entries, q,
            pool_size=hot_pool_size, max_hops=max_hops, mode=hot_mode)
        hfeats = hot_features(hot_pool, k)
        state = _seed_full_state(hot_pool, hot_ids_pad, n, full_pool_size,
                                 live_pad)
        rec = _trace_full_phase(bs.as_view(x_pad, q), adj_pad, q, state,
                                hfeats, k=k, hops=max_hops,
                                live_pad=live_pad)
        f, lab = _label_trace(rec, eval_gap, improve_tol)
        feats_out.append(f)
        labels_out.append(lab)
    return (np.concatenate(feats_out, 0).astype(np.float32),
            np.concatenate(labels_out, 0).astype(np.int32))


def _label_trace(rec: TraceRecord, eval_gap: int, tol: float):
    """Host-side: emit (features, continue?) at every due evaluation point."""
    feats = rec.feats.cpu().numpy()            # (T, B, 6)
    kth = rec.kth.cpu().numpy()                # (T, B)
    dc = rec.dist_count.cpu().numpy()          # (T, B)
    active = rec.active.cpu().numpy()          # (T, B)
    T, B, _ = feats.shape

    future_min = np.full((T, B), np.inf, np.float32)
    run = np.full((B,), np.inf, np.float32)
    for t in range(T - 1, -1, -1):
        future_min[t] = run
        run = np.minimum(run, kth[t])

    evals_done = np.zeros((B,), np.int64)
    out_f, out_l = [], []
    for t in range(T):
        due = (dc[t] // eval_gap) > evals_done
        due &= active[t]
        if due.any():
            idx = np.flatnonzero(due)
            improve = future_min[t, idx] < kth[t, idx] * (1.0 - tol)
            out_f.append(feats[t, idx])
            out_l.append(improve.astype(np.int32))
            evals_done[idx] = dc[t, idx] // eval_gap
    if not out_f:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int32)
    return np.concatenate(out_f, 0), np.concatenate(out_l, 0)
