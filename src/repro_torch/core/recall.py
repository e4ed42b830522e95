"""Ground truth + recall@k (paper Eq. 3)."""

from __future__ import annotations

import numpy as np
import torch

from .knng import smallest_k

__all__ = ["ground_truth", "recall_at_k"]


def ground_truth(x, queries, k: int, chunk: int = 256,
                 device="cpu") -> np.ndarray:
    """Exact top-k ids (nq, k) by chunked brute force on ``device``; ties
    go to the smaller id, as ``lax.top_k`` breaks them."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    queries = np.asarray(queries, np.float32)
    x_sq = (xt * xt).sum(dim=-1)
    out = np.empty((queries.shape[0], k), np.int32)
    for s in range(0, queries.shape[0], chunk):
        e = min(s + chunk, queries.shape[0])
        q = torch.as_tensor(queries[s:e], device=xt.device)
        d2 = x_sq[None, :] - 2.0 * (q @ xt.T)
        out[s:e] = smallest_k(d2, k)[1].to(torch.int32).cpu().numpy()
    return out


def recall_at_k(pred_ids, gt_ids) -> float:
    """|A_k ∩ N_k| / k averaged over queries (Eq. 3)."""
    pred_ids = np.asarray(pred_ids)
    gt_ids = np.asarray(gt_ids)
    if pred_ids.shape != gt_ids.shape:
        raise ValueError(f"shape mismatch {pred_ids.shape} vs {gt_ids.shape}")
    k = gt_ids.shape[1]
    hits = 0
    for p, g in zip(pred_ids, gt_ids):
        hits += np.intersect1d(p, g).size
    return hits / (k * gt_ids.shape[0])
