"""Decision-tree feature extraction (paper §4.3.2, Table 1).

Six features per query lane, in :data:`FEATURE_NAMES` order: the frozen
hot-phase ``first`` and ``first / kth``, the live full-phase ``first`` and
``first / kth``, and the full-phase ``dist_count`` and ``update_count``.
Distances are squared L2 end to end.
"""

from __future__ import annotations

import torch

from .types import HotFeatures, PoolState, SearchStats

__all__ = ["hot_features", "feature_matrix", "EPS"]

EPS = 1e-12


def hot_features(pool: PoolState, k: int) -> HotFeatures:
    """Freeze (a)-features from the hot-phase result pool."""
    first = pool.dists[:, 0]
    kth = pool.dists[:, min(k, pool.dists.shape[1]) - 1]
    return HotFeatures(first=first, first_div_kth=first / (kth + EPS))


def feature_matrix(hot: HotFeatures, pool: PoolState, stats: SearchStats,
                   k: int) -> torch.Tensor:
    """(B, 6) live feature rows."""
    first = pool.dists[:, 0]
    kth = pool.dists[:, min(k, pool.dists.shape[1]) - 1]
    return torch.stack(
        [hot.first, hot.first_div_kth, first, first / (kth + EPS),
         stats.dist_count.to(torch.float32),
         stats.update_count.to(torch.float32)], dim=1)
