"""CART decision tree: trained in numpy, evaluated in torch inside search.

Training is a copy of ``repro/core/decision_tree.py`` (exact greedy CART on
Gini impurity).  The artifact is a flat encoding ``(feature, threshold,
left, right, value)`` of tensors; leaves loop to themselves, so a fixed
``depth``-step walk evaluates any tree of depth ≤ ``depth``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.ref import tree_predict

__all__ = ["TreeArrays", "DecisionTree", "train_tree", "predict",
           "FEATURE_NAMES"]

FEATURE_NAMES = (
    "hotIdx_1st",
    "hotIdx_1st_div_kth",
    "fullIdx_1st",
    "fullIdx_1st_div_kth",
    "dist_count",
    "update_count",
)


class TreeArrays(NamedTuple):
    """Flat tree encoding; all tensors are (num_nodes,)."""

    feature: torch.Tensor    # int32; -1 at leaves
    threshold: torch.Tensor  # float32; x[feature] <= threshold → left
    left: torch.Tensor       # int32 child index (self at leaves)
    right: torch.Tensor      # int32 child index (self at leaves)
    value: torch.Tensor      # float32 P(continue search) at this node


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.5


def _gini_best_split(x: np.ndarray, y: np.ndarray, min_leaf: int):
    """Best (feature, threshold, gain) by exact scan. y ∈ {0,1}."""
    n, f = x.shape
    total_pos = y.sum()
    parent_gini = 1.0 - ((total_pos / n) ** 2 + ((n - total_pos) / n) ** 2)
    best = (None, 0.0, 0.0)
    for j in range(f):
        order = np.argsort(x[:, j], kind="stable")
        xs, ys = x[order, j], y[order]
        pos_left = np.cumsum(ys)[:-1]
        cnt_left = np.arange(1, n)
        ok = (xs[1:] != xs[:-1]) & (cnt_left >= min_leaf) \
            & ((n - cnt_left) >= min_leaf)
        if not ok.any():
            continue
        pl = pos_left / cnt_left
        pr = (total_pos - pos_left) / (n - cnt_left)
        gini = (cnt_left * (2 * pl * (1 - pl))
                + (n - cnt_left) * (2 * pr * (1 - pr))) / n
        gini = np.where(ok, gini, np.inf)
        i = int(np.argmin(gini))
        gain = parent_gini - gini[i]
        if gain > best[2] + 1e-12:
            thr = 0.5 * (xs[i] + xs[i + 1])
            best = (j, float(thr), float(gain))
    return best


def _grow(x, y, depth, max_depth, min_leaf, nodes: list[_Node]) -> int:
    idx = len(nodes)
    node = _Node(value=float(y.mean()) if y.size else 0.5)
    nodes.append(node)
    if (depth >= max_depth or y.size < 2 * min_leaf
            or y.min() == y.max()):
        node.left = node.right = idx
        return idx
    j, thr, gain = _gini_best_split(x, y, min_leaf)
    if j is None or gain <= 0.0:
        node.left = node.right = idx
        return idx
    mask = x[:, j] <= thr
    node.feature, node.threshold = j, thr
    node.left = _grow(x[mask], y[mask], depth + 1, max_depth, min_leaf, nodes)
    node.right = _grow(x[~mask], y[~mask], depth + 1, max_depth, min_leaf,
                       nodes)
    return idx


def _accumulate_importance(nodes, x, y, idx, out):
    node = nodes[idx]
    if node.feature < 0 or y.size == 0:
        return
    p = y.mean()
    parent = 2 * p * (1 - p) * y.size
    mask = x[:, node.feature] <= node.threshold
    yl, yr = y[mask], y[~mask]
    child = 0.0
    for part in (yl, yr):
        if part.size:
            q = part.mean()
            child += 2 * q * (1 - q) * part.size
    out[node.feature] += max(parent - child, 0.0)
    if node.left != idx:
        _accumulate_importance(nodes, x[mask], yl, node.left, out)
    if node.right != idx:
        _accumulate_importance(nodes, x[~mask], yr, node.right, out)


def predict(tree: TreeArrays, feats: torch.Tensor, depth: int) -> torch.Tensor:
    """P(continue) for a batch of (B, 6) feature rows."""
    return tree_predict(tree, torch.atleast_2d(feats), depth)


@dataclasses.dataclass
class DecisionTree:
    arrays: TreeArrays
    depth: int
    feature_importance: np.ndarray  # (6,) normalized Gini importance


def tree_arrays(feature, threshold, left, right, value,
                device="cpu") -> TreeArrays:
    """:class:`TreeArrays` from array-likes (e.g. a checkpoint's ``tree_*``)."""
    return TreeArrays(
        feature=torch.as_tensor(np.array(feature, np.int32), device=device),
        threshold=torch.as_tensor(np.array(threshold, np.float32),
                                  device=device),
        left=torch.as_tensor(np.array(left, np.int32), device=device),
        right=torch.as_tensor(np.array(right, np.int32), device=device),
        value=torch.as_tensor(np.array(value, np.float32), device=device))


def train_tree(feats: np.ndarray, labels: np.ndarray, *,
               max_depth: int = 10, min_leaf: int = 16,
               device="cpu") -> DecisionTree:
    """Greedy CART. ``labels`` are 1 = keep searching, 0 = safe to stop."""
    feats = np.asarray(feats, np.float32)
    labels = np.asarray(labels, np.int32)
    if feats.ndim != 2:
        raise ValueError("features must be (N, F)")
    nodes: list[_Node] = []
    _grow(feats, labels, 0, max_depth, min_leaf, nodes)
    importance = np.zeros(feats.shape[1], np.float64)
    _accumulate_importance(nodes, feats, labels, 0, importance)
    s = importance.sum()
    importance = importance / s if s > 0 else importance
    arrays = tree_arrays([n.feature for n in nodes],
                         [n.threshold for n in nodes],
                         [n.left for n in nodes], [n.right for n in nodes],
                         [n.value for n in nodes], device=device)
    return DecisionTree(arrays=arrays, depth=max_depth,
                        feature_importance=importance)
