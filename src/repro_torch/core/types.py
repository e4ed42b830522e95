"""Shared types for the DQF core library (PyTorch port of ``repro.core.types``).

Conventions used across :mod:`repro_torch.core`:

* A graph over ``n`` points is a padded adjacency matrix ``(n, R) int32``.
  The sentinel neighbor id is ``n`` (one past the last row).  Callers pad the
  vector table with one extra row of ``PAD_VALUE`` so gathering the sentinel
  row yields a huge distance and the entry never enters a candidate pool.
* Distances are squared L2 (monotone in L2, cheaper).
* All search state is batched: leading axis = query lane.  Ids are int32
  tensors at every public boundary, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.tiering import TierConfig

# Value used for the padded sentinel row of a vector table.
PAD_VALUE = 1e9
# Distance assigned to invalid candidates (float32 3.0e38).
INF_DIST = float(torch.tensor(3.0e38, dtype=torch.float32))
INT_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Compressed Full Index configuration (``repro_torch.quant``)."""

    mode: str = "none"       # "none" | "sq8" (int8 scalar) | "pq" (product)
    pq_m: int = 8
    pq_bits: int = 8
    pq_iters: int = 15
    rerank_k: int = 64
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("none", "sq8", "pq"):
            raise ValueError(
                f"quant mode must be none|sq8|pq, got {self.mode}")
        if not (1 <= self.pq_bits <= 8):
            raise ValueError("pq_bits must be in [1, 8] (uint8 codes)")
        if self.rerank_k < 0:
            raise ValueError("rerank_k must be >= 0")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"


@dataclasses.dataclass(frozen=True)
class DQFConfig:
    """Configuration for the Dual-Index Query Framework (paper Table 4)."""

    # --- data contract ---
    dim: Optional[int] = None
    metric: str = "l2"

    # --- graph construction (§4.2) ---
    knn_k: int = 32
    out_degree: int = 32
    alpha_deg: float = 60.0
    n_entry: int = 8

    # --- dual index (§4.2.2) ---
    index_ratio: float = 0.005
    n_query_trigger: int = 10_000

    # --- search (§4.3) ---
    k: int = 10
    hot_pool: int = 32
    full_pool: int = 64
    eval_gap: int = 50
    add_step: int = 0
    tree_depth: int = 10
    max_hops: int = 512
    hot_mode: str = "graph"

    # --- fused wave-hop kernel (repro_torch.kernels.fused_hop) ---
    fused: bool = False
    fused_hops: int = 8

    # --- workload (§5.1.2) ---
    zipf_beta: float = 1.2

    # --- compressed Full Index ---
    quant: QuantConfig = QuantConfig()

    # --- tiered storage (repro_torch.tiering) ---
    tier: TierConfig = TierConfig()

    def __post_init__(self):
        if self.hot_mode not in ("graph", "mxu"):
            raise ValueError(f"hot_mode must be graph|mxu, got {self.hot_mode}")
        if not (0.0 < self.index_ratio <= 1.0):
            raise ValueError("index_ratio must be in (0, 1]")
        if self.metric != "l2":
            raise ValueError(
                f"metric must be 'l2' (squared L2 is the only implemented "
                f"metric), got {self.metric!r}")
        if self.dim is not None and self.dim <= 0:
            raise ValueError(f"dim must be positive, got {self.dim}")
        if self.fused_hops < 1:
            raise ValueError(
                f"fused_hops must be >= 1, got {self.fused_hops}")


class PoolState(NamedTuple):
    """Batched candidate pool, sorted ascending by distance."""

    ids: torch.Tensor        # (B, L) int32, sentinel n
    dists: torch.Tensor      # (B, L) float32, INF_DIST for empty slots
    expanded: torch.Tensor   # (B, L) bool


class SearchStats(NamedTuple):
    """Per-lane counters (paper Table 1 count features)."""

    dist_count: torch.Tensor        # (B,) int32
    update_count: torch.Tensor      # (B,) int32
    hops: torch.Tensor              # (B,) int32
    terminated_early: torch.Tensor  # (B,) bool


class SearchResult(NamedTuple):
    ids: torch.Tensor     # (B, k) int32
    dists: torch.Tensor   # (B, k) float32
    stats: SearchStats


class HotFeatures(NamedTuple):
    """Distance features frozen at the end of the hot phase (Table 1 a)."""

    first: torch.Tensor          # (B,)
    first_div_kth: torch.Tensor  # (B,)
