"""Public wrappers for the port's kernels.

Dispatch follows the device of the tensors and nothing else: a CUDA
tensor goes to the hand-written kernel (which launches or raises), a CPU
tensor goes to the plain version in :mod:`repro_torch.kernels.ref`.
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import ref
from .distance import pairwise_l2_cuda
from .fused_hop import fused_hop_cuda, fused_hop_paged_cuda
from .fused_topk_l2 import fused_topk_l2_cuda
from .gather_distance import gather_distances_cuda
from .pq_adc import pq_adc_cuda
from .sq_distance import sq8_pairwise_l2_cuda
from .topk_merge import pool_merge_cuda

__all__ = ["table_spec", "fused_hop", "fused_hop_paged", "fused_topk_l2",
           "pairwise_l2", "sq8_pairwise_l2", "pq_adc", "pool_merge",
           "gather_distances"]


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


def fused_topk_l2(q: torch.Tensor, x: torch.Tensor, *, k: int):
    """(dists, ids), both (B, k): the k nearest rows of ``x`` per query by
    squared L2, ties to the smaller id, k > N padded (+inf, N)."""
    if _device_type(q) == "cpu":
        return ref.fused_topk_l2(q, x, k=k)
    return fused_topk_l2_cuda(q, x, k=k)


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, N) squared L2 of every query against every row as
    ``(|q|² + |x|²) − 2 q·x`` (it may be slightly negative)."""
    if _device_type(q) == "cpu":
        return ref.pairwise_l2(q, x)
    return pairwise_l2_cuda(q, x)


def sq8_pairwise_l2(q: torch.Tensor, codes: torch.Tensor,
                    scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """(B, N) squared L2 of every query against every int8 row decoded as
    ``code * scale + zero``."""
    if _device_type(q) == "cpu":
        return ref.sq8_pairwise_l2(q, codes, scale, zero)
    return sq8_pairwise_l2_cuda(q, codes, scale, zero)


def pq_adc(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, N) PQ asymmetric distances ``Σ_m luts[b, m, codes[i, m]]`` from
    (B, M, K) LUTs and (N, M) codes."""
    if _device_type(luts) == "cpu":
        return ref.pq_adc(luts, codes)
    return pq_adc_cuda(luts, codes)


def pool_merge(pool_dists, pool_ids, cand_dists, cand_ids):
    """(dists, ids), both (B, L): the L smallest of a (B, L) pool and (B, C)
    candidates per row, sorted, equal keys in input order: a stable sort of
    ``[pool | candidates]``.  Any pool is taken; on the card a sorted one
    with L <= 64 and C <= 32 is merged by rank, any other row sorted.  NaN
    keys sort last and -0.0 ties +0.0, as in the plain version."""
    if _device_type(pool_dists) == "cpu":
        return ref.pool_merge(pool_dists, pool_ids, cand_dists, cand_ids)
    return pool_merge_cuda(pool_dists, pool_ids, cand_dists, cand_ids)


def gather_distances(queries: torch.Tensor, x_pad: torch.Tensor,
                     nbrs: torch.Tensor) -> torch.Tensor:
    """(B, R) squared L2 of query b against ``x_pad[nbrs[b, r]]``, ids in
    [0, n] (sentinel n)."""
    if _device_type(queries) == "cpu":
        return ref.gather_distances(queries, x_pad, nbrs)
    return gather_distances_cuda(queries, x_pad, nbrs)


def table_spec(table):
    """Unpack a score table into the fused-hop kernel's
    ``(mode, t0, t1, t2)``: a float32 ``x_pad``, or a device table that
    gives its own (``SQTable``, ``PQView``: ``spec()``).  A
    :class:`~repro_torch.tiering.TieredTable` raises, as in the reference:
    its host fetches cannot run inside the kernel, so tiered lanes keep
    the composed path (the select-after-score seam)."""
    if isinstance(table, torch.Tensor):
        if table.dtype != torch.float32 or table.dim() not in (2, 3):
            raise TypeError("fused hop needs a (n+1, d) float32 row table, "
                            "or a (T, n+1, d) stack of them")
        return "f32", table, None, None
    if not callable(getattr(table, "spec", None)):
        raise TypeError(
            f"fused hop needs a device-resident score table, got "
            f"{type(table).__name__} — tiered lanes must use the composed "
            "path")
    return table.spec()


def fused_hop(hs: ref.HopState, adj_pad, queries, live_pad, table,
              tree=None, hot_first=None, hot_ratio=None, *, hops: int,
              max_hops: int, k: int = 1, eval_gap: int = 1,
              add_step: int = 0, tree_depth: int = 1,
              lane_base=None) -> ref.HopState:
    """Advance a wave ``hops`` fused beam expansions (one kernel launch on
    the card).  ``hs.seen`` is updated in place.  ``lane_base`` (B,)
    int32 reads lane b's rows at that offset of stacked tables (see
    :func:`repro_torch.kernels.ref.fused_hop`)."""
    mode, t0, t1, t2 = table_spec(table)
    kw = dict(hops=hops, max_hops=max_hops, k=k, eval_gap=eval_gap,
              add_step=add_step, tree_depth=tree_depth, lane_base=lane_base)
    fn = ref.fused_hop if _device_type(t0) == "cpu" else fused_hop_cuda
    return fn(hs, adj_pad, queries, live_pad, mode, t0, t1, t2, tree,
              hot_first, hot_ratio, **kw)


def fused_hop_paged(hs: ref.HopState, pt, adj_pad, queries, live_pad, table,
                    tree=None, hot_first=None, hot_ratio=None, *,
                    page_cols: int, hops: int, max_hops: int, k: int = 1,
                    eval_gap: int = 1, add_step: int = 0,
                    tree_depth: int = 1, lane_base=None) -> ref.HopState:
    """:func:`fused_hop` with ``hs.seen`` the page pool ``(n_pages,
    page_cols)`` and ``pt`` the lanes' page table (one launch on the
    card).  The pool is updated in place and returned in ``seen``;
    ``lane_base`` reads stacked tables as in :func:`fused_hop`."""
    mode, t0, t1, t2 = table_spec(table)
    kw = dict(page_cols=page_cols, hops=hops, max_hops=max_hops, k=k,
              eval_gap=eval_gap, add_step=add_step, tree_depth=tree_depth,
              lane_base=lane_base)
    fn = (ref.fused_hop_paged if _device_type(t0) == "cpu"
          else fused_hop_paged_cuda)
    return fn(hs, pt, adj_pad, queries, live_pad, mode, t0, t1, t2, tree,
              hot_first, hot_ratio, **kw)
