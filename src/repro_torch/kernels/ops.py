"""Public wrappers for the port's kernels.

Dispatch follows the device of the tensors and nothing else: a CUDA
tensor goes to the hand-written kernel (which launches or raises), a CPU
tensor goes to the plain version in :mod:`repro_torch.kernels.ref`.
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import ref
from .fused_hop import fused_hop_cuda, fused_hop_paged_cuda
from .fused_topk_l2 import fused_topk_l2_cuda

__all__ = ["table_spec", "fused_hop", "fused_hop_paged", "fused_topk_l2"]


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


def table_spec(table):
    """Unpack a score table into the fused-hop kernel's
    ``(mode, t0, t1, t2)``: a float32 ``x_pad``, or a device table that
    gives its own (``SQTable``, ``PQView``: ``spec()``)."""
    if isinstance(table, torch.Tensor):
        if table.dtype != torch.float32 or table.dim() != 2:
            raise TypeError("fused hop needs a (n+1, d) float32 row table")
        return "f32", table, None, None
    if not callable(getattr(table, "spec", None)):
        raise TypeError(
            f"fused hop needs a device-resident score table, got "
            f"{type(table).__name__}")
    return table.spec()


def fused_hop(hs: ref.HopState, adj_pad, queries, live_pad, table,
              tree=None, hot_first=None, hot_ratio=None, *, hops: int,
              max_hops: int, k: int = 1, eval_gap: int = 1,
              add_step: int = 0, tree_depth: int = 1) -> ref.HopState:
    """Advance a wave ``hops`` fused beam expansions (one kernel launch on
    the card).  ``hs.seen`` is updated in place."""
    mode, t0, t1, t2 = table_spec(table)
    kw = dict(hops=hops, max_hops=max_hops, k=k, eval_gap=eval_gap,
              add_step=add_step, tree_depth=tree_depth)
    fn = ref.fused_hop if _device_type(t0) == "cpu" else fused_hop_cuda
    return fn(hs, adj_pad, queries, live_pad, mode, t0, t1, t2, tree,
              hot_first, hot_ratio, **kw)


def fused_hop_paged(hs: ref.HopState, pt, adj_pad, queries, live_pad, table,
                    tree=None, hot_first=None, hot_ratio=None, *,
                    page_cols: int, hops: int, max_hops: int, k: int = 1,
                    eval_gap: int = 1, add_step: int = 0,
                    tree_depth: int = 1) -> ref.HopState:
    """:func:`fused_hop` with ``hs.seen`` the page pool ``(n_pages,
    page_cols)`` and ``pt`` the lanes' page table (one launch on the
    card).  The pool is updated in place and returned in ``seen``."""
    mode, t0, t1, t2 = table_spec(table)
    kw = dict(page_cols=page_cols, hops=hops, max_hops=max_hops, k=k,
              eval_gap=eval_gap, add_step=add_step, tree_depth=tree_depth)
    fn = (ref.fused_hop_paged if _device_type(t0) == "cpu"
          else fused_hop_paged_cuda)
    return fn(hs, pt, adj_pad, queries, live_pad, mode, t0, t1, t2, tree,
              hot_first, hot_ratio, **kw)
