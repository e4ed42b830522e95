"""Public wrappers for the port's kernels.

Dispatch follows the device of the tensors and nothing else: a CUDA
tensor goes to the hand-written kernel (which launches or raises), a CPU
tensor goes to the plain version in :mod:`repro_torch.kernels.ref`.
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import ref
from .fused_hop import fused_hop_cuda

__all__ = ["table_spec", "fused_hop"]


def table_spec(table):
    """Unpack a score table into the fused-hop kernel's ``(mode, t0)``.

    Only the float32 padded row table exists in the port so far; the
    quantized tables come with their slice.
    """
    if isinstance(table, torch.Tensor):
        if table.dtype != torch.float32 or table.dim() != 2:
            raise TypeError("fused hop needs a (n+1, d) float32 row table")
        return "f32", table
    raise TypeError(
        f"fused hop needs a device-resident score table, got "
        f"{type(table).__name__}")


def fused_hop(hs: ref.HopState, adj_pad, queries, live_pad, table,
              tree=None, hot_first=None, hot_ratio=None, *, hops: int,
              max_hops: int, k: int = 1, eval_gap: int = 1,
              add_step: int = 0, tree_depth: int = 1) -> ref.HopState:
    """Advance a wave ``hops`` fused beam expansions (one kernel launch on
    the card).  ``hs.seen`` is updated in place."""
    mode, t0 = table_spec(table)
    kw = dict(hops=hops, max_hops=max_hops, k=k, eval_gap=eval_gap,
              add_step=add_step, tree_depth=tree_depth)
    if t0.device.type == "cpu":
        return ref.fused_hop(hs, adj_pad, queries, live_pad, mode, t0, tree,
                             hot_first, hot_ratio, **kw)
    if t0.device.type != "cuda":
        raise ValueError(f"no fused hop kernel for device {t0.device}")
    return fused_hop_cuda(hs, adj_pad, queries, live_pad, t0, tree,
                          hot_first, hot_ratio, **kw)
