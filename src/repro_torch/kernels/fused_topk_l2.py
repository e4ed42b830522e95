"""Launch wrapper of the brute-force top-k CUDA kernel (``csrc/fused_topk_l2.cu``).

Replaces ``repro/kernels/fused_scorer.py::fused_topk_l2_pallas``, the hot
phase of ``hot_mode="mxu"``.  The kernel scores every (query, row) pair by
``(|q|² + |x|²) − 2 q·x`` and keeps each query's k nearest in (dist, id)
order; it equals :func:`repro_torch.kernels.ref.fused_topk_l2` bit for bit.
Its rows are split into P contiguous ranges, as many as fill every SM's
block slots once; each block keeps a threshold-filtered top-k of its range
for 32 queries, and a second launch from the same entry point merges the P
lists in (dist, id) order.  For k > 448 (a threshold merge sorts at most
512 entries in one warp's registers) the first launch sorts each (query,
range of up to 8192 rows) whole instead; k has no limit but the device
memory of the ``(B, P, k)`` scratch.  See the source's header for the
design and its bound.

The wrapper checks devices, types, shapes, contiguity and k >= 1,
allocates the outputs and two ``(B, P, k)`` scratch lists with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch was refused.  ``fused_topk_l2_cuda.launches`` counts calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._launch import launch, require

__all__ = ["fused_topk_l2_cuda"]


class _TopkArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "x", "part_keys",
                                                "part_ids", "tree_keys",
                                                "tree_ids", "dists", "ids")]
                + [(f, ctypes.c_int32) for f in ("B", "N", "d", "k", "P")])


@functools.lru_cache(maxsize=64)
def _row_ranges(dev: torch.device, B: int, N: int, k: int) -> int:
    """P, the number of row ranges the kernel splits N rows into for B
    queries and k on ``dev`` (the source decides, from the card's SM
    count); kept per shape, so a call of a shape seen before costs no
    lookup."""
    fn = _build.load("fused_topk_l2").dqf_fused_topk_l2_parts
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return fn(B, N, k, sms)


def fused_topk_l2_cuda(q: torch.Tensor, x: torch.Tensor, *, k: int):
    """(dists, ids), both (B, k), of the k nearest rows of ``x`` per query
    (CUDA tensors, float32)."""
    dev = require("fused_topk_l2_cuda", "q", q, torch.float32, 2)
    require("fused_topk_l2_cuda", "x", x, torch.float32, 2, dev)
    B, d = q.shape
    N = x.shape[0]
    if x.shape[1] != d:
        raise ValueError(f"x has width {x.shape[1]}, queries {d}")
    if k < 1 or N < 1:
        raise ValueError("fused_topk_l2 needs k >= 1 and at least one row")
    P = _row_ranges(dev, B, N, k)
    keys = torch.empty((2, B, P, k), dtype=torch.float32, device=dev)
    tie = torch.empty((2, B, P, k), dtype=torch.int32, device=dev)
    dists = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    half = B * P * k * 4                         # bytes of one scratch list
    a = _TopkArgs(q.data_ptr(), x.data_ptr(), keys.data_ptr(),
                  tie.data_ptr(), keys.data_ptr() + half,
                  tie.data_ptr() + half, dists.data_ptr(), ids.data_ptr(),
                  B, N, d, k, P)
    launch("fused_topk_l2", "dqf_fused_topk_l2", a, dev, "fused_topk_l2")
    fused_topk_l2_cuda.launches += 1
    return dists, ids


fused_topk_l2_cuda.launches = 0
