"""Launch wrapper of the brute-force top-k CUDA kernel (``csrc/fused_topk_l2.cu``).

Replaces ``repro/kernels/fused_scorer.py::fused_topk_l2_pallas``, the hot
phase of ``hot_mode="mxu"``.  The kernel scores every (query, row) pair by
``(|q|² + |x|²) − 2 q·x`` and keeps each query's k nearest in (dist, id)
order; it equals :func:`repro_torch.kernels.ref.fused_topk_l2` bit for bit.
See the source's header for its design and its bound.

The wrapper checks devices, types, shapes and contiguity, allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch was refused.  ``fused_topk_l2_cuda.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import launch, require

__all__ = ["fused_topk_l2_cuda"]


class _TopkArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "x", "dists", "ids")]
                + [(f, ctypes.c_int32) for f in ("B", "N", "d", "k")])


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
    dists = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    a = _TopkArgs(q.data_ptr(), x.data_ptr(), dists.data_ptr(),
                  ids.data_ptr(), B, N, d, k)
    launch("fused_topk_l2", "dqf_fused_topk_l2", a, dev, "fused_topk_l2")
    fused_topk_l2_cuda.launches += 1
    return dists, ids


fused_topk_l2_cuda.launches = 0
