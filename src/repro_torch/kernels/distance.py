"""Launch wrapper of the pairwise squared-L2 CUDA kernel
(``csrc/pairwise_l2.cu``, F32 mode).

Replaces ``repro/kernels/distance.py::pairwise_l2_pallas``, the float32
scan entry point: (B, N) ``(|q|² + |x|²) − 2 q·x`` of every query against
every row.  The product runs on the tensor cores as 3xTF32: each operand
is split into a TF32 high part and a TF32 remainder, and three TF32
products (lo·hi + hi·lo + hi·hi) are summed in float32.  The norms and the
epilogue are :func:`repro_torch.kernels.ref.pairwise_l2`'s, so the result
is held to ``|kernel − ref.pairwise_l2| ≤ 1e-5 · (|q|² + |x|²)`` elementwise
(the tolerance the port meets against the JAX package), not bit for bit;
it may be slightly negative.  The SQ8 mode of the same source, launched by
:mod:`repro_torch.kernels.sq_distance`, runs the same loop over int8
codes (two TF32 products of the scaled query and the exact codes), under
the same tolerance over the decoded rows.  See the source's header for the
design and the bound.

``pairwise_l2_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import launch, require

__all__ = ["pairwise_l2_cuda"]

MODE_F32, MODE_SQ8 = 0, 1


class PairwiseArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "x", "scale", "zero",
                                                "out")]
                + [(f, ctypes.c_int32) for f in ("B", "N", "d", "mode")])


def launch_pairwise(q, x, scale, zero, mode: int, what: str) -> torch.Tensor:
    """(B, N) output of one launch in ``mode``; arguments already checked."""
    B, d = q.shape
    N = x.shape[0]
    if x.shape[1] != d:
        raise ValueError(f"{what}: rows have width {x.shape[1]}, queries {d}")
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()
    args = PairwiseArgs(q.data_ptr(), x.data_ptr(), ptr(scale), ptr(zero),
                        out.data_ptr(), B, N, d, mode)
    launch("pairwise_l2", "dqf_pairwise_l2", args, q.device, what)
    return out


def pairwise_l2_cuda(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, N) squared L2 of (B, d) queries against (N, d) rows (CUDA
    tensors, float32)."""
    dev = require("pairwise_l2_cuda", "q", q, torch.float32, 2)
    require("pairwise_l2_cuda", "x", x, torch.float32, 2, dev)
    out = launch_pairwise(q, x, None, None, MODE_F32, "pairwise_l2")
    if out.numel():
        pairwise_l2_cuda.launches += 1
    return out


pairwise_l2_cuda.launches = 0
