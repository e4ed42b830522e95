"""Launch wrapper of the neighbour gather + distance kernel
(``csrc/gather_distances.cu``).

Replaces ``repro/kernels/gather_distance.py::gather_distances_pallas``:
(B, R) squared L2 of query b against ``x_pad[nbrs[b, r]]``, equal to
:func:`repro_torch.kernels.ref.gather_distances` bit for bit (the fused
hop's f32 score).  As in the JAX package, the hop subsumes it; the public
dispatch is :func:`repro_torch.kernels.ops.gather_distances`.

``gather_distances_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import launch, require

__all__ = ["gather_distances_cuda"]


class _GatherArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "x_pad", "nbrs", "out")]
                + [(f, ctypes.c_int32) for f in ("B", "R", "d")])


def gather_distances_cuda(queries: torch.Tensor, x_pad: torch.Tensor,
                          nbrs: torch.Tensor) -> torch.Tensor:
    """(B, R) squared L2 of (B, d) float32 queries against the rows
    ``nbrs`` (B, R) int32, ids in [0, n], of the (n+1, d) float32
    ``x_pad`` (CUDA tensors)."""
    what = "gather_distances_cuda"
    dev = require(what, "queries", queries, torch.float32, 2)
    require(what, "x_pad", x_pad, torch.float32, 2, dev)
    require(what, "nbrs", nbrs, torch.int32, 2, dev)
    B, d = queries.shape
    R = nbrs.shape[1]
    if x_pad.shape[1] != d or nbrs.shape[0] != B:
        raise ValueError(f"{what}: queries (B, d), x_pad (n+1, d) and nbrs "
                         f"(B, R) disagree in shape")
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    args = _GatherArgs(queries.data_ptr(), x_pad.data_ptr(), nbrs.data_ptr(),
                       out.data_ptr(), B, R, d)
    launch("gather_distances", "dqf_gather_distances", args, dev,
           "gather_distances")
    gather_distances_cuda.launches += 1
    return out


gather_distances_cuda.launches = 0
