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

from . import _build

__all__ = ["fused_topk_l2_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int32


class _TopkArgs(ctypes.Structure):
    _fields_ = ([(f, _P) for f in ("q", "x", "dists", "ids")]
                + [(f, _I) for f in ("B", "N", "d", "k")])


def _lib():
    lib = _build.load("fused_topk_l2")
    if lib.dqf_fused_topk_l2.argtypes is None:
        lib.dqf_fused_topk_l2.argtypes = [ctypes.POINTER(_TopkArgs), _P]
        lib.dqf_fused_topk_l2.restype = ctypes.c_int
        lib.dqf_error_string.argtypes = [ctypes.c_int]
        lib.dqf_error_string.restype = ctypes.c_char_p
    return lib


def fused_topk_l2_cuda(q: torch.Tensor, x: torch.Tensor, *, k: int):
    """(dists, ids), both (B, k), of the k nearest rows of ``x`` per query
    (CUDA tensors, float32)."""
    dev = q.device
    if dev.type != "cuda" or x.device != dev:
        raise ValueError("fused_topk_l2_cuda takes CUDA tensors on one "
                         "device")
    for name, t in (("q", q), ("x", x)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dqf_fused_topk_l2(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError("fused_topk_l2 launch failed: "
                           + lib.dqf_error_string(err).decode())
    fused_topk_l2_cuda.launches += 1
    return dists, ids


fused_topk_l2_cuda.launches = 0
