"""Launch wrapper of the PQ scan kernel (``csrc/pq_adc.cu``).

Replaces ``repro/kernels/pq_adc.py::pq_adc_pallas``, the scan of the pq
Full Index: (B, N) ``Σ_m luts[b, m, codes[i, m]]`` summed in
``ref.halving_sum`` order, equal to :func:`repro_torch.kernels.ref.pq_adc`
bit for bit, for any number of subspaces M and K <= 256 centroids.  Up
to 8 subspaces (the search's codes) the LUTs of 16 queries are staged
query innermost, one query a lane, two rows a warp without bank
conflicts; past 8, a thread takes a row.  See the source's header for the
design and the bound.

``pq_adc_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import launch, require

__all__ = ["pq_adc_cuda"]


class _PqArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("luts", "codes", "out")]
                + [(f, ctypes.c_int32) for f in ("B", "N", "M", "K", "qb")])


def pq_adc_cuda(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, N) ADC distances from (B, M, K) float32 LUTs and (N, M) uint8
    codes (CUDA tensors; every code below K)."""
    what = "pq_adc_cuda"
    dev = require(what, "luts", luts, torch.float32, 3)
    require(what, "codes", codes, torch.uint8, 2, dev)
    B, M, K = luts.shape
    N = codes.shape[0]
    if codes.shape[1] != M:
        raise ValueError(f"{what}: codes have {codes.shape[1]} subspaces, "
                         f"LUTs {M}")
    if M < 1 or not 1 <= K <= 256:
        raise ValueError(f"{what} takes subspaces of 1..256 centroids, got "
                         f"M={M}, K={K}")
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    args = _PqArgs(luts.data_ptr(), codes.data_ptr(), out.data_ptr(), B, N,
                   M, K, 0)
    launch("pq_adc", "dqf_pq_adc", args, dev, "pq_adc")
    pq_adc_cuda.launches += 1
    return out


pq_adc_cuda.launches = 0
