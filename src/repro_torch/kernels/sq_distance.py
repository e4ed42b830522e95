"""Launch wrapper of the int8 scan kernel (``csrc/pairwise_l2.cu``, SQ8
mode).

Replaces ``repro/kernels/sq_distance.py::sq8_pairwise_l2_pallas``, the
scan of the sq8 Full Index: (B, N) squared L2 of float32 queries against
int8 rows decoded as ``code * scale + zero``.  It runs the float32 scan's
tensor-core loop of :mod:`repro_torch.kernels.distance` with the codes
staged as int8: a code is exact in TF32, so the product is ``(q∘scale)·code``
in two TF32 products (the scaled query split in two parts) plus ``q·zero``.
It is held to the float32 scan's contract over the decoded rows x:
``|kernel − ref.sq8_pairwise_l2| ≤ 1e-5 · (|q|² + |x|²)`` elementwise, not
bit for bit; the norms are :func:`repro_torch.kernels.ref.sq8_pairwise_l2`'s
bit for bit (the rows decoded with its two roundings).

``sq8_pairwise_l2_cuda.launches`` counts launches.
"""

from __future__ import annotations

import torch

from ._launch import require
from .distance import MODE_SQ8, launch_pairwise

__all__ = ["sq8_pairwise_l2_cuda"]


def sq8_pairwise_l2_cuda(q: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor,
                         zero: torch.Tensor) -> torch.Tensor:
    """(B, N) squared L2 of (B, d) float32 queries against (N, d) int8
    codes with (d,) float32 ``scale`` and ``zero`` (CUDA tensors)."""
    what = "sq8_pairwise_l2_cuda"
    dev = require(what, "q", q, torch.float32, 2)
    require(what, "codes", codes, torch.int8, 2, dev)
    require(what, "scale", scale, torch.float32, 1, dev)
    require(what, "zero", zero, torch.float32, 1, dev)
    d = q.shape[1]
    if scale.shape[0] != d or zero.shape[0] != d:
        raise ValueError(f"{what}: scale and zero need {d} entries")
    out = launch_pairwise(q, codes, scale, zero, MODE_SQ8, "sq8_pairwise_l2")
    if out.numel():
        sq8_pairwise_l2_cuda.launches += 1
    return out


sq8_pairwise_l2_cuda.launches = 0
