"""Launch wrapper of the pool merge kernel (``csrc/pool_merge.cu``).

Replaces ``repro/kernels/topk_merge.py::pool_merge_pallas``: keep the L
smallest of a (B, L) pool and (B, C) candidates per row, sorted, equal to
:func:`repro_torch.kernels.ref.pool_merge` bit for bit, ties in the stable
order of the JAX ref (not the Pallas kernel's unstable one).  The kernel
takes any pool: a sorted one (the search's) with L <= 64 and C <= 32 is
merged by rank, any other row is sorted by the (key, position) network.
NaN keys sort last and -0.0 ties +0.0, as in the plain version.

``pool_merge_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import launch, require
from .ref import next_pow2

__all__ = ["pool_merge_cuda"]

# Shared memory a block may hold; a row whose network (8 bytes an entry)
# needs more is sorted in a global scratch (csrc/pool_merge.cu).
_SMEM_MAX = 227 * 1024


class _MergeArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "pool_dists", "pool_ids", "cand_dists", "cand_ids", "out_dists",
        "out_ids", "scratch")]
                + [(f, ctypes.c_int32) for f in ("B", "L", "C")])


def pool_merge_cuda(pool_dists: torch.Tensor, pool_ids: torch.Tensor,
                    cand_dists: torch.Tensor, cand_ids: torch.Tensor):
    """(dists, ids), both (B, L): the L smallest of pool ∪ candidates per
    row (float32 dists, int32 ids; CUDA tensors), any keys."""
    what = "pool_merge_cuda"
    dev = require(what, "pool_dists", pool_dists, torch.float32, 2)
    require(what, "pool_ids", pool_ids, torch.int32, 2, dev)
    require(what, "cand_dists", cand_dists, torch.float32, 2, dev)
    require(what, "cand_ids", cand_ids, torch.int32, 2, dev)
    B, L = pool_dists.shape
    C = cand_dists.shape[1]
    if (pool_ids.shape != (B, L) or cand_dists.shape[0] != B
            or cand_ids.shape != (B, C)):
        raise ValueError(f"{what}: pool (B, L) and candidates (B, C) "
                         f"disagree in shape")
    dists = torch.empty((B, L), dtype=torch.float32, device=dev)
    ids = torch.empty((B, L), dtype=torch.int32, device=dev)
    if dists.numel() == 0:
        return dists, ids
    S = next_pow2(L + C)
    scratch = (torch.empty(B * 2 * S, dtype=torch.int32, device=dev)
               if S * 8 > _SMEM_MAX else None)
    args = _MergeArgs(pool_dists.data_ptr(), pool_ids.data_ptr(),
                      cand_dists.data_ptr(), cand_ids.data_ptr(),
                      dists.data_ptr(), ids.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      B, L, C)
    launch("pool_merge", "dqf_pool_merge", args, dev, "pool_merge")
    pool_merge_cuda.launches += 1
    return dists, ids


pool_merge_cuda.launches = 0
