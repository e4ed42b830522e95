"""Launch wrapper of the fused wave-hop CUDA kernel (``csrc/fused_hop.cu``).

Replaces ``repro/kernels/fused_hop.py::fused_hop_pallas`` in its three
score modes (``f32``, ``sq8``, ``pq``).  The kernel advances every lane of
a wave ``hops`` beam expansions (frontier, adjacency row, seen/live dedup,
score, stable merge, counters, hop cap, decision-tree check) and equals
:func:`repro_torch.kernels.ref.fused_hop` bit for bit.  See the source's
header for its design and its bound.

The wrapper checks devices, types, shapes and contiguity, allocates the
new pool and counters with ``torch.empty``, launches on PyTorch's current
stream and raises if the launch was refused.  ``hs.seen`` is updated in
place.  ``fused_hop_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import HopState, next_pow2

__all__ = ["fused_hop_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int32


class _HopArgs(ctypes.Structure):
    _fields_ = ([(f, _P) for f in (
        "ids_in", "dists_in", "exp_in", "active_in", "dist_count_in",
        "update_count_in", "hops_in", "terminated_in", "evals_done_in",
        "stop_at_in", "ids_out", "dists_out", "exp_out", "active_out",
        "dist_count_out", "update_count_out", "hops_out", "terminated_out",
        "evals_done_out", "stop_at_out", "seen", "adj", "table", "t1", "t2",
        "queries", "live", "t_feature", "t_threshold", "t_left", "t_right",
        "t_value", "hot_first", "hot_ratio")]
        + [(f, _I) for f in (
            "B", "L", "R", "n", "d", "hops", "max_hops", "k", "eval_gap",
            "add_step", "tree_depth", "sort_len", "mode", "tw", "K")])

_MODES = {"f32": 0, "sq8": 1, "pq": 2}


def _lib():
    lib = _build.load("fused_hop")
    if lib.dqf_fused_hop.argtypes is None:
        lib.dqf_fused_hop.argtypes = [ctypes.POINTER(_HopArgs), _P]
        lib.dqf_fused_hop.restype = ctypes.c_int
        lib.dqf_error_string.argtypes = [ctypes.c_int]
        lib.dqf_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def fused_hop_cuda(hs: HopState, adj_pad, queries, live_pad, mode: str, t0,
                   t1=None, t2=None, tree=None, hot_first=None,
                   hot_ratio=None, *, hops: int, max_hops: int, k: int = 1,
                   eval_gap: int = 1, add_step: int = 0,
                   tree_depth: int = 1) -> HopState:
    """One launch: ``hops`` fused expansions of every lane (CUDA tensors).

    ``mode``, ``t0``, ``t1`` and ``t2`` as in
    :func:`repro_torch.kernels.ref.fused_hop`.
    """
    dev = hs.ids.device
    if dev.type != "cuda":
        raise ValueError("fused_hop_cuda takes CUDA tensors")
    if mode not in _MODES:
        raise ValueError(f"unknown score mode {mode!r}")
    B, L = hs.ids.shape
    n1, R = adj_pad.shape
    d = queries.shape[1]
    tw = t0.shape[1]
    if eval_gap < 1 or hops < 0:
        raise ValueError("eval_gap must be >= 1 and hops >= 0")
    sort_len = next_pow2(L + R)
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    a = _HopArgs()
    state_in = [("ids", i32, (B, L)), ("dists", f32, (B, L)),
                ("expanded", u8, (B, L)), ("active", u8, (B,)),
                ("dist_count", i32, (B,)), ("update_count", i32, (B,)),
                ("hops", i32, (B,)), ("terminated", u8, (B,)),
                ("evals_done", i32, (B,)), ("stop_at", i32, (B,))]
    c_names = ["ids", "dists", "exp", "active", "dist_count", "update_count",
               "hops", "terminated", "evals_done", "stop_at"]
    outs = {}
    for (field, dtype, shape), cname in zip(state_in, c_names):
        src = getattr(hs, field)
        setattr(a, cname + "_in", _check(field, src, dtype, shape, dev))
        outs[field] = torch.empty(shape, dtype=dtype, device=dev)
        setattr(a, cname + "_out", outs[field].data_ptr())
    a.seen = _check("seen", hs.seen, u8, (B, n1), dev)
    a.adj = _check("adj_pad", adj_pad, i32, (n1, R), dev)
    a.queries = _check("queries", queries, f32, (B, d), dev)
    a.mode, a.tw, a.K = _MODES[mode], tw, 0
    if mode == "f32":
        a.table = _check("table", t0, f32, (n1, d), dev)
    elif mode == "sq8":
        a.table = _check("codes", t0, torch.int8, (n1, d), dev)
        a.t1 = _check("scale", t1, f32, (d,), dev)
        a.t2 = _check("zero", t2, f32, (d,), dev)
    else:
        a.table = _check("codes", t0, torch.uint8, (n1, tw), dev)
        if t1 is None or t1.dim() != 3:
            raise ValueError("pq mode needs (B, M, K) LUTs")
        a.K = t1.shape[2]
        a.t1 = _check("luts", t1, f32, (B, tw, a.K), dev)
    a.live = (None if live_pad is None
              else _check("live_pad", live_pad, u8, (n1,), dev))
    if tree is not None:
        feature, threshold, left, right, value = tree
        T = feature.shape[0]
        a.t_feature = _check("tree.feature", feature, i32, (T,), dev)
        a.t_threshold = _check("tree.threshold", threshold, f32, (T,), dev)
        a.t_left = _check("tree.left", left, i32, (T,), dev)
        a.t_right = _check("tree.right", right, i32, (T,), dev)
        a.t_value = _check("tree.value", value, f32, (T,), dev)
        a.hot_first = _check("hot_first", hot_first, f32, (B,), dev)
        a.hot_ratio = _check("hot_ratio", hot_ratio, f32, (B,), dev)
    a.B, a.L, a.R, a.n, a.d = B, L, R, n1 - 1, d
    a.hops, a.max_hops, a.k, a.eval_gap = hops, max_hops, k, eval_gap
    a.add_step, a.tree_depth, a.sort_len = add_step, tree_depth, sort_len
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dqf_fused_hop(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError("fused_hop launch failed: "
                           + lib.dqf_error_string(err).decode())
    fused_hop_cuda.launches += 1
    return HopState(ids=outs["ids"], dists=outs["dists"],
                    expanded=outs["expanded"], seen=hs.seen,
                    active=outs["active"], dist_count=outs["dist_count"],
                    update_count=outs["update_count"], hops=outs["hops"],
                    terminated=outs["terminated"],
                    evals_done=outs["evals_done"], stop_at=outs["stop_at"])


fused_hop_cuda.launches = 0
