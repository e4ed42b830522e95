"""Launch wrappers of the fused wave-hop CUDA kernel (``csrc/fused_hop.cu``).

:func:`fused_hop_cuda` replaces ``repro/kernels/fused_hop.py::
fused_hop_pallas`` in its three score modes (``f32``, ``sq8``, ``pq``).
The kernel advances every lane of a wave ``hops`` beam expansions
(frontier, adjacency row, seen/live dedup, score, stable merge, counters,
hop cap, decision-tree check) and equals
:func:`repro_torch.kernels.ref.fused_hop` bit for bit; a launch with
``hops = max_hops`` carries every lane to retirement.
:func:`fused_hop_paged_cuda` replaces ``fused_hop_paged_pallas``: the same
kernel in its paged mode, with ``seen`` in a page pool reached through a
page table, equal to :func:`repro_torch.kernels.ref.fused_hop_paged` bit
for bit, pool included.  See the source's header for the design and the
bound.

The wrappers check devices, types, shapes and contiguity, allocate the
new pool and counters with ``torch.empty``, launch on PyTorch's current
stream and raise if the launch was refused.  ``hs.seen`` (the dense rows
or the page pool) is updated in place.  With ``lane_base`` (B,) int32 the
tables are stacked, ``adj_pad`` (T, n+1, R), ``t0`` (T, n+1, w) and
``live_pad`` (T, n+1), and lane b reads rows ``lane_base[b] + id`` of
their flattened ``(T (n+1), ·)`` views with local ids (sentinel n): every
entry must lie in ``[0, (T - 1)(n+1)]``, which is not checked.
``fused_hop_cuda.launches`` and ``fused_hop_paged_cuda.launches`` count
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import launch
from .ref import HopState, next_pow2

__all__ = ["fused_hop_cuda", "fused_hop_paged_cuda"]

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
        "t_value", "hot_first", "hot_ratio", "pt", "lane_base")]
        + [(f, _I) for f in (
            "B", "L", "R", "n", "d", "hops", "max_hops", "k", "eval_gap",
            "add_step", "tree_depth", "sort_len", "mode", "tw", "K", "ppl",
            "page_shift", "tree_nodes", "copy_vec")])

_MODES = {"f32": 0, "sq8": 1, "pq": 2}


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


def _copy_vec(table: torch.Tensor, row_bytes: int) -> int:
    """Bytes a row copy moves at once: the largest of 16, 8 and 4 that
    divides the row and the table's address, else 1."""
    for vec in (16, 8, 4):
        if row_bytes % vec == 0 and table.data_ptr() % vec == 0:
            return vec
    return 1


def _launch(hs: HopState, seen_shape, pt, adj_pad, queries, live_pad,
            mode: str, t0, t1, t2, tree, hot_first, hot_ratio, *, hops: int,
            max_hops: int, k: int, eval_gap: int, add_step: int,
            tree_depth: int, ppl: int = 0, page_shift: int = 0,
            lane_base=None) -> HopState:
    """Check every operand, fill ``HopArgs`` and launch once; ``seen``
    must have ``seen_shape`` (dense rows, or the page pool with ``pt``)."""
    dev = hs.ids.device
    if dev.type != "cuda":
        raise ValueError("fused_hop_cuda takes CUDA tensors")
    if mode not in _MODES:
        raise ValueError(f"unknown score mode {mode!r}")
    B, L = hs.ids.shape
    stack = () if lane_base is None else (adj_pad.shape[0],)
    if adj_pad.dim() != 2 + len(stack):
        raise ValueError("adj_pad must be (n+1, R), or (T, n+1, R) with "
                         "lane_base")
    n1, R = adj_pad.shape[-2:]
    d = queries.shape[1]
    tw = t0.shape[-1]
    if eval_gap < 1 or hops < 0 or L < 1 or R < 1:
        raise ValueError("eval_gap, L and R must be >= 1 and hops >= 0")
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
    a.seen = _check("seen", hs.seen, u8, seen_shape, dev)
    if pt is not None:
        a.pt = _check("pt", pt, i32, (B, ppl), dev)
        a.ppl, a.page_shift = ppl, page_shift
    if lane_base is not None:
        a.lane_base = _check("lane_base", lane_base, i32, (B,), dev)
    a.adj = _check("adj_pad", adj_pad, i32, (*stack, n1, R), dev)
    a.queries = _check("queries", queries, f32, (B, d), dev)
    a.mode, a.tw, a.K = _MODES[mode], tw, 0
    if mode == "f32":
        a.table = _check("table", t0, f32, (*stack, n1, d), dev)
    elif mode == "sq8":
        a.table = _check("codes", t0, torch.int8, (*stack, n1, d), dev)
        a.t1 = _check("scale", t1, f32, (d,), dev)
        a.t2 = _check("zero", t2, f32, (d,), dev)
    else:
        a.table = _check("codes", t0, torch.uint8, (*stack, n1, tw), dev)
        if t1 is None or t1.dim() != 3:
            raise ValueError("pq mode needs (B, M, K) LUTs")
        a.K = t1.shape[2]
        a.t1 = _check("luts", t1, f32, (B, tw, a.K), dev)
    a.live = (None if live_pad is None
              else _check("live_pad", live_pad, u8, (*stack, n1), dev))
    a.copy_vec = _copy_vec(t0, tw * 4 if mode == "f32" else tw)
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
        a.tree_nodes = T
    a.B, a.L, a.R, a.n, a.d = B, L, R, n1 - 1, d
    a.hops, a.max_hops, a.k, a.eval_gap = hops, max_hops, k, eval_gap
    a.add_step, a.tree_depth, a.sort_len = add_step, tree_depth, sort_len
    launch("fused_hop", "dqf_fused_hop", a, dev, "fused_hop")
    return HopState(ids=outs["ids"], dists=outs["dists"],
                    expanded=outs["expanded"], seen=hs.seen,
                    active=outs["active"], dist_count=outs["dist_count"],
                    update_count=outs["update_count"], hops=outs["hops"],
                    terminated=outs["terminated"],
                    evals_done=outs["evals_done"], stop_at=outs["stop_at"])



def fused_hop_cuda(hs: HopState, adj_pad, queries, live_pad, mode: str, t0,
                   t1=None, t2=None, tree=None, hot_first=None,
                   hot_ratio=None, *, hops: int, max_hops: int, k: int = 1,
                   eval_gap: int = 1, add_step: int = 0,
                   tree_depth: int = 1, lane_base=None) -> HopState:
    """One launch: ``hops`` fused expansions of every lane (CUDA tensors).

    ``mode``, ``t0``, ``t1``, ``t2`` and ``lane_base`` as in
    :func:`repro_torch.kernels.ref.fused_hop`.
    """
    out = _launch(hs, (hs.ids.shape[0], adj_pad.shape[-2]), None, adj_pad,
                  queries, live_pad, mode, t0, t1, t2, tree, hot_first,
                  hot_ratio, hops=hops, max_hops=max_hops, k=k,
                  eval_gap=eval_gap, add_step=add_step,
                  tree_depth=tree_depth, lane_base=lane_base)
    fused_hop_cuda.launches += 1
    return out


def fused_hop_paged_cuda(hs: HopState, pt, adj_pad, queries, live_pad,
                         mode: str, t0, t1=None, t2=None, tree=None,
                         hot_first=None, hot_ratio=None, *, page_cols: int,
                         hops: int, max_hops: int, k: int = 1,
                         eval_gap: int = 1, add_step: int = 0,
                         tree_depth: int = 1, lane_base=None) -> HopState:
    """One launch of the paged mode (CUDA tensors): ``hs.seen`` is the page
    pool ``(n_pages, page_cols)`` bool, updated in place, and ``pt`` the
    ``(B, ceil((n+1) / page_cols))`` int32 page table, as in
    :func:`repro_torch.kernels.ref.fused_hop_paged`.  The pages of active
    lanes must be distinct; lanes that share pages must be inactive with
    identical state (the caller's contract, not checked)."""
    if page_cols < 1 or page_cols & (page_cols - 1):
        raise ValueError(f"page_cols must be a power of two, got {page_cols}")
    if hs.seen.dim() != 2 or hs.seen.shape[1] != page_cols:
        raise ValueError(f"the page pool must be (n_pages, {page_cols}), "
                         f"got {tuple(hs.seen.shape)}")
    ppl = -(-adj_pad.shape[-2] // page_cols)
    out = _launch(hs, (hs.seen.shape[0], page_cols), pt, adj_pad, queries,
                  live_pad, mode, t0, t1, t2, tree, hot_first, hot_ratio,
                  hops=hops, max_hops=max_hops, k=k, eval_gap=eval_gap,
                  add_step=add_step, tree_depth=tree_depth, ppl=ppl,
                  page_shift=page_cols.bit_length() - 1, lane_base=lane_base)
    fused_hop_paged_cuda.launches += 1
    return out


fused_hop_cuda.launches = 0
fused_hop_paged_cuda.launches = 0
