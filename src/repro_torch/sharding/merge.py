"""Cross-shard top-k merge (``repro/sharding/merge.py``) on ``pool_merge``.

Per-shard searches return candidates in *shard-major* order: shard 0's
pool (sorted ascending), then shard 1's, and so on.  The merge ranks that
concatenation by distance with ties broken by position — exactly the
permutation a stable argsort produces.  On the device it is one
:func:`repro_torch.kernels.ops.pool_merge` call, a stable sort of
``[pool | candidates]``: the pool is the concatenation's first ``k``
slots and the candidates the rest, so the result is the stable top-k of
the whole concatenation, bit for bit with the host oracle
:func:`merge_topk_host` (``np.argsort(kind="stable")``).

Candidates are (global id, distance) pairs; invalid slots carry id ``-1``
and distance ``INF_DIST``.  When the concatenation is shorter than ``k``
it is padded with ``+inf`` keys and id ``-1``, which sort after every
real slot, as the reference pads its network.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops

__all__ = ["merge_topk", "merge_topk_host", "gather_candidates",
           "gather_packed"]


def merge_topk(dists: torch.Tensor, gids: torch.Tensor, k: int):
    """Merge per-shard candidate lists into one global top-k (device).

    ``dists``/``gids`` are ``(S, B, m)`` tensors: shard-major candidates
    per query (each shard's ``m`` slots sorted ascending, invalid slots
    ``INF``/``-1``).  Returns ``(ids, dists)`` of shape ``(B, k)`` (int32,
    float32) — the stable top-k of the shard-major concatenation.  The
    tensors' device picks the ``pool_merge`` kernel or its plain version.
    """
    S, B, m = dists.shape
    cat_d = dists.permute(1, 0, 2).reshape(B, S * m).to(torch.float32)
    cat_g = gids.permute(1, 0, 2).reshape(B, S * m).to(torch.int32)
    pad = k - S * m
    if pad > 0:
        cat_d = torch.cat([cat_d, torch.full((B, pad), float("inf"),
                                             device=cat_d.device)], dim=1)
        cat_g = torch.cat([cat_g, torch.full((B, pad), -1, dtype=torch.int32,
                                             device=cat_g.device)], dim=1)
    out_d, out_i = kops.pool_merge(
        cat_d[:, :k].contiguous(), cat_g[:, :k].contiguous(),
        cat_d[:, k:].contiguous(), cat_g[:, k:].contiguous())
    return out_i, out_d


def merge_topk_host(per_shard_ids, per_shard_dists, k: int):
    """Single-shard oracle merge: stable argsort over the shard-major
    concatenation on the host.  ``per_shard_ids``/``per_shard_dists`` are
    sequences of ``(B, m)`` arrays (one per shard, shard-major order).
    """
    cat_i = np.concatenate([np.asarray(a) for a in per_shard_ids], axis=1)
    cat_d = np.concatenate(
        [np.asarray(d, np.float32) for d in per_shard_dists], axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(cat_i, order, 1),
            np.take_along_axis(cat_d, order, 1))


_BY_BITS = (torch.float32, torch.int32, torch.float64, torch.int64)


def _int32_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` flat as int32 words: 4-byte and 8-byte dtypes by their bits,
    bool and the narrower integers widened."""
    t = t.contiguous()
    if t.dtype in _BY_BITS:
        return t.view(torch.int32).reshape(-1)
    return t.to(torch.int32).reshape(-1)


def _from_int32(words: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_int32_view` for an ``(n, words)`` block."""
    words = words.contiguous()
    n = words.shape[0]
    if like.dtype in _BY_BITS:
        out = words.view(like.dtype)
    elif like.dtype == torch.bool:
        out = words != 0
    else:
        out = words.to(like.dtype)
    return out.reshape(n, *like.shape)


def gather_packed(tensors, group, n: int) -> list:
    """Every rank's ``tensors`` from ONE ``all_gather`` over ``group`` (of
    ``n`` ranks): each tensor is packed into one int32 buffer by its bits
    (bool and small integers widened), and comes back stacked rank-major,
    ``(n, *shape)`` in its own dtype.  Every rank must pass tensors of the
    same shapes and dtypes."""
    import torch.distributed as dist

    words = [_int32_view(t) for t in tensors]
    flat = torch.cat(words)
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    both = torch.stack(parts)                         # (n, total)
    out, off = [], 0
    for w, t in zip(words, tensors):
        out.append(_from_int32(both[:, off:off + w.numel()], t))
        off += w.numel()
    return out


def gather_candidates(dists: torch.Tensor, gids: torch.Tensor, group,
                      n: int):
    """Every rank's ``(B, k)`` candidates stacked rank-major, ``(n, B,
    k)`` float32 dists and int32 ids, from one ``all_gather`` over
    ``group`` (of ``n`` ranks) with both packed as int32 bits
    (:func:`gather_packed`).  Rank-major is the shard-major order
    :func:`merge_topk` breaks ties by."""
    d, g = gather_packed([dists.to(torch.float32), gids.to(torch.int32)],
                         group, n)
    return d, g
