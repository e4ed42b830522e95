"""The frozen segment index of ``repro/serving/sharded.py``, on one card.

The database is row-partitioned into ``S`` segments; each segment gets
its own NSSG built offline (:func:`build_sharded_index`).  The reference
searches segment ``s`` on device ``s`` of a mesh and merges the
all-gathered per-segment top-k.  On one card :func:`sharded_search` runs
the ``S`` segments as ``S·B`` stacked lanes of one beam search: lane
``s·B + b`` is segment ``s`` and query ``b``, reading block ``s`` of the
stacked ``(S, n_seg+1, ·)`` tables through the hop's per-lane table base
(:class:`~repro_torch.core.beam_search.LaneTable`).  On the card that is
one ``fused_hop`` launch and one ``pool_merge`` launch a batch; on the
CPU the composed beam loop (``fused=False``, as the reference) and the
merge's plain version run.  Over a :class:`~repro_torch.distributed.mesh.Mesh`
the segments lie on the model axis, one a rank, as the reference places
them: each rank searches its segment's lanes for its data-axis slice of
the queries, the per-segment top-k go round the model axis
(``all_gather``) to the same merge, and the data-axis slices are
gathered, so every rank returns the whole answer.

Fault tolerance: :func:`merge_with_dropout` renormalizes the merge over
the segments that responded — a lost host degrades recall by roughly its
data share instead of failing the query.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import beam_search as bs
from repro_torch.core.dqf import resolve_device
from repro_torch.core.ssg import SSGParams, build_ssg
from repro_torch.core.types import DQFConfig
from repro_torch.kernels import ops as kops
from repro_torch.sharding.merge import gather_candidates, merge_topk

__all__ = ["ShardedIndex", "build_sharded_index", "sharded_search",
           "merge_with_dropout"]


@dataclasses.dataclass
class ShardedIndex:
    """Host-side bundle of per-segment artifacts, stacked segment-major."""

    x_pad: np.ndarray         # (S, n_seg+1, d) float32
    adj_pad: np.ndarray       # (S, n_seg+1, R) int32
    entries: np.ndarray       # (S, E) int32
    offsets: np.ndarray       # (S, n_seg) int32 global id of each row, -1
    n_total: int
    _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def num_shards(self) -> int:
        return self.x_pad.shape[0]

    def upload(self, device, segment: int | None = None
               ) -> tuple[torch.Tensor, ...]:
        """The stacked tables on ``device`` (x_pad, adj_pad, entries,
        offsets), uploaded on the first call for that device and kept;
        with ``segment``, that segment's block alone, ``(1, ·)``."""
        dev = torch.device(device)
        key = str(dev) if segment is None else f"{dev}:segment{segment}"
        if key not in self._tables:
            sl = slice(None) if segment is None \
                else slice(segment, segment + 1)
            self._tables[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(a[sl]), device=dev)
                for a in (self.x_pad, self.adj_pad, self.entries,
                          self.offsets))
        return self._tables[key]


def build_sharded_index(x: np.ndarray, num_shards: int,
                        params: SSGParams | None = None,
                        n_entry: int = 8, seed: int = 0,
                        device=None) -> ShardedIndex:
    """Round-robin rows into segments; independent NSSG per segment.

    ``n`` need not divide ``num_shards``: segments differ by at most one
    row, and shorter segments are padded to the common width with
    unreachable sentinel rows (distance-1e9 vectors whose adjacency points
    at the segment sentinel, global id ``-1``) — the external-id mapping
    in ``offsets`` stays exact for every real row.  Each segment's graph
    is built on ``device`` (the card unless asked otherwise).
    """
    dev = resolve_device(device, what="build_sharded_index")
    params = params or SSGParams()
    n, d = x.shape
    n_seg = -(-n // num_shards)                  # ceil: common segment width
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)                    # density-balance segments
    xs, adjs, ents, offs = [], [], [], []
    R = 0
    segs = [np.sort(perm[s::num_shards]) for s in range(num_shards)]
    if min(len(r) for r in segs) < 2:
        raise ValueError(
            f"n={n} leaves a segment with < 2 rows over {num_shards} shards")
    for rows in segs:
        n_s = rows.size
        seg = np.ascontiguousarray(x[rows], np.float32)
        idx = build_ssg(seg, params, n_entry=n_entry, device=dev)
        xp = np.full((n_seg + 1, d), 1e9, np.float32)
        xp[:n_s] = seg
        R = max(R, idx.adj.shape[1])
        ap = np.full((n_seg + 1, idx.adj.shape[1]), n_seg, np.int32)
        a = idx.adj
        ap[:n_s] = np.where((a < 0) | (a >= n_s), n_seg, a)
        xs.append(xp)
        adjs.append(ap)
        e = idx.entries
        if e.size < n_entry:                    # pad entries to equal width
            e = np.concatenate([e, np.full(n_entry - e.size, e[0], e.dtype)])
        ents.append(e[:n_entry])
        rp = np.full(n_seg, -1, np.int64)
        rp[:n_s] = rows                          # global ids; -1 = padding
        offs.append(rp)
    adjs = [np.pad(a, ((0, 0), (0, R - a.shape[1])),
                   constant_values=n_seg) for a in adjs]
    return ShardedIndex(
        x_pad=np.stack(xs), adj_pad=np.stack(adjs),
        entries=np.stack(ents).astype(np.int32),
        offsets=np.stack(offs).astype(np.int32), n_total=n)


def _mesh_cards(mesh) -> int:
    """Devices in a mesh given as the reference's: the product of its
    ``shape``'s axis sizes (``{axis name: size}``)."""
    return math.prod(dict(mesh.shape).values())


def _segment_lanes(tables, queries: torch.Tensor, *, pool_size: int, k: int,
                   max_hops: int, fused: bool):
    """Every segment's beam search as ``S·B`` stacked lanes, ids mapped
    through the segments' global ids: ``(S, B, k)`` dists and ids.

    ``fused`` runs the expansion loop through the fused hop (one launch on
    the card); otherwise the composed loop.  Both give the same bits.
    """
    x_t, adj_t, ent_t, off_t = tables
    S, n_seg = off_t.shape
    B = queries.shape[0]
    lane = torch.arange(S, device=queries.device).repeat_interleave(B)
    qq = queries.repeat(S, 1)                            # lane s·B + b
    xl, al = bs.LaneTable(x_t, lane), bs.LaneTable(adj_t, lane)
    state = bs.init_state(xl, qq, ent_t[lane], pool_size)
    loop = bs.fused_beam_loop if fused else bs.beam_loop
    state = loop(xl, al, qq, state, max_hops)
    ids, dists = bs.topk_from_pool(state.pool, k)
    # invalid = pool sentinel OR a remainder-padding row (global id -1)
    rows = off_t[lane[:, None], ids.clamp(max=n_seg - 1).long()]
    bad = (ids >= n_seg) | (rows < 0)
    gids = torch.where(bad, -1, rows).to(torch.int32)
    dists = torch.where(bad, float("inf"), dists)
    return dists.view(S, B, k), gids.view(S, B, k)


def _stacked_search(tables, queries: torch.Tensor, **kw):
    """:func:`_segment_lanes` merged: ``(B, k)`` ids and dists."""
    dists, gids = _segment_lanes(tables, queries, **kw)
    return merge_topk(dists, gids, kw["k"])


def _mesh_search(index: ShardedIndex, q: torch.Tensor, mesh, *, cfg,
                 model_axis: str, data_axis: str):
    """The reference's ``shard_map`` search over a port mesh: segment r of
    the model axis on rank r, queries split over the data axis (padded to
    equal slices), the per-segment top-k gathered rank-major and merged
    by one ``merge_topk`` (the stable merge of the segment-major
    concatenation, as ``lax.top_k``), the slices gathered back."""
    S = index.num_shards
    if mesh.shape.get(model_axis) != S:
        raise ValueError(f"{S} shards need model axis of size {S}")
    D = mesh.size(data_axis)
    B = q.shape[0]
    Bl = -(-B // D)
    if Bl * D != B:
        q = torch.cat([q, q[-1:].expand(Bl * D - B, -1)])
    di = mesh.index(data_axis)
    dists, gids = _segment_lanes(
        index.upload(q.device, mesh.coordinate[model_axis]),
        q[di * Bl:(di + 1) * Bl], pool_size=cfg.full_pool, k=cfg.k,
        max_hops=cfg.max_hops, fused=kops._device_type(q) == "cuda")
    ids, dists = merge_topk(*gather_candidates(
        dists[0], gids[0], mesh.group(model_axis), S), cfg.k)
    if D > 1:
        dists, ids = gather_candidates(dists, ids, mesh.group(data_axis), D)
        ids, dists = ids.reshape(D * Bl, -1)[:B], dists.reshape(D * Bl,
                                                                -1)[:B]
    return ids, dists


def sharded_search(index: ShardedIndex, queries, mesh=None, *,
                   cfg: DQFConfig, model_axis: str = "model",
                   data_axis: str = "data", device=None):
    """Batched search over every segment: (B, k) global ids + dists, numpy.

    ``mesh`` None (or a stand-in of one device with only ``shape``)
    searches the segments on one card as stacked lanes.  A
    :class:`~repro_torch.distributed.mesh.Mesh` places segment r on rank r of
    ``model_axis``, which must have S ranks (``ValueError``), and splits
    the queries over ``data_axis`` (:func:`_mesh_search`); every rank of
    the mesh calls it with the same queries and gets the whole answer.  A
    mesh of more than one device without its process group raises
    ``RuntimeError``.  The device is the card unless ``device="cpu"`` is
    given; the tables are uploaded once per index and device
    (:meth:`ShardedIndex.upload`).
    """
    from repro_torch.distributed.mesh import Mesh

    if mesh is not None and not isinstance(mesh, Mesh) \
            and _mesh_cards(mesh) > 1:
        raise RuntimeError(
            f"sharded_search over a {_mesh_cards(mesh)}-device mesh needs "
            "its process group: a repro_torch.distributed.mesh.Mesh, after "
            "init_distributed")
    dev = resolve_device(device, what="sharded_search")
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    if isinstance(mesh, Mesh):
        ids, dists = _mesh_search(index, q, mesh, cfg=cfg,
                                  model_axis=model_axis, data_axis=data_axis)
        return ids.cpu().numpy(), dists.cpu().numpy()
    ids, dists = _stacked_search(
        index.upload(dev), q, pool_size=cfg.full_pool, k=cfg.k,
        max_hops=cfg.max_hops, fused=kops._device_type(q) == "cuda")
    return ids.cpu().numpy(), dists.cpu().numpy()


def merge_with_dropout(per_shard_ids: list, per_shard_dists: list,
                       alive: list, k: int, *, registry=None):
    """Host-side degraded merge: skip shards flagged dead (stragglers that
    timed out / failed hosts).  Returns (ids, dists, coverage).

    With a :class:`repro_torch.obs.MetricsRegistry`, every degraded merge
    is visible in ``scrape()``/``exposition()``: responding shards count
    into ``shard_responses_total{shard=i}`` and each dead shard into
    ``shard_dropout_total``.
    """
    if registry is not None:
        resp = registry.counter(
            "shard_responses_total",
            "per-shard responses folded into degraded merges")
        for s, a in enumerate(alive):
            if a:
                resp.inc(1.0, shard=s)
        dead = len(alive) - sum(bool(a) for a in alive)
        if dead:
            registry.counter(
                "shard_dropout_total",
                "shards dropped from degraded merges").inc(float(dead))
    ids = [i for i, a in zip(per_shard_ids, alive) if a]
    ds = [d for d, a in zip(per_shard_dists, alive) if a]
    if not ids:
        raise RuntimeError("all shards lost")
    cat_i = np.concatenate(ids, axis=1)
    cat_d = np.concatenate(ds, axis=1)
    order = np.argsort(cat_d, axis=1)[:, :k]
    return (np.take_along_axis(cat_i, order, 1),
            np.take_along_axis(cat_d, order, 1),
            sum(alive) / len(alive))
