"""Cache-aware score table: the tier's face toward the beam search.

A port of ``repro/tiering/table.py``.  :class:`TieredTable` implements
the port's score-table protocol (``.n`` / ``.with_queries`` /
``.gather_score``, see :mod:`repro_torch.core.beam_search`) over a
:class:`~repro_torch.tiering.cache.BlockCache` instead of a fully resident
device table.  A gather splits each requested row by the snapshot block
map: resident rows come out of the device arena, the rest are read on the
host by :meth:`BlockCache.host_fetch` (one batched read per gather, which
also tallies hits and misses for the admission policy).

Where the reference runs the host read inside its jitted graph (a
``jax.pure_callback``), a gather here is a host fetch between launches:
``pos``, ``bid``, ``slot`` and ``hit`` are computed on the device, ``cols``
and ``hit`` are copied to the host, the missed rows are read there and
copied to the device, and then both row sets are scored.

Bit-identity contract: the two scorings are the port's own resident
expressions — :func:`repro_torch.kernels.ref.sq_l2` as
``beam_search.score_rows`` applies it to float32 rows, ``ref.sq8_score``
(``SQTable.gather_score``) and ``ref.pq_score`` (``PQView.gather_score``),
each on already gathered rows — applied once to the arena rows and once
to the fetched rows, and the finished **scores** are selected with
``torch.where(hit, …)``.  So a tiered search returns the resident search's
ids and distances bit for bit at any cache size.

The table is a snapshot of the cache's tensors at construction.  The
cache changes them only on the host thread between searches and ticks;
consumers rebuild the table after any such change —
:class:`~repro_torch.core.dqf.DQF` per search call, the engines per tick.
No kernel of the port takes a tiered table
(:func:`repro_torch.kernels.ops.table_spec` refuses it): a tiered search
runs the composed path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref

from .cache import BlockCache

__all__ = ["TieredTable"]


class TieredTable:
    """Score-table protocol over a block cache ("f32" | "sq8" | "pq")."""

    def __init__(self, cache: BlockCache, arena, block_map, perm, *,
                 mode: str, n: int, p0=None, p1=None, luts=None):
        self.cache = cache
        self.arena = arena            # (slots+1, block_rows, width)
        self.block_map = block_map    # (n_blocks+1,) int32, MISS = slots+1
        self.perm = perm              # (capacity+1,) logical id → position
        self.mode = mode
        self._n = int(n)              # sentinel row id (= store capacity)
        self.p0 = p0                  # sq8: scale | pq: centroids
        self.p1 = p1                  # sq8: zero
        self.luts = luts              # pq: per-query LUTs (with_queries)

    @classmethod
    def from_cache(cls, cache: BlockCache, *, mode: str, n: int,
                   p0=None, p1=None) -> "TieredTable":
        return cls(cache, cache.arena_dev(), cache.map_dev(),
                   cache.perm_dev(), mode=mode, n=n, p0=p0, p1=p1)

    # ------------------------------------------------------ score-table proto
    @property
    def n(self) -> int:
        return self._n

    def with_queries(self, queries: torch.Tensor) -> "TieredTable":
        if self.mode != "pq":
            return self
        from repro_torch.quant import pq_luts  # lazy: tiering ↛ quant.pq
        return TieredTable(self.cache, self.arena, self.block_map,
                           self.perm, mode=self.mode, n=self._n, p0=self.p0,
                           p1=self.p1, luts=pq_luts(queries, self.p0))

    def _gather_split(self, cols: torch.Tensor):
        """((B, C, w) arena rows, (B, C, w) fetched rows, (B, C) hit mask)."""
        bf, slots = self.cache.bf, self.cache.slots
        pos = self.perm[cols.long()]  # layout: block = row-cluster position
        bid = torch.clamp(pos >> bf.log2_block, max=bf.n_blocks)
        slot = self.block_map[bid.long()]                    # (B, C)
        hit = slot <= slots                # zero block (sentinel) is a "hit"
        g = self.arena[torch.clamp(slot, max=slots).long(),
                       (pos & (bf.block_rows - 1)).long()]   # (B, C, w)
        # the host fetch between launches: a blocking copy each way
        fetched = self.cache.host_fetch(cols.cpu().numpy(),
                                        hit.cpu().numpy())
        fetched = torch.from_numpy(fetched).to(self.arena.device)
        return g, fetched, hit

    def _score(self, rows: torch.Tensor,
               queries: torch.Tensor) -> torch.Tensor:
        if self.mode == "sq8":              # == SQTable.gather_score
            return ref.sq8_score_rows(rows, self.p0, self.p1, queries)
        if self.mode == "pq":               # == PQView.gather_score
            return ref.pq_score_rows(rows, self.luts)
        # == the float32 tensor branch of beam_search.score_rows
        return ref.sq_l2(rows, queries[:, None, :])

    def gather_score(self, queries: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
        g, fetched, hit = self._gather_split(cols)
        return torch.where(hit, self._score(g, queries),
                           self._score(fetched, queries))
