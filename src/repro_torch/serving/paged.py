"""Paged wave state: page-table-indexed lane storage for ragged serving.

The fixed-shape :class:`~repro_torch.serving.engine.WaveEngine` holds one
max-padded tensor per state field, sized ``(wave_size, ...)``: every tick
pays for ``wave_size`` lanes whether 3 or 64 of them are live, and a new
lane can only be admitted into a free slot of that fixed wave.  This
module keeps per-lane state in a device *page pool* indexed by a per-lane
*page table*, with cu-len bookkeeping on the allocator, so

* lanes retire and admit continuously mid-stream (a free-list allocator
  hands out lane slots and ``seen`` pages; admission and retirement are
  device scatters, never a host round-trip of the wave state);
* per-tick work tracks the number of *live* lanes, not pool capacity —
  each tick gathers the live lanes into a dense bucket (width rounded to
  a power of two, so the set of shapes stays bounded) and scatters the
  results back;
* a straggler never holds the wave: it occupies one lane slot and its
  ``seen`` pages while every other slot keeps turning over.

Layout
------
Per-lane scratch (pool ids/dists/expanded, counters, query, hot features)
lives in *slot arrays* of shape ``(P+1, ...)`` — one row per lane, row
``P`` reserved as an inert scratch lane that padding entries of a gather
bucket point at.  The per-lane ``seen`` bitmap — ``n+1`` bools per lane —
is *paged*: a shared pool ``(n_pages, page_cols)`` plus a page table
``(P+1, pages_per_lane)``; logical bit ``(lane, id)`` lives at physical
``(page_table[lane, id >> s], id & m)`` with ``page_cols = 2**s``.  Pages
are recycled through a free list in arbitrary order, so a lane's pages are
not contiguous, and admission overwrites whatever a recycled page held.

The state tensors are updated in place (:func:`scatter_wave`,
:func:`admit_wave`, the paged hop): the pool is the big array, and a copy
per tick would move more bytes than the tick.

Bit-identity: :func:`expand_step_paged` mirrors
:func:`repro_torch.core.beam_search.expand_step` expression for expression
— only the ``seen`` reads and writes walk the page table — so a paged
engine gives the fixed-wave engine's per-query results bit for bit.
:func:`dense_seen` is the seam tests use to hold the paged bitmap against
the dense one.  A port of ``repro/serving/paged.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import beam_search as bs
from repro_torch.core.beam_search import _merge_pool
from repro_torch.core.types import INF_DIST, PoolState, SearchStats
from repro_torch.kernels.ref import first_true

__all__ = ["PagedState", "PagePool", "PageAllocDenied", "expand_step_paged",
           "gather_wave", "scatter_wave", "admit_wave", "dense_seen",
           "bucket_width", "zero_paged_state", "DEFAULT_PAGE_COLS"]

DEFAULT_PAGE_COLS = 256          # bools per seen page (must be a power of 2)
MIN_BUCKET = 8                   # smallest gather-bucket width


class PagedState(NamedTuple):
    """Device-resident paged wave state.

    Slot arrays carry ``P+1`` rows (row ``P`` = inert scratch lane);
    ``seen_pages`` is the shared page pool the per-lane page table
    indexes into.
    """

    ids: torch.Tensor           # (P+1, L) int32, sentinel = n
    dists: torch.Tensor         # (P+1, L) float32
    expanded: torch.Tensor      # (P+1, L) bool
    dist_count: torch.Tensor    # (P+1,) int32
    update_count: torch.Tensor  # (P+1,) int32
    hops: torch.Tensor          # (P+1,) int32
    terminated: torch.Tensor    # (P+1,) bool
    active: torch.Tensor        # (P+1,) bool
    evals: torch.Tensor         # (P+1,) int32 — tree evaluations done
    queries: torch.Tensor       # (P+1, d) float32
    hot_first: torch.Tensor     # (P+1,) float32
    hot_ratio: torch.Tensor     # (P+1,) float32
    seen_pages: torch.Tensor    # (n_pages, page_cols) bool


class WaveView(NamedTuple):
    """A gathered (dense) bucket of live lanes — one tick's working set."""

    beam: bs.BeamState          # .seen holds the PAGE POOL, not dense rows
    evals: torch.Tensor         # (Wb,) int32
    queries: torch.Tensor       # (Wb, d)
    hot_first: torch.Tensor     # (Wb,)
    hot_ratio: torch.Tensor     # (Wb,)


def _check_pow2(v: int, name: str) -> None:
    if v <= 0 or (v & (v - 1)):
        raise ValueError(f"{name} must be a positive power of two, got {v}")


def bucket_width(count: int, cap: int, lo: int = MIN_BUCKET) -> int:
    """Smallest power-of-two width ≥ ``count`` (≥ lo).

    Gather buckets are padded to these widths, so a tick sees O(log cap)
    distinct shapes instead of one per live count.
    """
    w = lo
    while w < count:
        w *= 2
    return w


def zero_paged_state(capacity: int, pool_len: int, d: int, n_pages: int,
                     page_cols: int, sentinel: int,
                     device=None) -> PagedState:
    """All-lanes-idle paged state (no scoring; lanes are admitted later)."""
    P1 = capacity + 1
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return PagedState(
        ids=torch.full((P1, pool_len), sentinel, dtype=torch.int32,
                       device=device),
        dists=torch.full((P1, pool_len), INF_DIST, dtype=torch.float32,
                         device=device),
        expanded=z((P1, pool_len), torch.bool),
        dist_count=z((P1,), torch.int32),
        update_count=z((P1,), torch.int32),
        hops=z((P1,), torch.int32),
        terminated=z((P1,), torch.bool),
        active=z((P1,), torch.bool),
        evals=z((P1,), torch.int32),
        queries=z((P1, d), torch.float32),
        hot_first=z((P1,), torch.float32),
        hot_ratio=z((P1,), torch.float32),
        seen_pages=z((n_pages, page_cols), torch.bool),
    )


class PageAllocDenied(RuntimeError):
    """A chaos plan denied this allocation (transient — retry next tick).

    Distinct from the bare ``RuntimeError`` real exhaustion raises, so the
    engines can requeue the admission batch instead of treating an
    injected denial as a sizing bug.
    """


class PagePool:
    """Host-side allocator: lane slots + ``seen`` pages + page table.

    The page table and free lists are authoritative on the host (the
    allocator is pure bookkeeping, mutation-heavy and consulted every
    admission); each tick ships only the bucket's rows
    ``page_table[lanes]`` to the device (bucket × pages_per_lane int32).
    The free lists move one page at a time, so their cost grows with
    ``pages_per_lane`` = ceil((n+1) / page_cols).

    ``cu_lens`` is the ragged-batch contract: ``cu_lens[i]`` is the total
    page count of the first ``i`` live lanes (exclusive prefix), which is
    how the allocator carves page ranges for a multi-lane admission and
    how tests audit that live lanes exactly partition the allocated
    pages.
    """

    def __init__(self, capacity: int, n_ids: int,
                 page_cols: int = DEFAULT_PAGE_COLS, *,
                 registry=None, name: str = "pool"):
        _check_pow2(page_cols, "page_cols")
        self.capacity = int(capacity)
        self.page_cols = int(page_cols)
        self.page_shift = int(page_cols).bit_length() - 1
        # lifecycle counters (repro_torch.obs, optional): alloc/free rates
        # show admission throughput, grows mark store-capacity epochs, and
        # the in-use gauge is the paged analogue of wave occupancy
        self.name = str(name)
        self._registry = registry
        if registry is not None:
            self._c_alloc = registry.counter(
                "page_pool_alloc_total", "seen pages handed to lanes")
            self._c_free = registry.counter(
                "page_pool_free_total", "seen pages returned to free list")
            self._c_grow = registry.counter(
                "page_pool_grow_total", "pool rebuilds for a new store size")
            self._g_in_use = registry.gauge(
                "page_pool_pages_in_use", "allocated (non-free) seen pages")
        self._prev_n_ids: Optional[int] = None
        self.chaos = None           # fault hook (repro_torch.chaos), None = off
        self.reset(n_ids)

    def _publish(self) -> None:
        if self._registry is not None:
            self._g_in_use.set(
                self.capacity * self.pages_per_lane - len(self._free_pages),
                pool=self.name)

    # ------------------------------------------------------------- lifecycle
    def reset(self, n_ids: int) -> None:
        """(Re)build for a store of ``n_ids`` rows; frees every lane."""
        if self._registry is not None and self._prev_n_ids is not None \
                and int(n_ids) != self._prev_n_ids:
            self._c_grow.inc(pool=self.name)
        self._prev_n_ids = int(n_ids)
        self.n_ids = int(n_ids)
        self.pages_per_lane = -(-(self.n_ids + 1) // self.page_cols)
        ppl, P = self.pages_per_lane, self.capacity
        self.n_pages = (P + 1) * ppl
        # scratch lane P permanently owns the last ppl pages
        self._scratch_pages = np.arange(P * ppl, (P + 1) * ppl,
                                        dtype=np.int32)
        self.page_table = np.tile(self._scratch_pages, (P + 1, 1))
        # LIFO free lists: recycled lanes/pages are reused first, so the
        # physical page order genuinely diverges from the logical one
        self._free_lanes = list(range(P - 1, -1, -1))
        self._free_pages = list(range(P * ppl - 1, -1, -1))
        self._live: list[int] = []
        self._publish()

    # ------------------------------------------------------------ allocation
    @property
    def free_lane_count(self) -> int:
        return len(self._free_lanes)

    @property
    def live_count(self) -> int:
        return len(self._live)

    def occupancy(self) -> float:
        return len(self._live) / self.capacity if self.capacity else 0.0

    def live_lanes(self) -> np.ndarray:
        """Live lane slots in admission order."""
        return np.asarray(self._live, np.int32)

    def cu_lens(self, lanes: Optional[np.ndarray] = None) -> np.ndarray:
        """Exclusive prefix of per-lane page counts over ``lanes``.

        With today's uniform ``pages_per_lane`` this is an affine ramp;
        keeping it explicit is what lets page counts go ragged without
        touching callers.
        """
        m = len(self._live) if lanes is None else len(lanes)
        counts = np.full(m, self.pages_per_lane, np.int64)
        return np.concatenate([[0], np.cumsum(counts)])

    def alloc(self, m: int) -> np.ndarray:
        """Claim ``m`` lane slots + their seen pages; fill page-table rows."""
        if m > len(self._free_lanes):
            raise RuntimeError(
                f"page pool exhausted: want {m} lanes, "
                f"{len(self._free_lanes)} free")
        if self.chaos is not None and self.chaos.deny_alloc():
            raise PageAllocDenied(
                f"chaos: page allocation denied (want {m} lanes)")
        lanes = np.asarray([self._free_lanes.pop() for _ in range(m)],
                           np.int32)
        cu = self.cu_lens(lanes)
        pages = np.asarray([self._free_pages.pop()
                            for _ in range(int(cu[-1]))], np.int32)
        for j, lane in enumerate(lanes):
            self.page_table[lane] = pages[cu[j]:cu[j + 1]]
        self._live.extend(int(v) for v in lanes)
        if self._registry is not None and len(pages):
            self._c_alloc.inc(float(len(pages)), pool=self.name)
            self._publish()
        return lanes

    def free(self, lanes) -> None:
        """Release lane slots and their pages back to the free lists."""
        n_freed = 0
        for lane in lanes:
            lane = int(lane)
            self._live.remove(lane)
            self._free_pages.extend(
                int(p) for p in self.page_table[lane])
            n_freed += self.pages_per_lane
            self.page_table[lane] = self._scratch_pages
            self._free_lanes.append(lane)
        if self._registry is not None and n_freed:
            self._c_free.inc(float(n_freed), pool=self.name)
            self._publish()

    def adopt(self, lanes) -> None:
        """Re-claim *specific* lane slots after :meth:`reset`, in order.

        Capacity growth rebuilds the pool (pages per lane changed) but
        in-flight lanes must keep their slot indices — host metadata and
        the device slot arrays are keyed by them.  Fresh pages are
        allocated for each adopted lane; the caller scatters the regrown
        seen rows into them.
        """
        n_adopted = 0
        for lane in lanes:
            lane = int(lane)
            self._free_lanes.remove(lane)
            cnt = self.pages_per_lane
            self.page_table[lane] = [self._free_pages.pop()
                                     for _ in range(cnt)]
            n_adopted += cnt
            self._live.append(lane)
        if self._registry is not None and n_adopted:
            self._c_alloc.inc(float(n_adopted), pool=self.name)
            self._publish()

    # ------------------------------------------------------------- gathering
    def live_bucket(self, lo: int = MIN_BUCKET
                    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Live lanes padded to a bucket width: (lanes, pt_rows, n_live).

        Padding entries point at the scratch lane ``P`` (inert: inactive,
        scratch seen pages), so the tick treats them as exact no-ops.
        """
        live = self.live_lanes()
        w = bucket_width(max(len(live), 1), self.capacity, lo)
        lanes = np.full(w, self.capacity, np.int32)
        lanes[:len(live)] = live
        return lanes, self.page_table[lanes], len(live)


# ------------------------------------------------------------ device ops
def _page_index(pt: torch.Tensor, ids: torch.Tensor, page_shift: int):
    """Physical (page, column) of logical bits ``ids`` (B, C) of each lane
    through its page-table row ``pt`` (B, ppl)."""
    mask = (1 << page_shift) - 1
    page = pt.long().gather(1, ids.long() >> page_shift)
    return page, ids.long() & mask


def expand_step_paged(table, adj_pad: torch.Tensor, queries: torch.Tensor,
                      state: bs.BeamState, pt: torch.Tensor, page_shift: int,
                      live_pad: Optional[torch.Tensor] = None
                      ) -> bs.BeamState:
    """One expansion per active lane, ``seen`` walked through the page table.

    Mirrors :func:`repro_torch.core.beam_search.expand_step` expression for
    expression — same frontier selection, scoring, merge and counters —
    except that ``state.seen`` is the shared page pool ``(n_pages,
    page_cols)`` (updated in place) and every seen read or write resolves
    ``(lane, id)`` to ``(pt[lane, id >> page_shift], id & (page_cols-1))``.
    The tables may be :class:`~repro_torch.core.beam_search.LaneTable`
    views of stacked ones (the sharded engine), as in ``expand_step``.
    """
    n = bs.table_n(table)
    B = state.pool.ids.shape[0]
    rows = torch.arange(B, device=queries.device)

    unexp = (~state.pool.expanded) & (state.pool.ids != n)
    lane = state.active & unexp.any(dim=1)
    slot = first_true(unexp)
    p = torch.where(lane, state.pool.ids[rows, slot], n)
    expanded = state.pool.expanded.clone()
    expanded[rows, slot] = state.pool.expanded[rows, slot] | lane

    nbrs = bs._adj_rows(adj_pad, p)                          # (B, R)
    already = state.seen[_page_index(pt, nbrs, page_shift)]  # (B, R)
    valid = (nbrs != n) & (~already) & lane[:, None]
    if live_pad is not None:
        valid &= bs.live_at(live_pad, nbrs)
    cols = torch.where(valid, nbrs, n)
    seen = state.seen
    seen[_page_index(pt, cols, page_shift)] = True

    d2 = bs.score_rows(table, queries, cols)
    d2 = torch.where(valid, d2, INF_DIST)

    pool = PoolState(state.pool.ids, state.pool.dists, expanded)
    pool, inserted = _merge_pool(pool, cols.to(torch.int32), d2,
                                 torch.zeros_like(valid), lane)
    stats = SearchStats(
        dist_count=state.stats.dist_count
        + torch.where(lane, valid.sum(dim=1, dtype=torch.int32), 0),
        update_count=state.stats.update_count + inserted,
        hops=state.stats.hops + lane.to(torch.int32),
        terminated_early=state.stats.terminated_early)
    still = ((~pool.expanded) & (pool.ids != n)).any(dim=1)
    return bs.BeamState(pool, seen, stats, state.active & still)


def gather_wave(ps: PagedState, lanes: torch.Tensor) -> WaveView:
    """Gather a dense bucket of lanes out of the slot arrays.

    ``seen`` is NOT gathered — the returned beam's ``seen`` field carries
    the whole page pool, which the paged hop indexes through the bucket's
    page-table rows.  Per-tick traffic scales with the bucket width, not
    with ``capacity × n``.
    """
    li = lanes.long()
    pool = PoolState(ids=ps.ids[li], dists=ps.dists[li],
                     expanded=ps.expanded[li])
    stats = SearchStats(dist_count=ps.dist_count[li],
                        update_count=ps.update_count[li],
                        hops=ps.hops[li], terminated_early=ps.terminated[li])
    beam = bs.BeamState(pool, ps.seen_pages, stats, ps.active[li])
    return WaveView(beam, ps.evals[li], ps.queries[li], ps.hot_first[li],
                    ps.hot_ratio[li])


def scatter_wave(ps: PagedState, lanes: torch.Tensor, beam: bs.BeamState,
                 evals: torch.Tensor) -> PagedState:
    """Write a ticked bucket back into the slot arrays, in place.

    ``beam.seen`` is the page pool the tick updated in place; it must be
    ``ps.seen_pages`` itself.  Padding entries of ``lanes`` all point at
    the inert scratch row ``P`` with identical (no-op) state, so they
    write identical values; row ``P`` is forced back to idle afterwards.
    """
    if beam.seen.data_ptr() != ps.seen_pages.data_ptr():
        raise ValueError("the ticked bucket must carry the state's pool")
    li = lanes.long()
    for dst, src in ((ps.ids, beam.pool.ids), (ps.dists, beam.pool.dists),
                     (ps.expanded, beam.pool.expanded),
                     (ps.dist_count, beam.stats.dist_count),
                     (ps.update_count, beam.stats.update_count),
                     (ps.hops, beam.stats.hops),
                     (ps.terminated, beam.stats.terminated_early),
                     (ps.active, beam.active), (ps.evals, evals)):
        dst[li] = src
    ps.active[-1] = False
    return ps


def admit_wave(ps: PagedState, lanes: torch.Tensor, pt: torch.Tensor,
               seeded: bs.BeamState, queries: torch.Tensor,
               hot_first: torch.Tensor, hot_ratio: torch.Tensor,
               admit_mask: torch.Tensor, page_cols: int) -> PagedState:
    """Seed freshly allocated lanes by device scatter, in place.

    ``seeded`` is the dense output of the refill hot phase and
    :func:`repro_torch.core.dynamic_search._seed_full_state` for the
    admission bucket; its dense ``(m, n+1)`` seen rows are split into
    pages and written into the pool at the lanes' page-table rows
    (overwriting whatever recycled pages held).  ``admit_mask`` marks the
    real admissions: only those rows are written, so the padding entries
    of the bucket (which all point at the scratch lane) write nothing and
    no two writes ever target one element.
    """
    keep = torch.nonzero(admit_mask).flatten()
    li = lanes.long()[keep]
    m = keep.numel()
    n1 = seeded.seen.shape[1]
    ppl = pt.shape[1]
    pages = torch.nn.functional.pad(seeded.seen[keep],
                                    (0, ppl * page_cols - n1))
    ps.seen_pages[pt.long()[keep]] = pages.reshape(m, ppl, page_cols)
    for dst, src in ((ps.ids, seeded.pool.ids),
                     (ps.dists, seeded.pool.dists),
                     (ps.expanded, seeded.pool.expanded),
                     (ps.dist_count, seeded.stats.dist_count),
                     (ps.update_count, seeded.stats.update_count),
                     (ps.hops, seeded.stats.hops),
                     (ps.terminated, seeded.stats.terminated_early),
                     (ps.queries, queries), (ps.hot_first, hot_first),
                     (ps.hot_ratio, hot_ratio)):
        dst[li] = src[keep]
    ps.evals[li] = 0
    ps.active[li] = True
    return ps


def dense_seen(seen_pages: torch.Tensor, pt: torch.Tensor, n1: int
               ) -> torch.Tensor:
    """Dense ``(m, n1)`` seen rows of a bucket from the page pool: gather
    its pages, concatenate, drop the tail."""
    m = pt.shape[0]
    return seen_pages[pt.long()].reshape(m, -1)[:, :n1]
