"""Device-resident block cache over one :class:`BlockFile` (clock eviction).

A port of ``repro/tiering/cache.py``.  The cache owns three device tensors
the search reads, on the device it was built for:

* an **arena** ``(slots + 1, block_rows, width)`` holding the resident
  blocks — slot ``slots`` is a permanent all-zero block that the sentinel
  block id maps to, so sentinel gathers are always "hits" whose garbage
  scores the search masks anyway;
* a **block map** ``(n_blocks + 1,)`` from block id to arena slot, with
  ``MISS = slots + 1`` for non-resident blocks;
* the layout **perm** ``(capacity + 1,)`` from logical row to position.

Everything else — per-block tallies, the clock hand and reference bits,
pins, the prefetch worker's ``_want`` and ``_staged`` — is host numpy,
copied from the reference expression for expression, so admissions,
evictions and counters equal the reference's for the same trace.

Everything that *mutates* the arena, map or perm (admission, eviction,
invalidation, prefetch application, relayout) runs on the host thread
**between** searches and ticks; a search reads a snapshot taken at its
start (:class:`~repro_torch.tiering.table.TieredTable`).  The map and
perm are uploaded as copies, so a later host write never reaches a
snapshot.  Admissions write the arena in one batched copy at the end of
:meth:`maintain` / :meth:`apply_prefetch`.  Misses are served by
:meth:`host_fetch` straight from the mmap, with per-block tallies that
:meth:`maintain` turns into admissions — clock (second-chance) eviction
with pin support, so blocks an in-flight serving lane still reads are
never evicted under it.

Consistency contract: the hit/miss decision is made on the device from
the snapshot map and passed to :meth:`host_fetch`, so the device and the
host never disagree on which rows were fetched.  Staleness is prevented
at the write seam: :meth:`note_write` immediately unmaps written blocks
(and drops concurrent prefetches), so any snapshot taken *after* a
mutation can only see current bytes.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from .blockfile import BlockFile

__all__ = ["BlockCache"]

_MASK64 = (1 << 64) - 1


def _backoff_unit(a: int, b: int) -> float:
    """Deterministic jitter in [0, 1) for one retry backoff (splitmix64;
    local copy — the tier sits below repro_torch.obs/repro_torch.chaos)."""
    x = ((a & _MASK64) * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E019) \
        & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return ((x ^ (x >> 31)) >> 11) * (1.0 / (1 << 53))


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class BlockCache:
    """Bounded device arena + clock eviction + miss-driven admission."""

    def __init__(self, bf: BlockFile, slots: int, *, name: str = "",
                 prefetch: bool = False, track_rows: bool = False,
                 tally_decay_every: int = 0, registry=None,
                 fetch_retries: int = 3, fetch_backoff_s: float = 0.002,
                 device=None):
        self.bf = bf
        self.slots = max(1, min(int(slots), bf.n_blocks))
        self.name = name
        self.MISS = self.slots + 1
        self.device = torch.device(device if device is not None else "cpu")
        self._arena = torch.zeros(
            (self.slots + 1, bf.block_rows, bf.width),
            dtype=_torch_dtype(bf.dtype), device=self.device)
        self._pending: dict[int, np.ndarray] = {}  # slot → block, unwritten
        self._map = np.full(bf.n_blocks + 1, self.MISS, np.int32)
        self._map[bf.n_blocks] = self.slots       # sentinel block: zero slot
        self._map_dev = torch.tensor(self._map, device=self.device)
        self._map_dirty = False
        self._slot_bid = np.full(self.slots, -1, np.int64)
        self._ref = np.zeros(self.slots, bool)    # clock reference bits
        self._hand = 0
        self._pinned: set[int] = set()
        # Workload-clustered layout: a block is a *cluster* of
        # ``block_rows`` logical rows, not an id range.
        # ``_perm[logical] = position`` (block = position >> lb),
        # ``_order[position] = logical`` is the arena-fill gather source.
        # The backing file itself never moves — layout only decides which
        # rows are cached together, so write-through aliases stay valid.
        self._perm = np.arange(bf.capacity + 1, dtype=np.int32)
        self._perm_dev = torch.tensor(self._perm, device=self.device)
        self._perm_dirty = False
        self._order: Optional[np.ndarray] = None  # None = identity layout
        self._track_rows = bool(track_rows)
        self._row_tally = (np.zeros(bf.capacity + 1, np.int64)
                           if track_rows else None)
        # Exponential decay window for the relayout signal: every
        # ``tally_decay_every`` maintain() passes the row tallies halve
        # (0 disables — all-time behaviour).
        self._tally_decay_every = int(tally_decay_every)
        self._maintain_count = 0
        # per-block touch tallies since the last maintain()
        self._miss_tally = np.zeros(bf.n_blocks, np.int64)
        self._hit_tally = np.zeros(bf.n_blocks, np.int64)
        self.counters = dict(hits=0, misses=0, evictions=0, admissions=0,
                             invalidations=0, prefetch_issued=0,
                             prefetch_applied=0, relayouts=0,
                             fetch_retries=0, fetch_failures=0)
        # Fault handling for the host-fetch disk reads: bounded retries
        # with jittered exponential backoff, then per-row sentinel
        # fallback.  ``chaos`` is the injection hook — None keeps the
        # exact healthy read path (repro_torch.chaos.install_chaos arms
        # it); degraded batch rows accumulate for the serving engine to
        # drain after the tick and mark on the affected queries.
        self.fetch_retries = int(fetch_retries)
        self.fetch_backoff_s = float(fetch_backoff_s)
        self.chaos = None
        self._degraded_rows: set = set()
        # windowed-stats baseline for stats_snapshot() deltas
        self._snap_prev = dict(self.counters)
        # counters re-homed on a metrics registry: scraped lazily via a
        # keyed callback, so the increment sites stay plain dict writes
        self.registry = registry
        if registry is not None:
            registry.register_callback(
                f"tier_cache:{name}", self._collect_metrics)
        # prefetch worker state (started lazily)
        self._prefetch_enabled = bool(prefetch)
        self._lock = threading.Lock()
        self._want: set[int] = set()
        self._staged: dict[int, np.ndarray] = {}
        self._write_gen = 0
        self._wake = threading.Event()
        self._stop = False
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------ device view
    def arena_dev(self) -> torch.Tensor:
        return self._arena

    def map_dev(self) -> torch.Tensor:
        if self._map_dirty:
            self._map_dev = torch.tensor(self._map, device=self.device)
            self._map_dirty = False
        return self._map_dev

    def perm_dev(self) -> torch.Tensor:
        if self._perm_dirty:
            self._perm_dev = torch.tensor(self._perm, device=self.device)
            self._perm_dirty = False
        return self._perm_dev

    def arena_nbytes(self) -> int:
        return int(self._arena.numel() * self._arena.element_size())

    # --------------------------------------------------------------- fetching
    def host_fetch(self, cols, hit) -> np.ndarray:
        """Serve the rows the snapshot missed (host numpy in and out).

        ``hit`` is the resident mask the device gather computed from its
        snapshot map; rows where it is False are read from the mmap (the
        "disk" access).  Hit rows return zeros — the caller selects the
        arena gather for them.  Sentinel-block touches count as neither.
        """
        cols = np.asarray(cols)
        hit = np.asarray(hit)
        out = np.zeros(cols.shape + (self.bf.width,), self.bf.dtype)
        bid = np.minimum(self._perm[cols] >> self.bf.log2_block,
                         self.bf.n_blocks)
        # real rows only: sentinel-padded gathers (col == capacity) must not
        # pollute the counters or the admission tallies, whether or not the
        # sentinel's position happens to land inside the last real block
        valid = cols < self.bf.capacity
        miss = valid & ~hit
        if miss.any():
            # batch row (first axis) per missed element, aligned with the
            # C-order flattening of cols[miss] — the engines map these
            # back to lanes when a read degrades to the sentinel
            brow = (np.nonzero(miss)[0] if cols.ndim >= 2
                    else np.zeros(int(miss.sum()), np.int64))
            out[miss] = self._read_missed(cols[miss], brow)
            np.add.at(self._miss_tally, bid[miss], 1)
        got = valid & hit
        if got.any():
            np.add.at(self._hit_tally, bid[got], 1)
        if self._row_tally is not None:
            np.add.at(self._row_tally, cols[valid], 1)
        self.counters["hits"] += int(got.sum())
        self.counters["misses"] += int(miss.sum())
        return out

    def _read_missed(self, cols: np.ndarray,
                     batch_rows: np.ndarray) -> np.ndarray:
        """Serve missed rows from the mmap, surviving read faults.

        Healthy path (``chaos is None`` and the read succeeds): one
        vectorized read.  With chaos armed, or when that read raises a
        real ``OSError``, reads fall back to one attempt loop per unique
        block (bounded retries, jittered exponential backoff); a block
        that exhausts its retries serves zero rows (the sentinel fallback
        — their garbage scores lose every top-k comparison) and its batch
        rows are recorded for :meth:`take_degraded_rows`.
        """
        if self.chaos is None:
            try:
                return np.array(self.bf.rows[cols])
            except OSError:
                pass                     # real IO fault: per-block retries
        out = np.zeros((cols.shape[0], self.bf.width), self.bf.dtype)
        bid = np.minimum(self._perm[cols] >> self.bf.log2_block,
                         self.bf.n_blocks)
        for b in np.unique(bid):
            sel = bid == b
            rows = self._fetch_block_rows(int(b), cols[sel])
            if rows is None:
                self.counters["fetch_failures"] += 1
                self._degraded_rows.update(
                    int(r) for r in np.unique(batch_rows[sel]))
            else:
                out[sel] = rows
        return out

    def _fetch_block_rows(self, bid: int,
                          cols: np.ndarray) -> Optional[np.ndarray]:
        """One block's missed rows, retried to success or None."""
        attempts = self.fetch_retries + 1
        for attempt in range(attempts):
            try:
                if self.chaos is not None:
                    self.chaos.tier_read(bid)   # may raise injected IOError
                return np.array(self.bf.rows[cols])
            except OSError:
                if attempt == attempts - 1:
                    return None
                self.counters["fetch_retries"] += 1
                delay = (self.fetch_backoff_s * (1 << attempt)
                         * (0.5 + 0.5 * _backoff_unit(bid, attempt)))
                if self.chaos is not None:
                    self.chaos.sleep(delay)     # virtual under a ChaosClock
                elif delay > 0:
                    time.sleep(delay)
        return None

    def take_degraded_rows(self) -> set:
        """Drain the batch rows whose reads fell back to the sentinel."""
        rows, self._degraded_rows = self._degraded_rows, set()
        return rows

    def _load_block(self, bid: int) -> np.ndarray:
        """Gather one block's rows from the file via the current layout."""
        if self._order is None:
            return self.bf.read_block(bid)
        br = self.bf.block_rows
        return np.array(self.bf.rows[self._order[bid * br: bid * br + br]])

    # -------------------------------------------------------------- residency
    def blocks_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Block ids covering the given logical rows (layout-aware) —
        callers must never compute ``rows >> log2_block`` themselves, the
        clustered layout makes that wrong after a relayout."""
        rows = np.asarray(rows).reshape(-1)
        bids = np.unique(self._perm[rows] >> self.bf.log2_block)
        return bids[bids < self.bf.n_blocks]

    def resident(self, bid: int) -> bool:
        return self._map[int(bid)] < self.slots

    def resident_blocks(self) -> np.ndarray:
        return self._slot_bid[self._slot_bid >= 0].copy()

    def _find_victim(self) -> Optional[int]:
        free = np.flatnonzero(self._slot_bid < 0)
        if free.size:
            return int(free[0])
        for _ in range(2 * self.slots + 1):
            s = self._hand
            self._hand = (self._hand + 1) % self.slots
            if int(self._slot_bid[s]) in self._pinned:
                continue
            if self._ref[s]:
                self._ref[s] = False
                continue
            return s
        return None                 # everything pinned

    def _install(self, bid: int, data: np.ndarray, slot: int) -> None:
        old = int(self._slot_bid[slot])
        if old >= 0:
            self._map[old] = self.MISS
            self.counters["evictions"] += 1
        self._pending[slot] = data  # written by _write_arena()
        self._slot_bid[slot] = bid
        self._map[bid] = slot
        self._ref[slot] = True      # second-chance grace for new blocks
        self._map_dirty = True
        self.counters["admissions"] += 1

    def _write_arena(self) -> None:
        """Copy this pass's admitted blocks into the arena in one upload
        (host thread, between searches: no snapshot is being read)."""
        if not self._pending:
            return
        slots = torch.tensor(list(self._pending), dtype=torch.long,
                             device=self.device)
        data = torch.from_numpy(np.stack(list(self._pending.values())))
        self._arena[slots] = data.to(self.device)
        self._pending = {}

    def _admit(self, bid: int, data: np.ndarray) -> bool:
        """Clock-eviction admission (the prefetch-apply path)."""
        slot = self._find_victim()
        if slot is None:
            return False
        self._install(bid, data, slot)
        return True

    def maintain(self, max_admit: Optional[int] = None) -> int:
        """Turn the tallies since the last call into admissions.

        Hit blocks get their clock reference bit set (they survive a
        prefetch-side sweep); missed blocks are considered hottest-first,
        and each is admitted only when it out-scores the coldest evictable
        resident block (this pass's miss tally vs. hit tally — TinyLFU-ish
        windowed admission), so a proven-hot working set is never flushed
        by its own cold tail.
        """
        for b in np.flatnonzero(self._hit_tally):
            s = self._map[b]
            if s < self.slots:
                self._ref[s] = True
        hot = np.flatnonzero(self._miss_tally)
        admitted = 0
        # slots whose block may not be evicted in this pass: pinned, or
        # admitted by it (the reference's ``fresh`` set, kept by slot)
        held = np.isin(self._slot_bid, np.fromiter(self._pinned, np.int64,
                                                   len(self._pinned)))
        for b in hot[np.argsort(-self._miss_tally[hot], kind="stable")]:
            b = int(b)
            if self._map[b] < self.slots:       # raced with prefetch: done
                continue
            slot = self._admission_victim(int(self._miss_tally[b]), held)
            if slot is None:
                break
            self._install(b, self._load_block(b), slot)
            held[slot] = True
            admitted += 1
            if max_admit is not None and admitted >= max_admit:
                break
        self._write_arena()
        self._miss_tally[:] = 0
        self._hit_tally[:] = 0
        self._maintain_count += 1
        if self._tally_decay_every and \
                self._maintain_count % self._tally_decay_every == 0:
            self.decay_tallies()
        return admitted

    def _admission_victim(self, cand_score: int,
                          held: np.ndarray) -> Optional[int]:
        """Free slot, or the coldest resident not ``held`` strictly
        colder than the candidate (the first such slot on a tie); None
        when nothing qualifies.  The reference's per-slot loop, as one
        argmin over the slots."""
        free = np.flatnonzero(self._slot_bid < 0)
        if free.size:
            return int(free[0])
        score = np.where(held, np.iinfo(np.int64).max,
                         self._hit_tally[self._slot_bid])
        s = int(np.argmin(score))
        return s if score[s] < cand_score else None

    # --------------------------------------------------------------- layout
    def decay_tallies(self) -> None:
        """Halve the accumulated row-touch tallies (the relayout signal).

        Halving turns the tallies into an exponential moving window over
        recent traffic.  Only the layout signal is touched — residency,
        pins and the admission tallies are unaffected, so a pinned block
        can never be evicted (or moved) by a decay pass.
        """
        if self._row_tally is not None:
            self._row_tally >>= 1

    def set_layout(self, order: np.ndarray) -> None:
        """Re-cluster blocks: ``order[p] = logical id`` at position ``p``.

        ``order`` ranks the first ``len(order)`` logical rows (hottest
        first); rows beyond it keep their identity positions.  Every
        resident block is dropped (its contents are keyed to the old
        clustering) and concurrent prefetches are abandoned.
        """
        cap = self.bf.capacity
        order = np.asarray(order, np.int64)
        if order.size and not np.array_equal(np.sort(order),
                                             np.arange(order.size)):
            # anything else would place two logical ids at one position
            raise ValueError(
                "order must be a permutation of the first len(order) "
                "logical ids")
        perm = np.arange(cap + 1, dtype=np.int32)
        perm[order] = np.arange(order.size, dtype=np.int32)
        full = np.empty(self.bf.n_blocks * self.bf.block_rows, np.int64)
        full[: cap] = perm[:cap].argsort(kind="stable")  # position → logical
        full[cap:] = 0        # file padding positions: never addressed
        with self._lock:
            self._write_gen += 1
            self._want.clear()
            self._staged.clear()
            self._perm = perm
            self._perm_dirty = True
            self._order = full
            self._map[: self.bf.n_blocks] = self.MISS
            self._slot_bid[:] = -1
            self._ref[:] = False
            self._map_dirty = True
            self._miss_tally[:] = 0
            self._hit_tally[:] = 0
        self.counters["relayouts"] += 1

    def relayout(self, n: int) -> bool:
        """Cluster blocks around the accumulated row-touch frequencies.

        Random internal ids spread the workload's hot rows across every
        id-range block; after re-clustering, the hottest ``block_rows``
        rows share a block and the cache's hit-rate approaches the
        row-level skew of the workload.  Returns False when nothing was
        tracked yet.
        """
        if self._row_tally is None or not self._row_tally[:n].any():
            return False
        self.set_layout(np.argsort(-self._row_tally[:n], kind="stable"))
        return True

    # ----------------------------------------------------------- invalidation
    def note_write_rows(self, lo: int, hi: int) -> None:
        """Invalidate the blocks covering logical rows ``[lo, hi)``."""
        if hi <= lo:
            return
        bids = np.unique(self._perm[lo:hi] >> self.bf.log2_block)
        self.note_write(int(b) for b in bids if b < self.bf.n_blocks)

    def note_write(self, bids: Iterable[int]) -> None:
        """Written blocks leave the cache *now* (the stale-epoch guard)."""
        with self._lock:
            self._write_gen += 1
            for b in bids:
                b = int(b)
                self._want.discard(b)
                self._staged.pop(b, None)
                s = self._map[b]
                if s < self.slots:
                    self._map[b] = self.MISS
                    self._slot_bid[s] = -1
                    self._ref[s] = False
                    self._map_dirty = True
                    self.counters["invalidations"] += 1

    # ------------------------------------------------------------------- pins
    def pin_blocks(self, bids: Iterable[int]) -> None:
        """Replace the pin set (blocks in-flight lanes still read)."""
        self._pinned = {int(b) for b in bids}

    # --------------------------------------------------------------- prefetch
    def prefetch_async(self, bids: Iterable[int]) -> int:
        """Schedule background loads of ``bids`` (non-resident ones).

        The worker thread only reads the memmap into host arrays; it
        never touches a tensor.  :meth:`apply_prefetch` installs them."""
        if not self._prefetch_enabled:
            return 0
        issued = 0
        with self._lock:
            for b in bids:
                b = int(b)
                if (0 <= b < self.bf.n_blocks
                        and self._map[b] >= self.slots
                        and b not in self._want and b not in self._staged):
                    self._want.add(b)
                    issued += 1
        if issued:
            self.counters["prefetch_issued"] += issued
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._prefetch_loop, daemon=True,
                    name=f"tier-prefetch-{self.name}")
                self._worker.start()
            self._wake.set()
        return issued

    def _prefetch_loop(self) -> None:
        while True:
            self._wake.wait()
            if self._stop:
                return
            with self._lock:
                if not self._want:
                    self._wake.clear()
                    continue
                bid = self._want.pop()
                gen = self._write_gen
            data = self._load_block(bid)        # the off-thread disk read
            with self._lock:
                # a write raced the read → the staged copy may be torn
                if self._write_gen == gen:
                    self._staged[bid] = data

    def apply_prefetch(self) -> int:
        """Admit completed prefetches (host thread, between searches)."""
        with self._lock:
            staged, self._staged = self._staged, {}
        applied = 0
        for bid, data in staged.items():
            if self._map[bid] < self.slots:
                continue
            if self._admit(bid, data):
                applied += 1
        self._write_arena()
        self.counters["prefetch_applied"] += applied
        return applied

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
            self._worker = None

    # ------------------------------------------------------------------ stats
    def hit_rate(self) -> float:
        """Lifetime hit rate (hits / gathers served, sentinels excluded)."""
        h, m = self.counters["hits"], self.counters["misses"]
        return h / (h + m) if (h + m) else 0.0

    def stats_snapshot(self) -> dict:
        """Counter deltas since the previous snapshot + window hit rate.

        Each call closes the current measurement window and opens the
        next one, without resetting the lifetime counters (which the
        registry scrape and ``hit_rate()`` keep reading).
        """
        cur = dict(self.counters)
        out = {k: cur[k] - self._snap_prev.get(k, 0) for k in cur}
        self._snap_prev = cur
        h, m = out["hits"], out["misses"]
        out["hit_rate"] = h / (h + m) if (h + m) else 0.0
        return out

    def reset_counters(self) -> None:
        for k in self.counters:
            self.counters[k] = 0
        self._snap_prev = dict(self.counters)

    def _collect_metrics(self) -> dict:
        """Registry scrape-time collector (keyed on the cache name)."""
        lbl = f"{{cache={self.name}}}"
        out = {f"tier_{k}_total{lbl}": float(v)
               for k, v in self.counters.items()}
        out[f"tier_hit_rate{lbl}"] = self.hit_rate()
        out[f"tier_resident_blocks{lbl}"] = float(
            int((self._slot_bid >= 0).sum()))
        out[f"tier_arena_bytes{lbl}"] = float(self.arena_nbytes())
        return out
