"""VectorStore — row storage with tombstones and stable ids.

Port of ``repro/store/store.py``: the rows, the codes of a quantized
index, liveness, external ids, the epochs and the capacity padding live
in host numpy arrays, and the padded tables are uploaded to a device on
request.

* **Internal ids** are row positions in the backing arrays.  They are what
  the graph, the counter and the search kernels speak; only
  :meth:`compact` invalidates them, and it returns an explicit remap.
* **External ids** are stable handles (monotonic int64) that survive
  compaction; the store owns the bidirectional map.
* **Delete is a tombstone**: the row (and its code) stays gatherable so the
  graph remains traversable, but ``alive`` goes False and every search
  layer masks the id out of candidate pools and results.
* **Capacity** is the device-table padding target: padded tables are sized
  ``(capacity + 1, ·)`` with sentinel id ``capacity``, so inserts within
  capacity keep every search shape stable.  It grows geometrically and
  never shrinks (compaction keeps it, for the same reason).
* **Epochs**: ``epoch`` bumps on every mutation (consumers refresh device
  tables when it moves), ``rows_epoch`` only when row or code contents
  change (append, compact), ``remap_epoch`` only on compaction (internal
  ids changed — in-flight search state is stale).
* **Tier** (optional, :mod:`repro_torch.tiering`): with ``tier=TierConfig(
  mode="host")`` the row and code capacity buffers are mmap-backed block
  files instead of RAM arrays — every slice write above is write-through —
  and device residency shrinks to per-file block caches on ``device``
  whose snapshots (:meth:`tiered_rows_table` / :meth:`tiered_codes_table`)
  replace the fully resident padded tables.  The epoch machinery doubles
  as the cache-invalidation seam: mutations ``note_write`` their blocks
  before bumping ``epoch``, so consumers that re-snapshot on epoch moves
  (all of them) can never score stale bytes.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.quant import QuantState, pq_encode, sq_encode
from repro_torch.tiering import BlockCache, BlockFile, TierConfig, TieredTable

__all__ = ["VectorStore", "CompactionResult"]

# == repro_torch.core.types.PAD_VALUE (the store sits below core)
_PAD_VALUE = 1e9


def _ceil_capacity(n: int) -> int:
    """Next power of two ≥ n (≥ 8), the geometric growth target."""
    cap = 8
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass(frozen=True)
class CompactionResult:
    """Outcome of :meth:`VectorStore.compact`.

    ``remap[old_internal] = new_internal`` for surviving rows, ``-1`` for
    dropped (tombstoned) rows.
    """

    remap: np.ndarray
    n_before: int
    n_after: int

    @property
    def dropped(self) -> int:
        return self.n_before - self.n_after


class VectorStore:
    """Rows + quant codes + liveness bitmap + stable external ids."""

    def __init__(self, x: np.ndarray, *,
                 ext_ids: Optional[np.ndarray] = None,
                 alive: Optional[np.ndarray] = None,
                 quant: Optional[QuantState] = None,
                 next_ext: Optional[int] = None,
                 capacity: Optional[int] = None,
                 tier: Optional[TierConfig] = None, registry=None,
                 device=None):
        x = np.ascontiguousarray(x, np.float32)
        n = self._n = x.shape[0]
        self._d = x.shape[1]
        if ext_ids is not None and np.asarray(ext_ids).shape != (n,):
            raise ValueError("ext_ids must have one entry per row")
        if alive is not None and np.asarray(alive).shape != (n,):
            raise ValueError("alive must have one entry per row")
        # capacity starts at exactly n, so a build-once store pads its
        # device tables with sentinel = n
        self.capacity = max(int(capacity) if capacity is not None else n, n)
        # host arrays are preallocated to capacity and written by slice
        self._x = np.empty((self.capacity, self._d), np.float32)
        self._x[:n] = x
        self._alive = np.zeros(self.capacity, bool)
        self._alive[:n] = True if alive is None else np.asarray(alive, bool)
        self._ext = np.full(self.capacity, -1, np.int64)
        self._ext[:n] = (np.arange(n, dtype=np.int64) if ext_ids is None
                         else np.asarray(ext_ids, np.int64))
        self._ext2int = {int(e): i for i, e in enumerate(self._ext[:n])}
        if len(self._ext2int) != n:
            raise ValueError("external ids must be unique")
        self.next_ext = int(next_ext if next_ext is not None
                            else (self._ext[:n].max() + 1 if n else 0))
        self.quant = quant
        if quant is not None:
            self._codes = np.zeros((self.capacity,) + quant.codes.shape[1:],
                                   quant.codes.dtype)
            self._codes[:n] = quant.codes
            quant.codes = self._codes[:n]
        self.epoch = 0
        self.remap_epoch = 0
        self.rows_epoch = 0
        # observability (repro_torch.obs): mutation counters are typed
        # instruments, liveness and epochs a scrape-time collector keyed
        # "store" (a rebuilt store on the same registry replaces it)
        self.registry = registry
        if registry is not None:
            self._m_ins = registry.counter(
                "store_rows_inserted_total", "rows appended via add()")
            self._m_del = registry.counter(
                "store_rows_deleted_total", "rows tombstoned")
            self._m_cmp = registry.counter(
                "store_compactions_total", "compaction passes")
            self._m_drop = registry.counter(
                "store_rows_dropped_total", "tombstones reclaimed")
            registry.register_callback("store", self._collect_metrics)
        # tiered storage: rows/codes move to mmap-backed block files,
        # device residency becomes a bounded block cache on ``device``
        self.tier = tier if (tier is not None and tier.enabled) else None
        self.tier_dir: Optional[str] = None
        self.device = torch.device(device if device is not None else "cpu")
        self._rows_bf: Optional[BlockFile] = None
        self._codes_bf: Optional[BlockFile] = None
        self._row_cache: Optional[BlockCache] = None
        self._code_cache: Optional[BlockCache] = None
        self._tier_params: dict = {}
        if self.tier is not None:
            self._init_tier()

    # ------------------------------------------------------------------ tier
    def _init_tier(self) -> None:
        """Move the capacity buffers onto mmap-backed block files.

        The host arrays become views of the files, so every existing slice
        write (``add``, ``compact``) is write-through; the caches get told
        which blocks changed via :meth:`_tier_note_write`.
        """
        t = self.tier
        d = t.dir or tempfile.mkdtemp(prefix="repro-torch-tier-")
        os.makedirs(d, exist_ok=True)
        self.tier_dir = d
        bf = BlockFile(os.path.join(d, "rows.f32"), self.capacity,
                       self._d, np.float32, t.block_rows)
        bf.rows[: self._n] = self._x[: self._n]
        self._x = bf.rows
        self._rows_bf = bf
        self._row_cache = self._new_cache(bf, "rows", self.quant is None)
        if self.quant is not None:
            cbf = BlockFile(os.path.join(d, "codes.bin"), self.capacity,
                            self._codes.shape[1], self._codes.dtype,
                            t.block_rows)
            cbf.rows[: self._n] = self._codes[: self._n]
            self._codes = cbf.rows
            self.quant.codes = self._codes[: self._n]
            self._codes_bf = cbf
            self._code_cache = self._new_cache(cbf, "codes", True)

    def _new_cache(self, bf: BlockFile, name: str,
                   track_rows: bool) -> BlockCache:
        t = self.tier
        return BlockCache(bf, self._cache_slots(bf), name=name,
                          prefetch=t.prefetch, track_rows=track_rows,
                          tally_decay_every=t.tally_decay_every,
                          registry=self.registry,
                          fetch_retries=t.fetch_retries,
                          fetch_backoff_s=t.fetch_backoff_s,
                          device=self.device)

    def _cache_slots(self, bf: BlockFile) -> int:
        t = self.tier
        if t.cache_blocks:
            return min(t.cache_blocks, bf.n_blocks)
        return max(1, int(round(t.cache_frac * bf.n_blocks)))

    @property
    def tiered(self) -> bool:
        return self.tier is not None

    def tier_caches(self) -> list:
        """The live block caches (rows always, codes when quantized)."""
        return [c for c in (self._row_cache, self._code_cache)
                if c is not None]

    def full_phase_cache(self) -> Optional[BlockCache]:
        """The cache the full-graph scan reads (codes, else float32 rows)."""
        if not self.tiered:
            return None
        return self._code_cache if self._code_cache is not None \
            else self._row_cache

    def _tier_note_write(self, lo: int, hi: int) -> None:
        """Invalidate cached blocks covering written rows ``[lo, hi)``."""
        if not self.tiered or hi <= lo:
            return
        for c in self.tier_caches():
            c.note_write_rows(lo, hi)

    def tier_relayout(self) -> bool:
        """Re-cluster the full-phase cache's blocks around the workload
        (clustering by the accumulated touch tallies puts the workload's
        head into few blocks).  False when no touches were recorded."""
        c = self.full_phase_cache()
        return c.relayout(self._n) if c is not None else False

    def _tier_p(self, key, make):
        if key not in self._tier_params:
            self._tier_params[key] = make()
        return self._tier_params[key]

    def tiered_rows_table(self) -> TieredTable:
        """Snapshot float32 score table over the row tier (exact scores)."""
        return TieredTable.from_cache(self._row_cache, mode="f32",
                                      n=self.capacity)

    def tiered_codes_table(self) -> Optional[TieredTable]:
        """Snapshot quantized score table over the code tier."""
        if self._code_cache is None:
            return None
        q, dev = self.quant, self.device
        if q.mode == "sq8":
            return TieredTable.from_cache(
                self._code_cache, mode="sq8", n=self.capacity,
                p0=self._tier_p("scale", lambda: torch.as_tensor(
                    q.sq.scale, device=dev)),
                p1=self._tier_p("zero", lambda: torch.as_tensor(
                    q.sq.zero, device=dev)))
        return TieredTable.from_cache(
            self._code_cache, mode="pq", n=self.capacity,
            p0=self._tier_p("centroids", lambda: torch.as_tensor(
                q.pq.centroids, device=dev)))

    def tier_begin(self) -> None:
        """Cache housekeeping at a search boundary: apply completed
        prefetches and admit the hottest blocks missed since last time."""
        for c in self.tier_caches():
            c.apply_prefetch()
            c.maintain()

    def flush_tier(self) -> None:
        for bf in (self._rows_bf, self._codes_bf):
            if bf is not None:
                bf.flush()

    def export_tier(self, dest_dir: str) -> None:
        """Copy the tier files next to a checkpoint (no-op if same dir)."""
        if not self.tiered:
            return
        self.flush_tier()
        os.makedirs(dest_dir, exist_ok=True)
        for bf in (self._rows_bf, self._codes_bf):
            if bf is None:
                continue
            dst = os.path.join(dest_dir, os.path.basename(bf.path))
            if os.path.abspath(dst) != os.path.abspath(bf.path):
                shutil.copyfile(bf.path, dst)

    def tier_disk_nbytes(self) -> int:
        return sum(bf.disk_nbytes() for bf in (self._rows_bf, self._codes_bf)
                   if bf is not None)

    def drop_quant(self) -> None:
        """Forget the quantizer (float32 search); drops the code tier too."""
        self.quant = None
        if self._code_cache is not None:
            self._code_cache.close()
        self._code_cache = None
        self._codes_bf = None

    def should_compact(self, tombstone_ratio: float = 0.3) -> bool:
        """True when tombstones are worth reclaiming (background trigger)."""
        dead = self._n - self.live_count
        return dead > 0 and dead / self._n >= tombstone_ratio

    # ------------------------------------------------------------- accessors
    @property
    def n(self) -> int:
        """Total rows, live + tombstoned (the internal id space)."""
        return self._n

    @property
    def d(self) -> int:
        return self._d

    @property
    def x(self) -> np.ndarray:
        """(n, d) float32 row table — a view into the capacity buffer."""
        return self._x[: self._n]

    @property
    def alive(self) -> np.ndarray:
        """(n,) liveness bitmap view (False = tombstoned)."""
        return self._alive[: self._n]

    @property
    def ext_ids(self) -> np.ndarray:
        """(n,) stable external id per internal row (view)."""
        return self._ext[: self._n]

    @property
    def live_count(self) -> int:
        return int(self.alive.sum())

    def live_ids(self) -> np.ndarray:
        return np.flatnonzero(self.alive)

    def to_external(self, internal_ids: np.ndarray) -> np.ndarray:
        """Map internal ids to stable external ids (shape-preserving)."""
        return self.ext_ids[np.asarray(internal_ids)]

    def to_internal(self, external_ids: np.ndarray) -> np.ndarray:
        """Map external ids to current internal ids; KeyError if unknown."""
        flat = np.asarray(external_ids, np.int64).reshape(-1)
        out = np.array([self._ext2int[int(e)] for e in flat], np.int64)
        return out.reshape(np.asarray(external_ids).shape)

    # ------------------------------------------------------------- mutation
    def add(self, rows: np.ndarray,
            ext_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Append rows (encode-on-insert when quantized); returns ext ids."""
        rows = np.ascontiguousarray(np.atleast_2d(rows), np.float32)
        if rows.shape[1] != self.d:
            raise ValueError(f"dim mismatch: {rows.shape[1]} != {self.d}")
        m = rows.shape[0]
        if ext_ids is None:
            new_ext = np.arange(self.next_ext, self.next_ext + m,
                                dtype=np.int64)
        else:
            new_ext = np.asarray(ext_ids, np.int64)
            if new_ext.shape != (m,):
                raise ValueError("one external id per row required")
            if np.unique(new_ext).size != m:
                raise ValueError("duplicate external ids in batch")
            if any(int(e) in self._ext2int for e in new_ext):
                raise ValueError("external id already in use")
        if m == 0:
            return new_ext
        start = self._n
        if start + m > self.capacity:
            self._grow(_ceil_capacity(start + m))
        self._x[start:start + m] = rows
        self._alive[start:start + m] = True
        self._ext[start:start + m] = new_ext
        for j, e in enumerate(new_ext):
            self._ext2int[int(e)] = start + j
        self.next_ext = max(self.next_ext, int(new_ext.max()) + 1)
        self._n = start + m
        if self.quant is not None:
            self._codes[start:start + m] = self._encode(rows)
            self.quant.codes = self._codes[: self._n]
        self._tier_note_write(start, start + m)
        self.epoch += 1
        self.rows_epoch += 1
        if self.registry is not None:
            self._m_ins.inc(m)
        return new_ext

    def _grow(self, new_cap: int) -> None:
        """Reallocate the capacity buffers (geometric, so O(1) amortized)."""
        n = self._n
        if self.tiered:
            # block files grow in place; the caches are re-keyed (block
            # count changed) with their lifetime counters carried over
            self._rows_bf.resize(new_cap)
            self._x = self._rows_bf.rows
            self._row_cache = self._rekey_cache(self._row_cache,
                                                self._rows_bf)
            if self._codes_bf is not None:
                self._codes_bf.resize(new_cap)
                self._codes = self._codes_bf.rows
                self.quant.codes = self._codes[:n]
                self._code_cache = self._rekey_cache(self._code_cache,
                                                     self._codes_bf)
        else:
            x = np.empty((new_cap, self._d), np.float32)
            x[:n] = self._x[:n]
            self._x = x
            if self.quant is not None:
                c = np.zeros((new_cap,) + self._codes.shape[1:],
                             self._codes.dtype)
                c[:n] = self._codes[:n]
                self._codes = c
                self.quant.codes = self._codes[:n]
        a = np.zeros(new_cap, bool)
        a[:n] = self._alive[:n]
        self._alive = a
        e = np.full(new_cap, -1, np.int64)
        e[:n] = self._ext[:n]
        self._ext = e
        self.capacity = new_cap

    def _rekey_cache(self, old: BlockCache, bf: BlockFile) -> BlockCache:
        """A cache over the resized file; the old one and its arena go."""
        old.close()
        old._arena = None           # free the old arena before the new one
        new = self._new_cache(bf, old.name, old._track_rows)
        new.fetch_retries = old.fetch_retries
        new.fetch_backoff_s = old.fetch_backoff_s
        new.counters = old.counters
        new._snap_prev = dict(old._snap_prev)   # snapshot window survives
        new.chaos = old.chaos       # an armed fault plan survives growth
        return new

    def _encode(self, rows: np.ndarray) -> np.ndarray:
        """Encode rows with the already-trained codebooks (no retraining)."""
        if self.quant.mode == "sq8":
            return sq_encode(rows, self.quant.sq)
        return pq_encode(rows, self.quant.pq)

    def mark_dead(self, external_ids: np.ndarray) -> np.ndarray:
        """Tombstone rows by external id; returns their internal ids."""
        internal = np.unique(self.to_internal(
            np.asarray(external_ids).reshape(-1)))
        if not self.alive[internal].all():
            raise ValueError("row already tombstoned")
        self.alive[internal] = False
        self.epoch += 1
        if self.registry is not None:
            self._m_del.inc(internal.size)
        return internal

    def compact(self) -> CompactionResult:
        """Drop tombstoned rows; returns the old→new internal id remap."""
        n_before = self._n
        keep = self.alive.copy()
        remap = np.full(n_before, -1, np.int64)
        n_after = int(keep.sum())
        remap[keep] = np.arange(n_after)
        # left-pack the capacity buffers in place (the fancy-indexed right
        # side is a copy, so the overlapping assignment is safe)
        self._x[:n_after] = self._x[:n_before][keep]
        self._ext[:n_after] = self._ext[:n_before][keep]
        self._ext[n_after:] = -1
        self._alive[:n_after] = True
        self._alive[n_after:] = False
        self._n = n_after
        self._ext2int = {int(e): i for i, e in enumerate(self.ext_ids)}
        if self.quant is not None:
            self._codes[:n_after] = self._codes[:n_before][keep]
            self.quant.codes = self._codes[:n_after]
        self._tier_note_write(0, n_before)
        # capacity is sticky: shapes stay stable across compaction too
        self.epoch += 1
        self.rows_epoch += 1
        self.remap_epoch += 1
        if self.registry is not None:
            self._m_cmp.inc()
            self._m_drop.inc(n_before - n_after)
        return CompactionResult(remap=remap, n_before=n_before,
                                n_after=self._n)

    # ------------------------------------------------------- device padding
    def padded_rows(self, device=None) -> torch.Tensor:
        """(capacity+1, d) device table; rows ≥ n are huge-valued padding."""
        pad = self.capacity + 1 - self.n
        filler = np.full((pad, self.d), _PAD_VALUE, np.float32)
        return torch.as_tensor(np.concatenate([self.x, filler]),
                               device=device)

    def padded_live(self, device=None) -> torch.Tensor:
        """(capacity+1,) bool liveness; padding rows and sentinel are dead."""
        pad = self.capacity + 1 - self.n
        return torch.as_tensor(
            np.concatenate([self.alive, np.zeros(pad, bool)]), device=device)

    def pad_adjacency(self, adj: np.ndarray, device=None) -> torch.Tensor:
        """(capacity+1, R) device adjacency from a free-slot (-1) host graph;
        on the device the sentinel is ``capacity``, the padded tables'
        no-op row."""
        cap = self.capacity
        if adj.shape[0] != self.n:
            raise ValueError(f"adjacency rows {adj.shape[0]} != n {self.n}")
        dev = np.where(adj < 0, cap, adj).astype(np.int32)
        filler = np.full((cap + 1 - self.n, adj.shape[1]), cap, np.int32)
        return torch.as_tensor(np.concatenate([dev, filler]), device=device)

    def padded_quant_table(self, device=None):
        """Device score table sized to capacity (None when not quantized)."""
        if self.quant is None:
            return None
        return self.quant.device_table(capacity=self.capacity, device=device)

    # ---------------------------------------------------------- persistence
    def _collect_metrics(self) -> dict:
        """Registry scrape-time collector (keyed ``"store"``)."""
        return {"store_rows": float(self._n),
                "store_live_rows": float(self.live_count),
                "store_tombstones": float(self._n - self.live_count),
                "store_capacity": float(self.capacity),
                "store_epoch": float(self.epoch),
                "store_remap_epoch": float(self.remap_epoch)}

    def to_arrays(self, prefix: str = "store_") -> dict:
        """The reference checkpoint's store keys (and ``quant_*``)."""
        out = {"x": self.x,
               prefix + "alive": self.alive,
               prefix + "ext_ids": self.ext_ids,
               prefix + "next_ext": np.int64(self.next_ext),
               prefix + "capacity": np.int64(self.capacity)}
        if self.quant is not None:
            out.update(self.quant.to_arrays())
        return out

    @classmethod
    def from_arrays(cls, arrays, prefix: str = "store_",
                    tier: Optional[TierConfig] = None, registry=None,
                    device=None) -> "VectorStore":
        """Rebuild from :meth:`to_arrays` output (or a checkpoint holding
        only ``x``, for which everything defaults to live).

        With ``tier`` the rebuilt store spills to block files under
        ``tier.dir`` (its caches on ``device``) — the checkpoint arrays
        stay the canonical copy, the tier is (re)materialized from them.
        """
        get = lambda key: arrays[key] if key in arrays else None
        nxt = get(prefix + "next_ext")
        cap = get(prefix + "capacity")
        return cls(arrays["x"], alive=get(prefix + "alive"),
                   ext_ids=get(prefix + "ext_ids"),
                   next_ext=int(nxt) if nxt is not None else None,
                   capacity=int(cap) if cap is not None else None,
                   quant=QuantState.from_arrays(arrays), tier=tier,
                   registry=registry, device=device)
