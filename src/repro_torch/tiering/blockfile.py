"""Mmap-backed host block file: the disk tier under the device cache (a
copy of ``repro/tiering/blockfile.py``: numpy only).

A :class:`BlockFile` stores a ``(rows, width)`` table as fixed-size row
blocks in one flat file.  The file is padded to a whole number of blocks
(rows past the logical capacity read as zeros), so the cache can always
move whole ``(block_rows, width)`` tiles without edge cases.  Writes go
through the same memmap the store's host arrays alias, which is what makes
the tier *write-through*: ``VectorStore.add``'s slice assignment lands in
the file directly.

Capacity follows the store's padded-table convention: a power of two, so a
power-of-two ``block_rows ≤ capacity`` always divides it evenly and the
sentinel row id ``capacity`` falls exactly on the first out-of-file block
(the cache maps it to its permanent zero block).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["BlockFile"]


class BlockFile:
    """One flat file of fixed-size row blocks behind an ``np.memmap``."""

    def __init__(self, path: str, capacity: int, width: int, dtype,
                 block_rows: int):
        self.path = path
        self.dtype = np.dtype(dtype)
        self.width = int(width)
        # Clamp so one block never exceeds the table: capacity is a power
        # of two >= 8, so the clamped value still divides it exactly.
        br = int(block_rows)
        while br > capacity:
            br //= 2
        self.block_rows = max(1, br)
        self.log2_block = self.block_rows.bit_length() - 1
        self.capacity = 0
        self.n_blocks = 0
        self.rows: np.memmap = None
        self._open(int(capacity), create=True)

    def _open(self, capacity: int, create: bool) -> None:
        n_blocks = -(-capacity // self.block_rows)
        file_rows = n_blocks * self.block_rows
        nbytes = file_rows * self.width * self.dtype.itemsize
        if create and not os.path.exists(self.path):
            with open(self.path, "wb") as f:
                f.truncate(nbytes)
        else:
            with open(self.path, "r+b") as f:
                if os.path.getsize(self.path) < nbytes:
                    f.truncate(nbytes)
        self.rows = np.memmap(self.path, dtype=self.dtype, mode="r+",
                              shape=(file_rows, self.width))
        self.capacity = capacity
        self.n_blocks = n_blocks

    # ---------------------------------------------------------------- access
    def read_block(self, bid: int) -> np.ndarray:
        """Copy one ``(block_rows, width)`` tile out of the file."""
        lo = int(bid) * self.block_rows
        return np.array(self.rows[lo: lo + self.block_rows])

    def read_rows(self, ids: np.ndarray) -> np.ndarray:
        """Gather arbitrary rows (copy)."""
        return np.array(self.rows[np.asarray(ids)])

    def block_of(self, row: int) -> int:
        return int(row) >> self.log2_block

    # ------------------------------------------------------------- lifecycle
    def resize(self, new_capacity: int) -> None:
        """Grow the file to a larger capacity (contents preserved)."""
        if new_capacity < self.capacity:
            raise ValueError("block files never shrink")
        self.rows.flush()
        self.rows = None            # release before re-truncating
        self._open(int(new_capacity), create=False)

    def flush(self) -> None:
        self.rows.flush()

    def disk_nbytes(self) -> int:
        return int(os.path.getsize(self.path))
