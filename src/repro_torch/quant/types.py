"""Shared types for the quantized-vector subsystem (port of
``repro/quant/types.py``).

Two representations live side by side:

* **host side** (numpy): :class:`SQCodebook` / :class:`PQCodebook` hold the
  trained quantizer parameters, :class:`QuantState` bundles them with the
  encoded dataset for persistence and byte accounting;
* **device side** (torch): :class:`SQTable` / :class:`PQTable` take the
  place of the float32 ``x_pad`` vector table in the beam search.  They
  expose the *score-table protocol*::

      table.n                        # number of real rows (sentinel = n)
      table.with_queries(q)          # per-search view (PQ builds its LUTs)
      view.gather_score(q, cols)     # (B, C) approx squared-L2 distances
      view.spec()                    # the fused hop's (mode, t0, t1, t2)

  ``repro_torch.core.beam_search`` dispatches on this protocol: a plain
  tensor takes the exact float32 path, anything else scores itself.  The
  scorers are the plain versions of the fused hop's (``ref.sq8_score``,
  ``ref.pq_score``), so the composed and fused paths agree bit for bit.

Row ids are global with sentinel ``n``; the code tables carry zero rows
from ``n`` on (the sentinel and any capacity padding) whose decoded
distance is garbage — every consumer masks those ids to ``INF_DIST``
before use, so they only have to be gatherable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.kernels import ref

__all__ = ["SQCodebook", "PQCodebook", "SQTable", "PQTable", "PQView",
           "QuantState"]


# ------------------------------------------------------------- host codebooks
class SQCodebook(NamedTuple):
    """Per-dimension affine int8 scalar quantizer: x ≈ zero + scale · code."""

    scale: np.ndarray   # (d,) float32, strictly positive
    zero: np.ndarray    # (d,) float32


class PQCodebook(NamedTuple):
    """Product quantizer: M subspaces × K centroids of dim d/M each."""

    centroids: np.ndarray   # (M, K, dsub) float32

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def k(self) -> int:
        return self.centroids.shape[1]


# ----------------------------------------------------------- device tables
class SQTable(NamedTuple):
    """Device-side int8 table implementing the score-table protocol."""

    codes: torch.Tensor   # (n+1, d) int8; rows from n on are zeros
    scale: torch.Tensor   # (d,) float32
    zero: torch.Tensor    # (d,) float32

    @property
    def n(self) -> int:
        return self.codes.shape[0] - 1

    def with_queries(self, queries: torch.Tensor) -> "SQTable":
        return self

    def spec(self):
        """The fused hop's ``(mode, t0, t1, t2)``."""
        return "sq8", self.codes, self.scale, self.zero

    def gather_score(self, queries: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
        """(B, C) squared L2 against the decoded rows ``cols``."""
        return ref.sq8_score(self.codes, self.scale, self.zero, queries, cols)


class PQView(NamedTuple):
    """Per-search PQ view: codes + the query batch's distance LUTs."""

    codes: torch.Tensor   # (n+1, M) uint8 — resident table stays 1 B/code
    luts: torch.Tensor    # (B, M, K) float32

    @property
    def n(self) -> int:
        return self.codes.shape[0] - 1

    def with_queries(self, queries: torch.Tensor) -> "PQView":
        return self

    def spec(self):
        """The fused hop's ``(mode, t0, t1, t2)``."""
        return "pq", self.codes, self.luts, None

    def gather_score(self, queries: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
        """ADC: distance(b, i) = Σ_m lut[b, m, codes[i, m]]."""
        return ref.pq_score(self.codes, self.luts, cols)


class PQTable(NamedTuple):
    """Device-side PQ table; builds per-query LUTs at search entry."""

    codes: torch.Tensor       # (n+1, M) uint8
    centroids: torch.Tensor   # (M, K, dsub) float32

    @property
    def n(self) -> int:
        return self.codes.shape[0] - 1

    def with_queries(self, queries: torch.Tensor) -> PQView:
        from .pq import pq_luts   # deferred: types ↛ pq at import time
        return PQView(self.codes, pq_luts(queries, self.centroids))


# --------------------------------------------------------------- host bundle
@dataclasses.dataclass
class QuantState:
    """Trained quantizer + encoded dataset (host side, persistable)."""

    mode: str                          # "sq8" | "pq"
    codes: np.ndarray                  # (n, d) int8 | (n, M) uint8
    sq: Optional[SQCodebook] = None
    pq: Optional[PQCodebook] = None

    def nbytes(self) -> int:
        """Codes + codebook bytes (what a compressed Full Index stores)."""
        if self.mode == "sq8":
            extra = self.sq.scale.nbytes + self.sq.zero.nbytes
        else:
            extra = self.pq.centroids.nbytes
        return int(self.codes.nbytes) + int(extra)

    def decode(self) -> np.ndarray:
        """Reconstruct the float32 approximation of the dataset."""
        from .pq import pq_decode
        from .sq import sq_decode
        if self.mode == "sq8":
            return sq_decode(self.codes, self.sq)
        return pq_decode(self.codes, self.pq)

    def device_table(self, capacity: Optional[int] = None, device=None
                     ) -> Union[SQTable, PQTable]:
        """Upload as a score table with the sentinel row appended.

        With ``capacity`` the code table is zero-padded to ``capacity + 1``
        rows so its shape tracks the padded vector table — padding rows
        decode to garbage but are masked like the sentinel.
        """
        n = self.codes.shape[0]
        rows = 1 if capacity is None else capacity + 1 - n
        if rows < 1:
            raise ValueError(f"capacity {capacity} < code rows {n}")
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        pad = np.zeros((rows, self.codes.shape[1]), self.codes.dtype)
        codes = t(np.concatenate([self.codes, pad]))
        if self.mode == "sq8":
            return SQTable(codes=codes, scale=t(self.sq.scale),
                           zero=t(self.sq.zero))
        return PQTable(codes=codes, centroids=t(self.pq.centroids))

    # ---------------------------------------------------------- persistence
    def to_arrays(self) -> dict:
        """The reference checkpoint's ``quant_*`` keys."""
        out = {"quant_mode": np.array(self.mode), "quant_codes": self.codes}
        if self.mode == "sq8":
            out["quant_scale"] = self.sq.scale
            out["quant_zero"] = self.sq.zero
        else:
            out["quant_centroids"] = self.pq.centroids
        return out

    @classmethod
    def from_arrays(cls, arrays) -> Optional["QuantState"]:
        """Read the ``quant_*`` keys back; None when there are none."""
        if "quant_mode" not in arrays:
            return None
        mode = str(arrays["quant_mode"])
        codes = np.asarray(arrays["quant_codes"])
        if mode == "sq8":
            return cls(mode, codes.astype(np.int8), sq=SQCodebook(
                scale=np.asarray(arrays["quant_scale"], np.float32),
                zero=np.asarray(arrays["quant_zero"], np.float32)))
        if mode == "pq":
            return cls(mode, codes.astype(np.uint8), pq=PQCodebook(
                centroids=np.asarray(arrays["quant_centroids"], np.float32)))
        raise ValueError(f"unknown quant mode {mode!r}")
