"""Scalar int8 quantization (per-dimension affine), copied from
``repro/quant/sq.py``: training and encoding are numpy, expression for
expression, so the same data gives byte-equal codes and parameters.

Each dimension gets an affine map ``x ≈ zero_d + scale_d · c`` with
``c ∈ [-127, 127]``.  The reconstruction error is bounded by half a
quantization step per dimension.
"""

from __future__ import annotations

import numpy as np

from .types import SQCodebook

__all__ = ["train_sq", "sq_encode", "sq_decode"]

# codes span [-127, 127] — 254 steps across the observed per-dim range.
_LEVELS = 254.0
_CMAX = 127


def train_sq(x: np.ndarray) -> SQCodebook:
    """Fit per-dimension affine int8 parameters to the dataset range."""
    x = np.asarray(x, np.float32)
    lo = x.min(axis=0).astype(np.float64)
    hi = x.max(axis=0).astype(np.float64)
    zero = (lo + hi) / 2.0
    scale = np.maximum((hi - lo) / _LEVELS, 1e-8)
    return SQCodebook(scale=scale.astype(np.float32),
                      zero=zero.astype(np.float32))


def sq_encode(x: np.ndarray, cb: SQCodebook) -> np.ndarray:
    """(N, d) float32 → (N, d) int8 codes."""
    x = np.asarray(x, np.float32)
    c = np.rint((x - cb.zero) / cb.scale)
    return np.clip(c, -_CMAX, _CMAX).astype(np.int8)


def sq_decode(codes: np.ndarray, cb: SQCodebook) -> np.ndarray:
    """(N, d) int8 codes → (N, d) float32 reconstruction."""
    return (codes.astype(np.float32) * cb.scale + cb.zero).astype(np.float32)
