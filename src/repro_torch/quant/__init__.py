"""Quantized-vector subsystem of the port: compressed Full Index tables.

Scalar int8 (:mod:`~repro_torch.quant.sq`) and product quantization
(:mod:`~repro_torch.quant.pq`) trainers with encode/decode (numpy, the
reference's own arithmetic), plus the device-side score tables
(:mod:`~repro_torch.quant.types`) the beam search scans instead of float32
rows.  :func:`build_quantizer` is the single entry point DQF uses; it reads
the ``QuantConfig`` fields duck-typed so this package never imports
:mod:`repro_torch.core`.
"""

from __future__ import annotations

import numpy as np

from .types import (PQCodebook, PQTable, PQView, QuantState, SQCodebook,
                    SQTable)  # noqa: F401
from .sq import train_sq, sq_encode, sq_decode  # noqa: F401
from .pq import train_pq, pq_encode, pq_decode, pq_luts  # noqa: F401

__all__ = ["build_quantizer", "QuantState", "SQCodebook", "PQCodebook",
           "SQTable", "PQTable", "PQView", "train_sq", "sq_encode",
           "sq_decode", "train_pq", "pq_encode", "pq_decode", "pq_luts"]


def build_quantizer(x: np.ndarray, qcfg) -> QuantState:
    """Train + encode the dataset per ``qcfg`` (a core.types.QuantConfig).

    ``qcfg.mode``: "sq8" (per-dim affine int8) or "pq" (product quantizer
    with ``pq_m`` subspaces × ``2**pq_bits`` centroids).
    """
    x = np.asarray(x, np.float32)
    if qcfg.mode == "sq8":
        cb = train_sq(x)
        return QuantState("sq8", sq_encode(x, cb), sq=cb)
    if qcfg.mode == "pq":
        cb = train_pq(x, m=qcfg.pq_m, k=2 ** qcfg.pq_bits,
                      iters=qcfg.pq_iters, seed=qcfg.seed)
        return QuantState("pq", pq_encode(x, cb), pq=cb)
    raise ValueError(f"unknown quant mode {qcfg.mode!r}")
