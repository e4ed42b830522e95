"""Complexity model and optimal index ratio (paper §4.4, Eq. 5-12); a copy
of the reference module (numpy only).

C(IR) = log(IR·n) + p(IR)·log(n), with p the Zipf-tail miss probability
(Eq. 8).  We provide both the paper's closed form for the optimal IR
(Eq. 12) and a direct numeric minimizer of Eq. 9.

Reproduction note: evaluating Eq. 12 at the paper's own example
(n = 1e6, β = 1.2) gives IR* ≈ 2.2e-4, and the numeric minimum of Eq. 9 is
≈ 2.4e-4 — *not* the "approximately 0.002" quoted in §4.4 (off by ~10×,
likely a log-base slip in the paper's arithmetic).  The paper then chooses
IR = 0.01 for practice anyway; our benchmarks sweep IR (Fig. 7) and confirm
the flat optimum region the paper reports.
"""

from __future__ import annotations

import numpy as np

__all__ = ["miss_probability", "search_cost", "optimal_ir_closed_form",
           "optimal_ir_numeric"]


def miss_probability(ir: np.ndarray | float, n: int, beta: float) -> np.ndarray:
    """Eq. 8: P(query not resolvable in a hot index of size IR·n)."""
    ir = np.asarray(ir, np.float64)
    m = np.maximum(ir * n, 1.0)
    e = 1.0 - beta
    return 1.0 - (1.0 - m ** e) / (1.0 - float(n) ** e)


def search_cost(ir, n: int, beta: float) -> np.ndarray:
    """Eq. 9: expected cost C(IR) (natural log, matching Eq. 5)."""
    ir = np.asarray(ir, np.float64)
    return np.log(np.maximum(ir * n, 1.0 + 1e-9)) \
        + miss_probability(ir, n, beta) * np.log(n)


def optimal_ir_closed_form(n: int, beta: float) -> float:
    """Eq. 12 as printed in the paper."""
    e = 1.0 - beta
    num = float(n) ** e - 1.0
    den = e * np.log(n) * float(n) ** e
    return float((num / den) ** (1.0 / e))


def optimal_ir_numeric(n: int, beta: float, grid: int = 20_000) -> float:
    """Direct minimizer of Eq. 9 on a log grid over IR ∈ [1/n, 1]."""
    ir = np.logspace(np.log10(1.0 / n), 0.0, grid)
    return float(ir[int(np.argmin(search_cost(ir, n, beta)))])
