"""Query-workload modeling (paper §3.2, §5.1.2); a copy of the reference
module, so the same seed draws the same queries in both packages.

The paper simulates user preference by sampling query *targets* from a Zipf
distribution (β = 1.2, the hot-event exponent of [35]) over the data points,
then perturbing: a query is a noisy copy of its target, so its true nearest
neighbors concentrate around the target.  Temporal drift is modeled by
re-drawing the popularity ranking (a "trend change"), which is exactly the
event that invalidates a recency-built index like PANNS but only requires a
hot-index rebuild in DQF.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ZipfWorkload", "zipf_probs"]


def zipf_probs(n: int, beta: float) -> np.ndarray:
    """P(rank r) ∝ r^-beta, r = 1..n (Eq. 4)."""
    p = np.arange(1, n + 1, dtype=np.float64) ** (-beta)
    return p / p.sum()


@dataclasses.dataclass
class ZipfWorkload:
    """Zipf-skewed query stream over a dataset.

    ``rank_of_point[i]`` is point i's popularity rank (0 = hottest).  A query
    targets point i with prob ∝ (rank+1)^-beta and equals x_i + sigma * noise.
    """

    x: np.ndarray
    beta: float = 1.2
    sigma: float = 0.05
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        n = self.x.shape[0]
        self.rank_to_point = self._rng.permutation(n)
        self.probs = zipf_probs(n, self.beta)
        # Per-dim noise scale tied to the dataset's own spread.
        self._noise_scale = float(self.x.std()) * self.sigma

    def drift(self, fraction: float = 1.0) -> None:
        """Re-draw popularity for a fraction of ranks (trend change)."""
        n = self.rank_to_point.shape[0]
        m = int(n * fraction)
        if m <= 1:
            return
        sel = self._rng.choice(n, size=m, replace=False)
        self.rank_to_point[np.sort(sel)] = self.rank_to_point[
            sel[self._rng.permutation(m)]]

    def hot_set(self, size: int) -> np.ndarray:
        """Ground-truth hottest ``size`` point ids (head of the Zipf)."""
        return self.rank_to_point[:size].copy()

    def sample(self, num: int, with_targets: bool = False):
        """Draw ``num`` queries; optionally return their target point ids."""
        ranks = self._rng.choice(self.probs.size, size=num, p=self.probs)
        targets = self.rank_to_point[ranks]
        noise = self._rng.standard_normal(
            (num, self.x.shape[1])).astype(np.float32)
        q = self.x[targets].astype(np.float32) + self._noise_scale * noise
        if with_targets:
            return q, targets
        return q
