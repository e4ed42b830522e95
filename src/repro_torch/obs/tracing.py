"""Per-query search traces: deterministic sampling + a bounded trace log.

A trace is one dict per *sampled* request, assembled by the wave engine at
lane retirement from state it already holds on the host — hot-phase hop /
distance-eval counts captured at refill, full-phase ``SearchStats`` read
from the same device→host transfer the retirement path performs anyway,
queue-wait vs service split from the lane metadata timestamps, and tier
faults from the block-cache counters.  The unsampled path does no extra
device syncs and allocates nothing.

Sampling is a pure function of ``(seed, request_id)`` — no RNG state — so
a replayed request stream samples the *same* requests (deterministic under
a fixed seed, the property the tests pin), and the decision can be
re-derived anywhere without threading flags through the queue.
"""

from __future__ import annotations

import collections
from typing import Iterator, List

__all__ = ["sample_decision", "TraceLog"]

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def sample_decision(seed: int, rid: int, rate: float) -> bool:
    """True iff request ``rid`` is sampled at ``rate`` under ``seed``.

    Pure and stateless: the same ``(seed, rid)`` always lands on the same
    side of the rate threshold.
    """
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = _splitmix64(_splitmix64(seed & _MASK64) ^ (rid & _MASK64))
    return (h >> 11) * (1.0 / (1 << 53)) < rate


class TraceLog:
    """Bounded FIFO of per-query trace dicts (oldest dropped when full)."""

    def __init__(self, capacity: int = 1024):
        self._buf: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self.total = 0          # traces ever added (dropped = total - len)

    def add(self, trace: dict) -> None:
        self._buf.append(dict(trace))
        self.total += 1

    @property
    def dropped(self) -> int:
        return self.total - len(self._buf)

    def snapshot(self) -> List[dict]:
        return list(self._buf)

    def drain(self) -> List[dict]:
        out = list(self._buf)
        self._buf.clear()
        return out

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[dict]:
        return iter(list(self._buf))
