"""Windowed time series over registry scrapes (the sentinel's memory).

The flight recorder (:mod:`repro_torch.obs.metrics`) answers "what is the
value *now*"; nothing there answers "what has it been doing".  A
byte-budget governor, the SLO burn-rate alerts
(:mod:`repro_torch.obs.slo`) and any human staring at a regressing engine all
need the same primitive: a bounded history of ``scrape()`` snapshots
with derived rates.  :class:`TimeSeries` is that primitive:

* a **ring buffer** of ``(t, {series: value})`` snapshots — memory is
  bounded by ``capacity`` no matter how long the engine runs;
* a **cadence gate** (:meth:`maybe_sample`): callers invoke it every
  tick and pay one ``scrape()`` only when ``interval_s`` has elapsed,
  so sampling cost is decoupled from tick rate;
* **derived rates/deltas**: counters (``*_total`` series) become
  windowed per-second rates — qps is ``rate("engine_completed_total")``,
  tick rate is ``rate("engine_ticks_total")`` — while gauges
  (occupancy, queue depth, tier hit-rate) are already point-in-time
  series readable via :meth:`series`;
* **JSON export** (:meth:`export`): a column-oriented document (shared
  time axis, one array per series) that debug bundles embed and offline
  tooling can plot directly.

The clock is injectable so tests drive deterministic timelines; the
default is ``time.monotonic`` (wall-clock jumps must not corrupt
windows).  Everything is stdlib-only, same as the rest of ``repro_torch.obs``.
"""

from __future__ import annotations

import collections
import json
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["TimeSeries"]


class TimeSeries:
    """Bounded snapshot recorder + windowed rate/delta queries."""

    def __init__(self, registry, *, capacity: int = 512,
                 interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (rates need a window)")
        self.registry = registry
        self.capacity = int(capacity)
        self.interval_s = float(interval_s)
        self.clock = clock
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self.samples_total = 0          # ever taken (dropped = total - len)

    # -------------------------------------------------------------- sampling
    def sample(self, now: Optional[float] = None) -> dict:
        """Take one snapshot unconditionally; returns the scrape dict."""
        t = self.clock() if now is None else float(now)
        snap = self.registry.scrape()
        self._buf.append((t, snap))
        self.samples_total += 1
        return snap

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Snapshot iff ``interval_s`` elapsed since the last one.

        The per-call cost on the gated path is one clock read and one
        comparison — callers can safely invoke this every engine tick.
        """
        t = self.clock() if now is None else float(now)
        if self._buf and t - self._buf[-1][0] < self.interval_s:
            return False
        self.sample(now=t)
        return True

    # --------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        return self.samples_total - len(self._buf)

    def span_s(self) -> float:
        """Wall span covered by the buffered window."""
        if len(self._buf) < 2:
            return 0.0
        return self._buf[-1][0] - self._buf[0][0]

    def names(self) -> List[str]:
        """Union of series names across the buffered snapshots."""
        seen: Dict[str, None] = {}
        for _, snap in self._buf:
            for k in snap:
                seen.setdefault(k)
        return list(seen)

    def series(self, name: str, window_s: Optional[float] = None
               ) -> Tuple[List[float], List[float]]:
        """``(times, values)`` for one series (snapshots missing it skip).

        ``window_s`` keeps only samples within that many seconds of the
        newest snapshot.
        """
        if not self._buf:
            return [], []
        t_lo = (self._buf[-1][0] - window_s) if window_s is not None \
            else -math.inf
        ts, vs = [], []
        for t, snap in self._buf:
            if t >= t_lo and name in snap:
                ts.append(t)
                vs.append(float(snap[name]))
        return ts, vs

    def latest(self, name: str, default: float = math.nan) -> float:
        """Newest buffered value of a series (scans back past gaps)."""
        for _, snap in reversed(self._buf):
            if name in snap:
                return float(snap[name])
        return default

    def delta(self, name: str, window_s: Optional[float] = None) -> float:
        """last - first over the window (NaN with fewer than 2 points)."""
        _, vs = self.series(name, window_s)
        if len(vs) < 2:
            return math.nan
        return vs[-1] - vs[0]

    def rate(self, name: str, window_s: Optional[float] = None) -> float:
        """Windowed per-second rate of a counter series.

        ``(last - first) / (t_last - t_first)`` over the window, clamped
        at zero: a counter that moved backwards was reset (component
        rebuilt, collector replaced) and a negative qps would poison
        every consumer downstream.  NaN when the window holds fewer than
        two points.
        """
        ts, vs = self.series(name, window_s)
        if len(vs) < 2 or ts[-1] <= ts[0]:
            return math.nan
        return max(vs[-1] - vs[0], 0.0) / (ts[-1] - ts[0])

    def rates(self, window_s: Optional[float] = None) -> Dict[str, float]:
        """Derived per-second rates for every ``*_total`` counter series."""
        out = {}
        for name in self.names():
            base = name.partition("{")[0]
            if base.endswith("_total"):
                r = self.rate(name, window_s)
                if not math.isnan(r):
                    out[name[:-6] + "_per_s" if "{" not in name else
                        base[:-6] + "_per_s{" + name.partition("{")[2]] = r
        return out

    # ---------------------------------------------------------------- export
    def to_doc(self) -> dict:
        """Column-oriented JSON document: shared time axis + one array per
        series (``null`` where a snapshot missed the series — strictly
        valid JSON, non-finite values are nulled too)."""
        times = [t for t, _ in self._buf]
        cols: Dict[str, list] = {}
        for i, (_, snap) in enumerate(self._buf):
            for k, v in snap.items():
                col = cols.setdefault(k, [None] * len(times))
                v = float(v)
                col[i] = v if math.isfinite(v) else None
        return {"interval_s": self.interval_s,
                "capacity": self.capacity,
                "samples_total": self.samples_total,
                "dropped": self.dropped,
                "t": times,
                "series": cols}

    def export(self, path: Optional[str] = None):
        """The JSON document; written to ``path`` when given."""
        doc = self.to_doc()
        if path is None:
            return doc
        with open(path, "w") as f:
            json.dump(doc, f, allow_nan=False)
        return path
