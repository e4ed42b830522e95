"""Zero-dependency typed metrics: counters, gauges, log-bucketed histograms.

One :class:`MetricsRegistry` is the scrape surface for a whole serving
stack: engine retirement stats, block-cache counters, store mutation
counts and per-tenant preference gauges all land in a single flat
``scrape()`` dict (and a Prometheus-style text :meth:`exposition`).

Two publishing styles coexist on purpose:

* **Typed instruments** (:class:`Counter` / :class:`Gauge` /
  :class:`Histogram`) for hot-path observations the caller makes
  explicitly — e.g. the engine observing a retirement latency.  Histograms
  are log-bucketed with a *fixed* bucket count, so a long-running engine's
  memory stays bounded and p50/p95/p99 come deterministically from the
  bucket counts (no sample deque, no ``np.percentile`` scrape).
* **Collector callbacks** (:meth:`MetricsRegistry.register_callback`) for
  state that already lives somewhere — ``EngineStats`` fields,
  ``BlockCache.counters``, tenant counter head mass.  The callback runs at
  scrape time, costs nothing between scrapes, and is *keyed*: a component
  that is rebuilt (store swap, new engine) re-registers under its key and
  the stale closure is dropped.

Labels ride as keyword arguments (``c.inc(tenant="a")``); a labeled series
scrapes as ``name{tenant=a}``.  Everything is stdlib-only so the module
imports nowhere near torch — safe from any layer, including kernel code.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _flat_name(name: str, key: tuple) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


def _escape(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline.

    Without this a label like ``path="a\nb"`` splits the exposition line
    and corrupts every scrape of the whole registry.
    """
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-text escaping (backslash and newline only, per the spec)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _requote(flat: str) -> str:
    """``name{k=v,...}`` → Prometheus ``name{k="v",...}`` (values escaped)."""
    if "{" not in flat:
        return flat
    name, _, rest = flat.partition("{")
    pairs = []
    for item in rest.rstrip("}").split(","):
        k, _, v = item.partition("=")
        pairs.append(f'{k}="{_escape(v)}"')
    return name + "{" + ",".join(pairs) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def scrape_into(self, out: dict) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def header_lines(self) -> Iterable[str]:
        """``# HELP`` (when set) + ``# TYPE``, once per metric family."""
        if self.help:
            yield f"# HELP {self.name} {_escape_help(self.help)}"
        yield f"# TYPE {self.name} {self.kind}"

    def exposition_lines(self) -> Iterable[str]:
        flat: dict = {}
        self.scrape_into(flat)
        yield from self.header_lines()
        for k, v in flat.items():
            yield f"{_requote(k)} {v:g}"


class Counter(_Metric):
    """Monotonically increasing value, one series per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[tuple, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def scrape_into(self, out: dict) -> None:
        if not self._values:
            out[self.name] = 0.0
            return
        for k, v in sorted(self._values.items()):
            out[_flat_name(self.name, k)] = v


class Gauge(_Metric):
    """Point-in-time value; ``set_function`` defers to a callable at scrape."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[tuple, object] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            cur = self._values.get(k, 0.0)
            self._values[k] = (float(cur) if not callable(cur) else 0.0) \
                + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = fn

    def value(self, **labels) -> float:
        v = self._values.get(_label_key(labels), 0.0)
        return float(v()) if callable(v) else float(v)

    def scrape_into(self, out: dict) -> None:
        if not self._values:
            out[self.name] = 0.0
            return
        for k, v in sorted(self._values.items()):
            try:
                out[_flat_name(self.name, k)] = \
                    float(v()) if callable(v) else float(v)
            except Exception:       # a dead closure must not break scrape
                continue


class _HistSeries:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Log-bucketed histogram: bounded memory, percentiles from buckets.

    Bucket ``0`` holds values ``<= lo``; bucket ``i`` holds
    ``(lo·g^(i-1), lo·g^i]``; values beyond ``hi`` clamp into the last
    bucket (``count``/``sum``/``min``/``max`` stay exact).  Percentile
    estimates interpolate inside the nearest-rank bucket and are clamped
    to the observed ``[min, max]``, so the relative error is bounded by
    ``growth - 1`` (~19 % at the default quarter-octave buckets) and is
    usually far smaller.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-3,
                 hi: float = 1e6, growth: float = 2 ** 0.25):
        super().__init__(name, help)
        if not (hi > lo > 0.0) or growth <= 1.0:
            raise ValueError("need hi > lo > 0 and growth > 1")
        self.lo, self.hi, self.growth = float(lo), float(hi), float(growth)
        self._log_g = math.log(growth)
        self.n_buckets = int(math.ceil(
            math.log(hi / lo) / self._log_g)) + 1
        self._series: Dict[tuple, _HistSeries] = {}

    def bucket_edges(self) -> list:
        """Upper edge of each bucket (the last one is open-ended)."""
        return [self.lo * self.growth ** i for i in range(self.n_buckets)]

    def _bucket(self, value: float) -> int:
        if value <= self.lo:
            return 0
        b = int(math.ceil(math.log(value / self.lo) / self._log_g))
        return min(b, self.n_buckets - 1)

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        if math.isnan(value):
            return
        k = _label_key(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _HistSeries(self.n_buckets)
            s.counts[self._bucket(value)] += 1
            s.count += 1
            s.sum += value
            s.min = min(s.min, value)
            s.max = max(s.max, value)

    def count(self, **labels) -> int:
        s = self._series.get(_label_key(labels))
        return s.count if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(_label_key(labels))
        return s.sum if s else 0.0

    def percentile(self, q: float, **labels) -> float:
        """Nearest-rank percentile estimated from the bucket counts."""
        s = self._series.get(_label_key(labels))
        if s is None or s.count == 0:
            return math.nan
        target = max(1, math.ceil(q / 100.0 * s.count))
        cum = 0
        for b, c in enumerate(s.counts):
            cum += c
            if cum >= target:
                upper = self.lo * self.growth ** b
                lower = self.lo * self.growth ** (b - 1) if b > 0 else 0.0
                lower = max(lower, s.min)
                upper = max(min(upper, s.max), lower)
                frac = (target - (cum - c)) / c
                return lower + frac * (upper - lower)
        return s.max        # unreachable: cum == count >= target

    def scrape_into(self, out: dict) -> None:
        for k, s in sorted(self._series.items()):
            base = _flat_name(self.name, k)
            if "{" in base:
                name, _, labels = base.partition("{")
                fmt = lambda suf, n=name, l=labels: f"{n}{suf}{{{l}"
            else:
                fmt = lambda suf, n=base: f"{n}{suf}"
            out[fmt("_count")] = float(s.count)
            out[fmt("_sum")] = s.sum
            for q in (50, 95, 99):
                out[fmt(f"_p{q}")] = self.percentile(q, **dict(
                    (kk, vv) for kk, vv in k))

    def exposition_lines(self) -> Iterable[str]:
        yield from self.header_lines()
        edges = self.bucket_edges()
        for k, s in sorted(self._series.items()):
            labels = [(a, _escape(b)) for a, b in k]
            cum = 0
            last = max((i for i, c in enumerate(s.counts) if c),
                       default=-1)
            for i in range(last + 1):
                cum += s.counts[i]
                le = ",".join(f'{a}="{b}"' for a, b in
                              labels + [("le", f"{edges[i]:g}")])
                yield f"{self.name}_bucket{{{le}}} {cum}"
            le = ",".join(f'{a}="{b}"' for a, b in
                          labels + [("le", "+Inf")])
            yield f"{self.name}_bucket{{{le}}} {s.count}"
            suffix = ("{" + ",".join(f'{a}="{b}"' for a, b in labels) + "}"
                      if labels else "")
            yield f"{self.name}_sum{suffix} {s.sum:g}"
            yield f"{self.name}_count{suffix} {s.count}"


class MetricsRegistry:
    """Named instruments + keyed collector callbacks, one scrape surface."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._callbacks: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *, lo: float = 1e-3,
                  hi: float = 1e6, growth: float = 2 ** 0.25) -> Histogram:
        return self._get(Histogram, name, help, lo=lo, hi=hi, growth=growth)

    def register_callback(self, key: str,
                          fn: Callable[[], Optional[dict]]) -> None:
        """Install a scrape-time collector; re-registering ``key`` replaces
        the previous callback (component rebuilt → stale closure dropped)."""
        with self._lock:
            self._callbacks[key] = fn

    def unregister_callback(self, key: str) -> None:
        with self._lock:
            self._callbacks.pop(key, None)

    def scrape(self) -> dict:
        """One flat ``{series_name: value}`` dict across the whole stack."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
            callbacks = list(self._callbacks.items())
        for m in metrics:
            m.scrape_into(out)
        for _, fn in callbacks:
            try:
                vals = fn()
            except Exception:       # dead component must not break scrape
                continue
            if vals:
                out.update(vals)
        return out

    def exposition(self) -> str:
        """Prometheus text format (callbacks exposed as untyped gauges)."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
            callbacks = list(self._callbacks.items())
        seen = set()
        for m in metrics:
            lines.extend(m.exposition_lines())
            seen.add(m.name)
        for _, fn in callbacks:
            try:
                vals = fn() or {}
            except Exception:
                continue
            for k, v in sorted(vals.items()):
                base = k.partition("{")[0]
                if base not in seen:
                    seen.add(base)
                    lines.append(f"# TYPE {base} gauge")
                lines.append(f"{_requote(k)} {float(v):g}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry (components default to their owner's)."""
    return _DEFAULT
