"""Declarative SLOs with SRE-style multi-window burn-rate alerting.

An SLO here is a predicate over one time series — "service p99 stays
under 50 ms", "tier hit-rate stays above 0.7" — plus an *error budget*:
the fraction of samples allowed to violate it.  Alerting on the raw
predicate is useless (one slow tick pages you); alerting on budget
*burn rate* is the standard fix (Google SRE workbook ch. 5):

    burn(window) = violating_fraction(window) / budget

Burn 1.0 means the budget is being spent exactly at its sustainable
rate; burn 10 means ten times too fast.  A **multi-window** rule fires
only when burn exceeds the threshold in BOTH a long window (enough
evidence that it matters) and a short window (it is still happening
right now) — long-only alerts linger after recovery, short-only alerts
flap.  The alert resolves as soon as no window pair is burning.

:class:`SLOMonitor` evaluates objectives against a
:class:`~repro_torch.obs.timeseries.TimeSeries` and publishes state back into
the registry (``slo_burn_rate{slo=,window=}``, ``slo_alert_active{slo=}``,
``slo_alerts_total{slo=}``) so alerts are themselves scrapeable series.
``on_fire`` / ``on_resolve`` callbacks drive reactions — the bundle
capture hook (:mod:`repro_torch.obs.bundle`) raises trace sampling to 1.0 on
fire so the black box records the incident at full resolution.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["SLOObjective", "BurnWindow", "SLOMonitor", "Alert",
           "DEFAULT_WINDOWS", "default_slos"]


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One objective: ``metric <cmp> threshold`` for >= (1-budget) of samples."""
    name: str
    metric: str                 # scrape key, e.g. "engine_service_ms_p99"
    threshold: float
    comparison: str = "<="      # "<=" (latency-style) or ">=" (rate-style)
    budget: float = 0.1         # allowed violating fraction of samples
    description: str = ""

    def ok(self, value: float) -> bool:
        if math.isnan(value):
            return True         # missing data is not a violation
        if self.comparison == "<=":
            return value <= self.threshold
        if self.comparison == ">=":
            return value >= self.threshold
        raise ValueError(f"bad comparison {self.comparison!r}")


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """A (long, short) window pair and the burn both must exceed to fire."""
    long_s: float
    short_s: float
    max_burn: float


# The classic 1h/5m + 6h/30m pairs scaled down ~3600x: engine incidents
# play out over seconds, not hours, and tests shouldn't need to sleep.
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow(long_s=10.0, short_s=1.0, max_burn=10.0),
    BurnWindow(long_s=60.0, short_s=5.0, max_burn=4.0),
)


def default_slos(*, service_ms: float = 50.0, queue_wait_ms: float = 100.0,
                 hit_rate: float = 0.5, occupancy: float = 0.05,
                 prefix: str = "engine") -> Tuple[SLOObjective, ...]:
    """A sane objective set for any of the serving engines.

    ``prefix`` selects whose histograms to read: ``"engine"`` (wave and
    paged engines share the family) or ``"sharded_engine"``.
    """
    return (
        SLOObjective("service_p99", f"{prefix}_service_ms_p99", service_ms,
                     "<=", budget=0.1,
                     description="p99 on-engine service time"),
        SLOObjective("queue_wait_p99", f"{prefix}_queue_wait_ms_p99",
                     queue_wait_ms, "<=", budget=0.1,
                     description="p99 admission queue wait"),
        SLOObjective("tier_hit_rate", "tier_tick_hit_rate", hit_rate,
                     ">=", budget=0.2,
                     description="per-tick device block-cache hit rate"),
        SLOObjective("occupancy", f"{prefix}_occupancy_ratio", occupancy,
                     ">=", budget=0.5,
                     description="live-lane occupancy (0 = engine idle "
                                 "while queue backed up)"),
    )


@dataclasses.dataclass
class Alert:
    slo: str
    active: bool
    since: float
    burn: Dict[str, float]      # window label -> burn rate
    objective: SLOObjective
    fired_total: int = 0

    def to_doc(self) -> dict:
        d = dataclasses.asdict(self)
        d["objective"] = dataclasses.asdict(self.objective)
        return d


class SLOMonitor:
    """Evaluates objectives against a TimeSeries; publishes alert state."""

    def __init__(self, timeseries, objectives: Sequence[SLOObjective],
                 *, registry=None,
                 windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
                 min_samples: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.ts = timeseries
        self.objectives = tuple(objectives)
        self.registry = registry
        self.windows = tuple(windows)
        self.min_samples = int(min_samples)
        self.clock = clock
        self.on_fire: List[Callable[[Alert], None]] = []
        self.on_resolve: List[Callable[[Alert], None]] = []
        self._alerts: Dict[str, Alert] = {
            o.name: Alert(o.name, False, 0.0, {}, o) for o in self.objectives}
        if registry is not None:
            self._g_burn = registry.gauge(
                "slo_burn_rate", "error-budget burn rate per SLO window")
            self._g_active = registry.gauge(
                "slo_alert_active", "1 while the SLO alert is firing")
            self._c_fired = registry.counter(
                "slo_alerts_total", "SLO alert rising edges")

    # ------------------------------------------------------------ evaluation
    def _burn(self, obj: SLOObjective, window_s: float) -> float:
        """Violating fraction over the window, divided by the budget."""
        _, vs = self.ts.series(obj.metric, window_s)
        if len(vs) < self.min_samples:
            return math.nan
        bad = sum(0 if obj.ok(v) else 1 for v in vs)
        frac = bad / len(vs)
        return frac / obj.budget if obj.budget > 0 else math.inf * frac

    def evaluate(self, now: Optional[float] = None) -> List[Alert]:
        """Re-evaluate every objective; returns alerts that CHANGED state.

        Callbacks run synchronously for changed alerts (fire before
        resolve never interleaves per objective — each flips at most
        once per evaluation).
        """
        t = self.clock() if now is None else float(now)
        changed: List[Alert] = []
        for obj in self.objectives:
            alert = self._alerts[obj.name]
            burns: Dict[str, float] = {}
            firing = False
            for w in self.windows:
                bl = self._burn(obj, w.long_s)
                bs = self._burn(obj, w.short_s)
                burns[f"{w.long_s:g}s"] = bl
                burns[f"{w.short_s:g}s"] = bs
                if (not math.isnan(bl) and not math.isnan(bs)
                        and bl > w.max_burn and bs > w.max_burn):
                    firing = True
            alert.burn = burns
            if self.registry is not None:
                for label, b in burns.items():
                    if not math.isnan(b):
                        self._g_burn.set(b, slo=obj.name, window=label)
            if firing and not alert.active:
                alert.active = True
                alert.since = t
                alert.fired_total += 1
                if self.registry is not None:
                    self._c_fired.inc(slo=obj.name)
                changed.append(alert)
                for cb in self.on_fire:
                    cb(alert)
            elif not firing and alert.active:
                alert.active = False
                changed.append(alert)
                for cb in self.on_resolve:
                    cb(alert)
            if self.registry is not None:
                self._g_active.set(1.0 if alert.active else 0.0,
                                   slo=obj.name)
        return changed

    # --------------------------------------------------------------- queries
    def active(self) -> List[Alert]:
        return [a for a in self._alerts.values() if a.active]

    def alert(self, name: str) -> Alert:
        return self._alerts[name]

    def state(self) -> dict:
        """JSON-able monitor state (embedded in debug bundles)."""
        return {
            "objectives": [dataclasses.asdict(o) for o in self.objectives],
            "windows": [dataclasses.asdict(w) for w in self.windows],
            "alerts": {n: _nan_to_none(a.to_doc())
                       for n, a in self._alerts.items()},
        }


def _nan_to_none(x):
    if isinstance(x, dict):
        return {k: _nan_to_none(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_nan_to_none(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x
