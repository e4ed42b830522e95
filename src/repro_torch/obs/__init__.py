"""repro_torch.obs — the flight recorder + perf sentinel (a copy of the
reference's ``obs`` package; stdlib only, plus ``torch`` where noted).

Recording layers, all zero-dependency:

* :mod:`repro_torch.obs.metrics` — typed counters/gauges + log-bucketed
  histograms on a :class:`MetricsRegistry`; one ``scrape()`` shows the
  engine, the block caches, the store and every tenant at once.
* :mod:`repro_torch.obs.tracing` — deterministic per-request sampling
  (:func:`sample_decision`) and the bounded :class:`TraceLog` the wave
  engine fills with per-query phase breakdowns at retirement.
* :mod:`repro_torch.obs.timeline` — host span instrumentation emitting Chrome
  trace-event JSON (Perfetto), plus the ``torch.profiler`` bridge for
  lining device profiles up with host ticks.

Watching layers (the sentinel — nothing above looks at its own output
over time; these do):

* :mod:`repro_torch.obs.timeseries` — bounded ring buffer of scrape snapshots
  with windowed counter rates (qps, tick rate) and JSON export.
* :mod:`repro_torch.obs.compile` — JIT recompile detection: per-fn abstract
  signature tracking, compile wall-time, recompile-storm alerting, and
  compile-schedule budgets (the paged engine's O(log capacity) ladder).
* :mod:`repro_torch.obs.slo` — declarative objectives evaluated against the
  time series with multi-window burn-rate alerting.
* :mod:`repro_torch.obs.bundle` — black-box :func:`debug_bundle` artifacts and
  the alert-triggered full-rate trace :class:`CaptureHook`.

:class:`PerfSentinel` composes the watching layers behind one object the
engines drive with a single ``on_tick()`` call; :class:`ObsConfig` is
still the single knob consumers take — ``sentinel=True`` switches the
whole watching stack on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .timeline import Timeline, device_annotation
from .tracing import TraceLog, sample_decision
from .timeseries import TimeSeries
from .compile import CompileSentinel, abstract_signature
from .slo import (Alert, BurnWindow, DEFAULT_WINDOWS, SLOMonitor,
                  SLOObjective, default_slos)
from .bundle import CaptureHook, debug_bundle

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "Timeline", "device_annotation", "TraceLog",
           "sample_decision", "ObsConfig", "TimeSeries", "CompileSentinel",
           "abstract_signature", "SLOObjective", "BurnWindow", "SLOMonitor",
           "Alert", "DEFAULT_WINDOWS", "default_slos", "debug_bundle",
           "CaptureHook", "PerfSentinel"]


@dataclasses.dataclass
class ObsConfig:
    """Observability knobs for one consumer (engine / benchmark).

    ``registry=None`` means "use the owning component's registry" (the
    engine falls back to ``dqf.registry``); pass
    :func:`default_registry()` to publish process-globally instead.

    ``sentinel=True`` additionally builds a :class:`PerfSentinel` on the
    engine: scrape time series on a cadence, JIT compile telemetry on
    the jitted entry points, optional SLO burn-rate alerting (``slos``)
    and alert-triggered full-rate trace capture (``capture_dir``).
    """

    enabled: bool = True            # False → bare pre-obs hot path
    registry: Optional[MetricsRegistry] = None
    trace_rate: float = 0.0         # fraction of requests traced
    trace_seed: int = 0             # sampling is pure in (seed, rid)
    trace_capacity: int = 1024      # bounded TraceLog
    timeline: bool = False          # per-tick Chrome-trace spans
    timeline_capacity: int = 65536
    # --- perf sentinel ---
    sentinel: bool = False          # time series + compile + SLO watching
    sentinel_interval_s: float = 0.25   # scrape-snapshot cadence
    sentinel_capacity: int = 512        # time-series ring size
    slos: Tuple[SLOObjective, ...] = ()     # empty → no SLO monitor
    slo_windows: Tuple[BurnWindow, ...] = ()    # empty → DEFAULT_WINDOWS
    capture_ticks: int = 50         # full-rate trace window on alert
    capture_dir: Optional[str] = None   # where triggered bundles land
    storm_threshold: int = 6        # compiles-in-window before storm
    storm_window_s: float = 10.0


class PerfSentinel:
    """The watching stack behind one object: time series + compile + SLO.

    Engines construct one when ``ObsConfig.sentinel`` is set, wrap their
    jitted entry points through :meth:`wrap`, and call :meth:`on_tick`
    once per tick.  ``on_tick`` is cadence-gated: most ticks cost one
    clock read; on a sampling tick it scrapes the registry, re-evaluates
    the SLOs, and advances any open capture window.
    """

    def __init__(self, registry, *, interval_s: float = 0.25,
                 capacity: int = 512,
                 slos: Tuple[SLOObjective, ...] = (),
                 slo_windows: Tuple[BurnWindow, ...] = (),
                 storm_threshold: int = 6, storm_window_s: float = 10.0,
                 clock=time.monotonic):
        self.registry = registry
        self.timeseries = TimeSeries(registry, capacity=capacity,
                                     interval_s=interval_s, clock=clock)
        self.compile = CompileSentinel(registry,
                                       storm_threshold=storm_threshold,
                                       storm_window_s=storm_window_s,
                                       clock=clock)
        self.slo: Optional[SLOMonitor] = None
        if slos:
            self.slo = SLOMonitor(self.timeseries, slos, registry=registry,
                                  windows=slo_windows or DEFAULT_WINDOWS,
                                  clock=clock)
        self.capture: Optional[CaptureHook] = None

    @classmethod
    def from_config(cls, obs: "ObsConfig", registry) -> "PerfSentinel":
        return cls(registry,
                   interval_s=obs.sentinel_interval_s,
                   capacity=obs.sentinel_capacity,
                   slos=tuple(obs.slos),
                   slo_windows=tuple(obs.slo_windows),
                   storm_threshold=obs.storm_threshold,
                   storm_window_s=obs.storm_window_s)

    # ---------------------------------------------------------------- wiring
    def wrap(self, name: str, fn):
        """Instrument a jitted callable under ``name`` (compile sentinel)."""
        return self.compile.wrap(name, fn)

    def expect(self, name: str, max_executables: int) -> None:
        self.compile.expect(name, max_executables)

    def attach_capture(self, engine, *, capture_ticks: int = 50,
                       bundle_dir: Optional[str] = None) -> CaptureHook:
        """Wire alert-triggered full-rate capture for ``engine``.

        Inert without an SLO monitor (nothing ever fires); with one, the
        hook rides ``on_fire``.
        """
        hook = CaptureHook(engine, capture_ticks=capture_ticks,
                           bundle_dir=bundle_dir)
        if self.slo is not None:
            self.slo.on_fire.append(hook.on_alert)
        self.capture = hook
        return hook

    def on_tick(self) -> None:
        """Once per engine tick: sample, evaluate, advance capture."""
        if self.timeseries.maybe_sample() and self.slo is not None:
            self.slo.evaluate()
        if self.capture is not None:
            self.capture.on_tick()

    # --------------------------------------------------------------- queries
    def report(self) -> dict:
        """JSON-able sentinel summary (compile + SLO + series stats)."""
        doc = {"samples": len(self.timeseries),
               "span_s": self.timeseries.span_s(),
               "compile": self.compile.report()}
        if self.slo is not None:
            doc["slo"] = self.slo.state()
        return doc
