"""Black-box debug bundles + alert-triggered capture.

When an SLO alert fires at 3am, the question is never "what is the p99
now" — it is "what was the engine doing for the last thirty seconds".
:func:`debug_bundle` freezes everything the obs stack knows into one
directory artifact:

* ``scrape.json`` — the flat registry scrape at capture time
* ``exposition.prom`` — the same, Prometheus text format
* ``traces.json`` — the last-N sampled per-query traces
* ``timeline.json`` — the tick timeline (Chrome trace events; open in
  Perfetto)
* ``timeseries.json`` — the sentinel's buffered time-series window
* ``compile.json`` — per-fn JIT compile telemetry (signatures, storms)
* ``slo.json`` — objectives, burn rates, alert states
* ``config.json`` — engine knobs + DQF config + ObsConfig
* ``meta.json`` — reason, timestamp, git sha, torch and CUDA versions,
  GPU name
* ``MANIFEST.json`` — what was written (and what was absent)

Every section is best-effort and duck-typed over the three engines
(``WaveEngine`` / ``PagedWaveEngine`` / ``ShardedEngine``) or a bare
``DQF``: a component the target doesn't have is recorded as absent in
the manifest, never an exception — a debug tool that throws while the
system is on fire is worse than no tool.

:class:`CaptureHook` is the flight-recorder trigger: wired as an
``SLOMonitor.on_fire`` callback, it raises the engine's trace sampling
to 1.0 for a window of ticks (so the black box records the incident at
full resolution, not at the steady-state sample rate), then writes the
bundle and restores the previous rate.  The bundle is written at the
*end* of the window on purpose — that is when the captured traces exist.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional

__all__ = ["debug_bundle", "CaptureHook"]


def _jsonable(x, depth: int = 0):
    """Best-effort conversion to JSON-clean values (repr as last resort)."""
    if depth > 6:
        return repr(x)
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, (list, tuple)):
        return [_jsonable(v, depth + 1) for v in x]
    if isinstance(x, dict):
        return {str(k): _jsonable(v, depth + 1) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _jsonable(getattr(x, f.name), depth + 1)
                for f in dataclasses.fields(x)}
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        return _jsonable(x.item(), depth + 1)    # numpy scalar
    if hasattr(x, "tolist") and getattr(x, "ndim", None) is not None:
        return repr(x)      # arrays: shape matters, contents rarely do
    return repr(x)


def _provenance(reason: str) -> dict:
    meta = {"reason": reason,
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "pid": os.getpid()}
    try:
        import subprocess
        meta["git_sha"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except Exception:
        meta["git_sha"] = None
    import torch
    meta["torch_version"] = torch.__version__
    meta["cuda_version"] = torch.version.cuda
    meta["gpu"] = (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else None)
    return meta


def _engine_config(engine) -> dict:
    """Scalar engine knobs + DQF config + ObsConfig, duck-typed."""
    doc: dict = {"type": type(engine).__name__}
    knobs = {}
    for k, v in vars(engine).items():
        if k.startswith("_"):
            continue
        if isinstance(v, (bool, int, float, str)) or v is None:
            knobs[k] = v
    doc["engine"] = knobs
    cfg = getattr(engine, "cfg", None)
    if cfg is not None:
        doc["dqf_config"] = _jsonable(cfg)
    obs = getattr(engine, "obs", None)
    if obs is not None:
        od = _jsonable(obs)
        if isinstance(od, dict):
            od.pop("registry", None)    # live object, repr is noise
        doc["obs_config"] = od
    return doc


def debug_bundle(engine, out_dir: str, *, reason: str = "",
                 extra: Optional[dict] = None) -> str:
    """Dump everything the obs stack knows about ``engine`` to ``out_dir``.

    Works on any of the serving engines or a bare DQF; returns the
    bundle directory path.  Each section is independent — a missing or
    broken component shows up in ``MANIFEST.json`` as absent, and never
    prevents the other sections from landing.
    """
    os.makedirs(out_dir, exist_ok=True)
    written, absent = [], []

    def emit(name: str, build, dump=None):
        try:
            payload = build()
        except Exception as e:
            absent.append({"file": name, "error": repr(e)})
            return
        if payload is None:
            absent.append({"file": name, "error": None})
            return
        path = os.path.join(out_dir, name)
        try:
            if dump is not None:
                dump(payload, path)
            else:
                with open(path, "w") as f:
                    json.dump(payload, f, indent=1, allow_nan=False)
            written.append(name)
        except Exception as e:
            absent.append({"file": name, "error": repr(e)})

    registry = getattr(engine, "registry", None)
    sentinel = getattr(engine, "sentinel", None)
    traces = getattr(engine, "traces", None)
    timeline = getattr(engine, "timeline", None)

    emit("meta.json", lambda: _provenance(reason))
    emit("config.json", lambda: _engine_config(engine))
    if registry is not None:
        emit("scrape.json", lambda: _jsonable(registry.scrape()))
        emit("exposition.prom", lambda: registry.exposition(),
             dump=lambda text, path: open(path, "w").write(text + "\n"))
    else:
        absent.append({"file": "scrape.json", "error": "no registry"})
    if traces is not None:
        emit("traces.json",
             lambda: {"total": traces.total, "dropped": traces.dropped,
                      "traces": _jsonable(traces.snapshot())})
    if timeline is not None and getattr(timeline, "enabled", False):
        emit("timeline.json", lambda: timeline.export())
    if sentinel is not None:
        ts = getattr(sentinel, "timeseries", None)
        if ts is not None:
            emit("timeseries.json", ts.to_doc)
        cs = getattr(sentinel, "compile", None)
        if cs is not None:
            emit("compile.json", cs.report)
        slo = getattr(sentinel, "slo", None)
        if slo is not None:
            emit("slo.json", slo.state)
    if extra:
        emit("extra.json", lambda: _jsonable(extra))

    manifest = {"reason": reason, "written": sorted(written),
                "absent": absent, "target": type(engine).__name__}
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class CaptureHook:
    """Alert-triggered full-rate trace capture + bundle dump.

    Wire :meth:`on_alert` as an ``SLOMonitor.on_fire`` callback and call
    :meth:`on_tick` once per engine tick (``PerfSentinel.on_tick`` does
    both).  On fire: the engine's live ``_trace_rate`` jumps to 1.0, so
    every request retiring during the next ``capture_ticks`` ticks is
    traced.  When the window closes, the bundle — now holding the
    full-rate traces — is written to a fresh ``capture-<n>-<slo>``
    subdirectory and the previous rate is restored.  A second alert
    during an open window extends nothing and restores once (no nested
    captures, no rate leaks).
    """

    def __init__(self, engine, *, capture_ticks: int = 50,
                 bundle_dir: Optional[str] = None):
        self.engine = engine
        self.capture_ticks = int(capture_ticks)
        self.bundle_dir = bundle_dir
        self._remaining = 0
        self._saved_rate: Optional[float] = None
        self._pending_reason = ""
        self._captures = 0
        self.last_bundle: Optional[str] = None

    @property
    def capturing(self) -> bool:
        return self._remaining > 0

    def on_alert(self, alert) -> None:
        if self._remaining > 0:
            return                      # capture already open
        self._saved_rate = getattr(self.engine, "_trace_rate", None)
        if self._saved_rate is not None:
            self.engine._trace_rate = 1.0
        self._pending_reason = f"slo_alert:{getattr(alert, 'slo', alert)}"
        self._remaining = self.capture_ticks

    def on_tick(self) -> None:
        if self._remaining <= 0:
            return
        self._remaining -= 1
        if self._remaining > 0:
            return
        # window closed: bundle first (it must include the captured
        # traces), then restore the steady-state sampling rate
        try:
            if self.bundle_dir is not None:
                slug = self._pending_reason.rsplit(":", 1)[-1]
                out = os.path.join(self.bundle_dir,
                                   f"capture-{self._captures}-{slug}")
                self.last_bundle = debug_bundle(
                    self.engine, out, reason=self._pending_reason)
                self._captures += 1
        finally:
            if self._saved_rate is not None:
                self.engine._trace_rate = self._saved_rate
                self._saved_rate = None
