"""Host-side span timeline → Chrome trace-event JSON (Perfetto-loadable).

``Timeline.span("tick.jit")`` wraps a region and records a complete
("X"-phase) trace event with microsecond timestamps; ``export()`` writes
the ``{"traceEvents": [...]}`` document that chrome://tracing and
https://ui.perfetto.dev open directly.  A disabled timeline returns a
shared no-op context manager, so instrumented code costs one method call
per span on the untraced path.

``device_annotation(name)`` is the bridge to device profiles: it returns a
``torch.profiler.record_function`` range, which shows up in a
``torch.profiler`` capture on the host lane above the kernels the region
launched, lining the engine tick up with these host spans.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

__all__ = ["Timeline", "device_annotation"]


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tl", "_name", "_args", "_t0")

    def __init__(self, tl: "Timeline", name: str, args: dict):
        self._tl = tl
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        ev = {"name": self._name, "ph": "X", "cat": "host",
              "ts": self._t0 * 1e6, "dur": (t1 - self._t0) * 1e6,
              "pid": self._tl.pid,
              "tid": threading.get_ident() & 0x7FFFFFFF}
        if self._args:
            ev["args"] = self._args
        self._tl._events.append(ev)
        return False


class Timeline:
    """Bounded span recorder emitting Chrome trace-event JSON."""

    def __init__(self, enabled: bool = True, capacity: int = 65536):
        self.enabled = bool(enabled)
        self.pid = os.getpid()
        self._events: collections.deque = collections.deque(
            maxlen=max(16, int(capacity)))

    def span(self, name: str, **args):
        """Context manager timing a region (no-op when disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "cat": "host",
              "ts": time.perf_counter() * 1e6, "pid": self.pid,
              "tid": threading.get_ident() & 0x7FFFFFFF}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def events(self) -> list:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def export(self, path: Optional[str] = None):
        """The Chrome trace document; written to ``path`` when given."""
        doc = {"traceEvents": list(self._events),
               "displayTimeUnit": "ms"}
        if path is None:
            return doc
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def device_annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` (wrap
    the host code that launches a tick's kernels)."""
    import torch.profiler
    return torch.profiler.record_function(name)
