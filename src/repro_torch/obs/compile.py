"""JIT compile sentinel: recompile detection as a runtime invariant.

The reference's ``jax.jit`` recompiles whenever a call's *abstract
signature* changes: the pytree structure, the shape/dtype of every array
leaf, or the value of any non-array (implicitly static) argument.  The
port runs eagerly, but the engines keep the same discipline — fixed wave
shapes, pow2 bucket widths — because every new signature is a new set of
kernel shapes and allocator sizes, and a shape leak stays silent: results
stay correct at every call.

:class:`CompileSentinel` turns that bug class into something a metric,
a test, or an alert can see.  It wraps a jitted callable and computes
the same abstract signature a jit cache would key on (this module
stays stdlib-only like the rest of ``repro_torch.obs``; array leaves —
torch tensors, numpy arrays — are duck-typed on ``.shape``/``.dtype``).
A never-seen signature is counted as a compile and the wall-time of
that first call recorded as the compile cost (trace + lower + compile
dominate a cold call by orders of magnitude, so the approximation is
tight enough for alerting).  On top of the per-name signature sets it
provides:

* **storm detection** — more than ``storm_threshold`` compiles of one
  name inside ``storm_window_s`` flips an alerting gauge and bumps a
  rising-edge counter: the signature of shape churn (unpadded batch
  sizes, a static arg rebuilt per call);
* **schedule assertions** (:meth:`expect`) — the paged engine must
  compile exactly its pow2 bucket ladder, O(log capacity) executables;
  one more means a bucket leak.  Violations are a metric always, an
  exception when ``strict=True`` (tests).

Registry metrics (all labeled ``fn=<name>``): ``jit_calls_total``,
``jit_compiles_total``, ``jit_executables`` gauge, ``jit_compile_ms``
histogram, ``jit_recompile_storm`` gauge, ``jit_recompile_storms_total``,
``jit_schedule_violations_total``.
"""

from __future__ import annotations

import collections
import functools
import time
from typing import Any, Callable, Dict, Optional

__all__ = ["CompileSentinel", "abstract_signature"]

_REPR_TRUNC = 64


def _sig_leaf(x) -> tuple:
    """Abstract signature of one argument leaf.

    Array-likes (anything with ``shape`` and ``dtype`` — torch tensors,
    numpy arrays) reduce to ``("a", shape, dtype)``: the key a jit cache
    derives from them.  Containers recurse.  Everything else is
    implicitly static — its *value* is part of the key — so hashables key on the value itself and the rest fall back to
    a truncated repr.  The repr fallback can under-distinguish exotic
    unhashable statics, but for the engines' call sites (arrays, ints,
    floats, strings, NamedTuples of arrays) the signature is exact.
    """
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("a", tuple(shape), str(dtype))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_sig_leaf(v) for v in x))
    if isinstance(x, dict):
        return ("d", tuple(sorted((k, _sig_leaf(v)) for k, v in x.items())))
    try:
        hash(x)
        return ("s", type(x).__name__, x)
    except TypeError:
        return ("r", type(x).__name__, repr(x)[:_REPR_TRUNC])


def abstract_signature(args: tuple, kwargs: dict) -> tuple:
    """The signature a call would present to jit's cache."""
    return (_sig_leaf(list(args)), _sig_leaf(kwargs))


class _FnState:
    __slots__ = ("sigs", "calls", "recent", "storm", "expected",
                 "violations", "compile_ms")

    def __init__(self):
        self.sigs: Dict[tuple, dict] = {}       # sig -> {"ms":, "t":, "n":}
        self.calls = 0
        self.recent: collections.deque = collections.deque()  # compile times
        self.storm = False
        self.expected: Optional[int] = None
        self.violations = 0
        self.compile_ms = 0.0


class CompileSentinel:
    """Wraps jitted callables; counts compiles, flags storms/violations."""

    def __init__(self, registry=None, *, storm_threshold: int = 6,
                 storm_window_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 strict: bool = False):
        self.registry = registry
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self.clock = clock
        self.strict = strict
        self._fns: Dict[str, _FnState] = {}
        if registry is not None:
            self._c_calls = registry.counter(
                "jit_calls_total", "calls through sentinel-wrapped jit fns")
            self._c_compiles = registry.counter(
                "jit_compiles_total", "distinct abstract signatures compiled")
            self._g_exec = registry.gauge(
                "jit_executables", "live executable count per jit fn")
            self._h_ms = registry.histogram(
                "jit_compile_ms", "wall ms of signature-miss (compiling) calls")
            self._g_storm = registry.gauge(
                "jit_recompile_storm", "1 while a recompile storm is active")
            self._c_storms = registry.counter(
                "jit_recompile_storms_total", "recompile storm rising edges")
            self._c_viol = registry.counter(
                "jit_schedule_violations_total",
                "compiles beyond an expected executable budget")

    # ---------------------------------------------------------------- wiring
    def _state(self, name: str) -> _FnState:
        st = self._fns.get(name)
        if st is None:
            st = self._fns[name] = _FnState()
        return st

    def expect(self, name: str, max_executables: int) -> None:
        """Declare a compile-schedule budget for ``name``.

        Compiling an ``max_executables + 1``-th distinct signature is a
        schedule violation: metric always, ``RuntimeError`` if strict.
        Retroactive — an already-exceeded budget trips immediately.
        """
        st = self._state(name)
        st.expected = int(max_executables)
        if len(st.sigs) > st.expected:
            self._violate(name, st)

    def wrap(self, name: str, fn: Callable) -> Callable:
        """Return ``fn`` instrumented under ``name``.

        Overhead on the cache-hit path is one signature walk (tuples of
        small ints) and a couple of dict operations — nanoseconds next
        to a device dispatch.
        """
        st = self._state(name)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            sig = abstract_signature(args, kwargs)
            st.calls += 1
            hit = sig in st.sigs
            if self.registry is not None:
                self._c_calls.inc(fn=name)
            if hit:
                st.sigs[sig]["n"] += 1
                return fn(*args, **kwargs)
            t0 = self.clock()
            out = fn(*args, **kwargs)
            ms = (self.clock() - t0) * 1e3
            self._record_compile(name, st, sig, ms)
            return out

        wrapped.__sentinel_name__ = name
        return wrapped

    def record(self, name: str, sig: Any, ms: float = 0.0) -> bool:
        """Manually record a (possibly new) signature for ``name``.

        For call sites where wrapping is awkward (e.g. an engine that
        re-jits per bucket width keys its own cache); returns True if
        this was a new signature.
        """
        st = self._state(name)
        st.calls += 1
        if self.registry is not None:
            self._c_calls.inc(fn=name)
        key = _sig_leaf(sig)
        if key in st.sigs:
            st.sigs[key]["n"] += 1
            return False
        self._record_compile(name, st, key, ms)
        return True

    # --------------------------------------------------------------- innards
    def _record_compile(self, name: str, st: _FnState, sig, ms: float):
        now = self.clock()
        st.sigs[sig] = {"ms": ms, "t": now, "n": 1}
        st.compile_ms += ms
        st.recent.append(now)
        while st.recent and now - st.recent[0] > self.storm_window_s:
            st.recent.popleft()
        if self.registry is not None:
            self._c_compiles.inc(fn=name)
            self._g_exec.set(len(st.sigs), fn=name)
            self._h_ms.observe(ms)
        storming = len(st.recent) > self.storm_threshold
        if storming and not st.storm:
            if self.registry is not None:
                self._c_storms.inc(fn=name)
        if self.registry is not None:
            self._g_storm.set(1.0 if storming else 0.0, fn=name)
        st.storm = storming
        if st.expected is not None and len(st.sigs) > st.expected:
            self._violate(name, st)

    def _violate(self, name: str, st: _FnState):
        st.violations += 1
        if self.registry is not None:
            self._c_viol.inc(fn=name)
        if self.strict:
            raise RuntimeError(
                f"compile schedule violation: {name!r} compiled "
                f"{len(st.sigs)} executables, expected <= {st.expected}")

    # -------------------------------------------------------------- queries
    def compiles(self, name: str) -> int:
        return len(self._fns[name].sigs) if name in self._fns else 0

    def executables(self, name: str) -> int:
        return self.compiles(name)

    def calls(self, name: str) -> int:
        return self._fns[name].calls if name in self._fns else 0

    def storming(self, name: str) -> bool:
        return self._fns[name].storm if name in self._fns else False

    def signatures(self, name: str):
        """The distinct abstract signatures compiled under ``name``."""
        return list(self._fns[name].sigs) if name in self._fns else []

    def report(self) -> dict:
        """JSON-able per-fn compile telemetry (embedded in debug bundles)."""
        out = {}
        for name, st in self._fns.items():
            out[name] = {
                "calls": st.calls,
                "executables": len(st.sigs),
                "compile_ms_total": st.compile_ms,
                "storm": st.storm,
                "expected": st.expected,
                "violations": st.violations,
                "signatures": [
                    {"sig": repr(sig), "compile_ms": rec["ms"],
                     "calls": rec["n"]}
                    for sig, rec in st.sigs.items()],
            }
        return out
