"""Result statuses, bounded admission, and SLO-coupled load shedding.

One enum covers every way a submitted query can terminate, across all
three engines (fixed wave, paged, sharded) — a result dict always
carries ``status`` (a plain string, the enum is a ``str`` subclass) and
the engines publish a labeled ``engine_terminal_status_total{status=…}``
counter from the same tallies, so dashboards and tests read one
vocabulary:

* ``ok`` — served normally;
* ``dropped`` — the tenant vanished (or was re-created) while the
  request sat in the queue;
* ``shed`` — bounded admission rejected it under load
  (:class:`EngineConfig`);
* ``deadline`` — the per-query deadline expired: a queued request
  terminates empty, an in-flight lane retires with its current best-k;
* ``degraded`` — served, but a tier fetch exhausted its retries and
  fell back to the sentinel (or a sharded query lost shard responses):
  the result is real but possibly imprecise, flagged ``degraded=True``.

:class:`EngineConfig` bounds the queue: ``max_queue`` caps the depth and
``shed_policy`` picks the victim when it is full.  Shedding is an
*explicit* terminal result, never silent queue growth: under overload an
unbounded queue turns into unbounded queue wait.

:class:`AdmissionController` closes the loop with the perf sentinel: a
firing SLO burn-rate alert (:mod:`repro_torch.obs.slo`) tightens the
effective ``max_queue`` by ``factor`` until the alert resolves, so
overload sheds harder exactly while the latency objective is burning.

A copy of ``repro/serving/status.py``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

__all__ = ["QueryStatus", "EngineConfig", "SHED_POLICIES", "shed_victim",
           "AdmissionController", "attach_admission_control"]


class QueryStatus(str, enum.Enum):
    """Terminal status of one submitted query (shared by all engines)."""

    OK = "ok"
    DROPPED = "dropped"
    SHED = "shed"
    DEADLINE = "deadline"
    DEGRADED = "degraded"


SHED_POLICIES = ("reject-newest", "shed-oldest", "tenant-fair")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Robustness knobs shared by the three serving engines.

    ``max_queue=None`` keeps the pre-chaos unbounded queue.  With a
    bound, an at-capacity ``submit`` sheds per ``shed_policy``:

    * ``reject-newest`` — the incoming request is shed (classic
      tail-drop: cheapest, protects queued work);
    * ``shed-oldest`` — the head of the queue is shed and the incoming
      request admitted (freshest-work-wins: queued requests have aged
      toward their deadlines anyway);
    * ``tenant-fair`` — the tenant with the most queued requests loses
      its newest one (an overloading tenant cannot starve the rest; the
      incoming request itself is shed when its own tenant is heaviest).

    ``default_deadline_ms`` applies to submits that pass no explicit
    ``deadline_ms``.  ``quarantine_after`` / ``recover_after`` drive the
    sharded engine's shard-health state machine (consecutive failed
    ticks before quarantine, consecutive clean probes before
    re-admission) and are ignored by the single-shard engines.
    """

    max_queue: Optional[int] = None
    shed_policy: str = "reject-newest"
    default_deadline_ms: Optional[float] = None
    quarantine_after: int = 3
    recover_after: int = 2

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, got "
                f"{self.shed_policy!r}")
        if self.default_deadline_ms is not None \
                and self.default_deadline_ms <= 0:
            raise ValueError("default_deadline_ms must be > 0 (or None)")
        if self.quarantine_after < 1 or self.recover_after < 1:
            raise ValueError(
                "quarantine_after and recover_after must be >= 1")


def shed_victim(queue, entry, policy: str):
    """Pick (and unqueue) the shed victim for an at-capacity queue.

    ``entry`` is the incoming queue tuple ``(rid, q, t_in, tenant, gen,
    deadline)``; the queue holds the same shape.  Returns the victim
    entry — possibly ``entry`` itself, in which case the queue is
    untouched; otherwise the victim has been removed and ``entry``
    appended.  Deterministic: ties in ``tenant-fair`` break toward the
    tenant whose newest request is youngest.
    """
    if policy == "reject-newest":
        return entry
    if policy == "shed-oldest":
        victim = queue.popleft()
        queue.append(entry)
        return victim
    if policy == "tenant-fair":
        counts: dict = {}
        last: dict = {}
        for i, e in enumerate(queue):
            counts[e[3]] = counts.get(e[3], 0) + 1
            last[e[3]] = i
        counts[entry[3]] = counts.get(entry[3], 0) + 1
        last[entry[3]] = len(queue)
        heavy = max(counts, key=lambda t: (counts[t], last[t]))
        if heavy == entry[3]:
            return entry            # the newcomer is its tenant's newest
        victim = queue[last[heavy]]
        del queue[last[heavy]]
        queue.append(entry)
        return victim
    raise ValueError(f"unknown shed policy {policy!r}")


class AdmissionController:
    """Couples firing SLO alerts to a tighter effective admission limit.

    While *any* alert on the monitor is firing, the engine's
    ``_shed_scale`` drops to ``factor`` — ``effective_max_queue()``
    shrinks proportionally, so load shedding bites earlier; when the
    last alert resolves the full limit is restored.  The shed decisions
    themselves stay consultable the other way round: the engines publish
    ``engine_shed_total`` / ``engine_admission_limit`` into the same
    registry the SLO monitor evaluates.
    """

    def __init__(self, engine, monitor, *, factor: float = 0.5):
        if not (0.0 < factor <= 1.0):
            raise ValueError("factor must be in (0, 1]")
        self.engine = engine
        self.monitor = monitor
        self.factor = float(factor)
        self._firing = 0
        monitor.on_fire.append(self._on_fire)
        monitor.on_resolve.append(self._on_resolve)

    def _apply(self) -> None:
        self.engine._shed_scale = self.factor if self._firing else 1.0

    def _on_fire(self, alert) -> None:
        self._firing += 1
        self._apply()

    def _on_resolve(self, alert) -> None:
        self._firing = max(0, self._firing - 1)
        self._apply()


def attach_admission_control(engine, monitor=None, *,
                             factor: float = 0.5) -> AdmissionController:
    """Wire an engine's admission limit to an SLO monitor's alerts.

    ``monitor=None`` uses the engine's own sentinel monitor
    (``ObsConfig(sentinel=True, slos=…)``); raises when neither exists.
    """
    if monitor is None:
        sent = getattr(engine, "sentinel", None)
        monitor = getattr(sent, "slo", None) if sent is not None else None
    if monitor is None:
        raise ValueError(
            "no SLO monitor: pass one explicitly or build the engine "
            "with ObsConfig(sentinel=True, slos=...)")
    return AdmissionController(engine, monitor, factor=factor)
