"""Shard health tracking: consecutive-failure quarantine + probed re-admission.

The sharded engine's tick treats a shard's response as one of three
things: healthy, *stalled* (its result missed this tick's merge — a late
response, not a death signal), or *failed* (counts toward quarantine).
:class:`ShardHealth` turns those per-tick observations into two boolean
masks the engine's tick consumes
(a copy of ``repro/sharding/health.py``, numpy only):

* ``live[s]`` — the shard advances its lanes this tick (quarantined
  shards are frozen so their in-flight state stops burning hops);
* ``merge[s]`` — the shard's candidates enter this tick's cross-shard
  top-k merge.  A dropped shard is routed around with the same
  renormalization contract as
  :func:`repro_torch.serving.sharded.merge_with_dropout` (results over
  the responding shards only).

A shard that fails ``quarantine_after`` consecutive ticks is quarantined;
while quarantined it is probed each tick (the engine consults the fault
plan's :meth:`~repro_torch.chaos.faults.FaultPlan.shard_ok` view, or a
caller probe), and ``recover_after`` consecutive clean probes re-admit it.  The
state machine is pure host bookkeeping — with every shard healthy the
masks are all-True and the tick's maskings are bit-identical no-ops.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

__all__ = ["ShardHealth"]


class ShardHealth:
    """Per-shard consecutive-failure / recovery-probe state machine."""

    def __init__(self, num_shards: int, *, quarantine_after: int = 3,
                 recover_after: int = 2, registry=None):
        if quarantine_after < 1 or recover_after < 1:
            raise ValueError(
                "quarantine_after and recover_after must be >= 1")
        self.num_shards = int(num_shards)
        self.quarantine_after = int(quarantine_after)
        self.recover_after = int(recover_after)
        self._consec_fail = np.zeros(self.num_shards, np.int64)
        self._consec_ok = np.zeros(self.num_shards, np.int64)
        self.quarantined = np.zeros(self.num_shards, bool)
        self.quarantines = 0        # lifetime quarantine transitions
        self.readmissions = 0       # lifetime recoveries
        self.registry = registry
        if registry is not None:
            registry.register_callback("shard_health", self._collect_metrics)

    # ------------------------------------------------------------ observation
    def observe(self, events: Mapping[int, str]) -> tuple:
        """Fold one tick's shard events into the masks.

        ``events`` maps shard → ``"fail"`` or ``"stall"``; absent shards
        responded cleanly.  Returns ``(live, merge)`` bool arrays of
        shape ``(num_shards,)``: quarantined shards are excluded from
        both, a failing/stalling shard only from this tick's merge.
        """
        live = ~self.quarantined
        merge = live.copy()
        for s in range(self.num_shards):
            if self.quarantined[s]:
                continue
            ev = events.get(s)
            if ev == "fail":
                merge[s] = False
                self._consec_fail[s] += 1
                if self._consec_fail[s] >= self.quarantine_after:
                    self.quarantined[s] = True
                    self._consec_fail[s] = 0
                    self._consec_ok[s] = 0
                    self.quarantines += 1
                    live[s] = False
                    merge[s] = False
            elif ev == "stall":
                merge[s] = False    # late, not dead: no quarantine credit
            else:
                self._consec_fail[s] = 0
        return live, merge

    def probe(self, shard: int, ok: bool) -> bool:
        """Record one background probe of a quarantined shard.

        Returns True when this probe completed the recovery streak and
        the shard was re-admitted.
        """
        s = int(shard)
        if not self.quarantined[s]:
            return False
        if not ok:
            self._consec_ok[s] = 0
            return False
        self._consec_ok[s] += 1
        if self._consec_ok[s] >= self.recover_after:
            self.quarantined[s] = False
            self._consec_ok[s] = 0
            self._consec_fail[s] = 0
            self.readmissions += 1
            return True
        return False

    # ------------------------------------------------------------------ views
    def responding(self, merge: Optional[np.ndarray] = None) -> int:
        """Shards contributing to a merge (defaults to non-quarantined)."""
        if merge is not None:
            return int(np.asarray(merge).sum())
        return int((~self.quarantined).sum())

    def _collect_metrics(self) -> dict:
        out = {"shard_quarantine_total": float(self.quarantines),
               "shard_readmit_total": float(self.readmissions),
               "shard_quarantined_count": float(self.quarantined.sum())}
        for s in np.flatnonzero(self.quarantined):
            out[f"shard_quarantined{{shard={int(s)}}}"] = 1.0
        return out
