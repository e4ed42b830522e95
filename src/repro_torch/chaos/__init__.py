"""repro_torch.chaos — deterministic fault injection for the serving stack.

A port of ``repro/chaos`` (plain Python, copied).  A :class:`FaultPlan`
is a declarative, seeded schedule of faults — tier read IOErrors and
latency spikes keyed on ``(block, fetch_count)``, per-shard stall/fail
tick schedules, page-pool allocation denials — that the serving stack
consults at its real fault points:

* :meth:`repro_torch.tiering.cache.BlockCache.host_fetch` (the host read
  every tiered gather's misses go through, between launches),
* :meth:`repro_torch.serving.paged.PagePool.alloc` (lane admission),
* :meth:`repro_torch.sharding.engine.ShardedEngine._shard_masks` (each
  tick's ``FaultPlan.shard_event``/``shard_ok``, folded into the engine's
  :class:`~repro_torch.sharding.health.ShardHealth`).

Every hook is ``None`` by default and checked with one ``is not None``
branch — chaos off is the exact healthy code path.  :func:`install_chaos`
walks an engine (or a bare DQF) and arms every reachable hook;
:func:`uninstall_chaos` restores the healthy wiring.

Faults are pure functions of ``(seed, fault-kind, key)`` via splitmix64,
so a failing trace replays exactly, and the draws for a seed equal the
reference's bit for bit.  :class:`ChaosClock` is the companion virtual
clock: engines take a ``clock=`` callable for their deadline bookkeeping,
and a plan with a ``ChaosClock`` attached turns injected latency (and
backoff sleeps) into deterministic clock advances instead of real
``time.sleep`` stalls.
"""

from .faults import (ChaosClock, FaultPlan, install_chaos,
                     uninstall_chaos)

__all__ = ["ChaosClock", "FaultPlan", "install_chaos", "uninstall_chaos"]
