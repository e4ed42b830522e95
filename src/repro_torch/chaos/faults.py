"""FaultPlan / ChaosClock: seed-driven fault schedules (see package doc);
a copy of ``repro/chaos/faults.py``, plain Python.

Determinism contract: every probabilistic fault decision is a pure
function of ``(plan.seed, fault kind, key...)`` through splitmix64 —
the same plan replayed over the same request stream injects the same
faults at the same points.  The only mutable state a plan carries is
*counting* (per-block fetch counts, the allocation sequence number,
injected-fault tallies), and :meth:`FaultPlan.reset` rewinds it so one
plan object can drive repeated replays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, FrozenSet, Mapping, Optional

__all__ = ["ChaosClock", "FaultPlan", "install_chaos", "uninstall_chaos"]

_MASK64 = (1 << 64) - 1

# fault-kind salts: distinct streams per decision site so e.g. the io and
# latency decisions for the same (block, fetch) are independent draws
_K_TIER_IO = 0x1ED5
_K_TIER_LAT = 0x2A7E
_K_SHARD = 0x3B91
_K_POOL = 0x4C03


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK64


def _unit(seed: int, kind: int, a: int, b: int) -> float:
    """Deterministic uniform in [0, 1) for one fault decision."""
    h = _splitmix64(_splitmix64(_splitmix64(seed & _MASK64) ^ kind)
                    ^ ((a & _MASK64) * 0x9E3779B97F4A7C15 + b) & _MASK64)
    return (h >> 11) * (1.0 / (1 << 53))


class ChaosClock:
    """Virtual monotonic clock: deterministic time for deadline tests.

    Engines accept any zero-arg ``clock`` callable returning seconds; a
    ``ChaosClock`` instance *is* one (``clock()`` == ``clock.now()``).
    Injected latency and fetch backoff advance it via :meth:`sleep`
    instead of stalling the process, and tests drive deadline expiry
    with explicit :meth:`advance` calls — no wall-clock flakiness.
    """

    def __init__(self, start: float = 0.0):
        self.t = float(start)
        self.slept = 0.0            # total injected-latency seconds

    def __call__(self) -> float:
        return self.t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def sleep(self, dt: float) -> None:
        dt = float(dt)
        self.t += dt
        self.slept += dt


@dataclasses.dataclass
class FaultPlan:
    """Declarative, seeded fault schedule + its replay counters.

    Rate-based faults draw deterministically per key — a tier read is
    keyed on ``(block, fetch_count)``, so a *retry* of the same block is
    a fresh draw and usually succeeds (the retry-to-success path), while
    ``tier_broken_blocks`` fail every attempt (the sentinel-fallback
    path).  ``tier_fail_first_fetch`` deterministically fails exactly the
    first read attempt of every block: the strongest "every fault is
    retried to success" property-test schedule.

    Shard schedules are explicit tick sets per shard: a ``fail`` tick
    counts toward quarantine, a ``stall`` tick only drops that shard
    from the tick's merge (late response, not a death signal).
    """

    seed: int = 0
    # --- tier reads (BlockCache.host_fetch), keyed (block, fetch_count)
    tier_io_rate: float = 0.0           # P(IOError) per read attempt
    tier_latency_rate: float = 0.0      # P(latency spike) per read attempt
    tier_latency_s: float = 0.005       # injected spike duration
    tier_broken_blocks: FrozenSet[int] = frozenset()  # always-fail blocks
    tier_fail_first_fetch: bool = False  # first attempt per block fails
    # --- shard stall/fail schedules (ShardedEngine), keyed (shard, tick)
    shard_fail_ticks: Mapping[int, frozenset] = dataclasses.field(
        default_factory=dict)
    shard_stall_ticks: Mapping[int, frozenset] = dataclasses.field(
        default_factory=dict)
    shard_fail_rate: float = 0.0        # additional per-(shard,tick) draw
    # --- page-pool allocation denials (PagePool.alloc), keyed alloc seq
    pool_deny_rate: float = 0.0
    # --- virtual time (None → real time.sleep for injected latency)
    clock: Optional[ChaosClock] = None

    def __post_init__(self):
        self.reset()

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Rewind the replay counters (fetch counts, alloc seq, tallies)."""
        self._fetch_counts: Dict[int, int] = {}
        self._alloc_seq = 0
        self.injected: Dict[str, int] = dict(
            tier_io=0, tier_latency=0, shard_fail=0, shard_stall=0,
            pool_deny=0)

    def sleep(self, dt: float) -> None:
        """Injected/backoff sleep: virtual when a ChaosClock is attached."""
        if dt <= 0:
            return
        if self.clock is not None:
            self.clock.sleep(dt)
        else:
            time.sleep(dt)

    # ------------------------------------------------------------ tier reads
    def tier_read(self, block: int) -> None:
        """Consulted before each per-block mmap read attempt.

        Raises ``IOError`` to inject a read fault; may sleep to inject a
        latency spike.  Advances the block's fetch count either way, so
        a caller's retry is a *different* keyed decision.
        """
        block = int(block)
        c = self._fetch_counts.get(block, 0)
        self._fetch_counts[block] = c + 1
        if block in self.tier_broken_blocks:
            self.injected["tier_io"] += 1
            raise IOError(f"chaos: injected tier read fault block={block} "
                          f"fetch={c} (broken block)")
        if self.tier_fail_first_fetch and c == 0:
            self.injected["tier_io"] += 1
            raise IOError(f"chaos: injected tier read fault block={block} "
                          f"fetch={c} (first fetch)")
        if self.tier_io_rate > 0.0 and \
                _unit(self.seed, _K_TIER_IO, block, c) < self.tier_io_rate:
            self.injected["tier_io"] += 1
            raise IOError(f"chaos: injected tier read fault block={block} "
                          f"fetch={c}")
        if self.tier_latency_rate > 0.0 and \
                _unit(self.seed, _K_TIER_LAT, block, c) \
                < self.tier_latency_rate:
            self.injected["tier_latency"] += 1
            self.sleep(self.tier_latency_s)

    # ---------------------------------------------------------------- shards
    def shard_event(self, shard: int, tick: int) -> Optional[str]:
        """``"fail"`` / ``"stall"`` / None for one shard at one tick."""
        shard, tick = int(shard), int(tick)
        if tick in self.shard_fail_ticks.get(shard, ()):
            self.injected["shard_fail"] += 1
            return "fail"
        if self.shard_fail_rate > 0.0 and \
                _unit(self.seed, _K_SHARD, shard, tick) \
                < self.shard_fail_rate:
            self.injected["shard_fail"] += 1
            return "fail"
        if tick in self.shard_stall_ticks.get(shard, ()):
            self.injected["shard_stall"] += 1
            return "stall"
        return None

    def shard_ok(self, shard: int, tick: int) -> bool:
        """Probe view of the same schedule (no tallies: probes are reads)."""
        shard, tick = int(shard), int(tick)
        if tick in self.shard_fail_ticks.get(shard, ()):
            return False
        if self.shard_fail_rate > 0.0 and \
                _unit(self.seed, _K_SHARD, shard, tick) \
                < self.shard_fail_rate:
            return False
        return True

    # ------------------------------------------------------------- page pool
    def deny_alloc(self) -> bool:
        """One draw per PagePool.alloc call (keyed on the call sequence)."""
        i = self._alloc_seq
        self._alloc_seq += 1
        if self.pool_deny_rate > 0.0 and \
                _unit(self.seed, _K_POOL, i, 0) < self.pool_deny_rate:
            self.injected["pool_deny"] += 1
            return True
        return False


def _stores_of(target) -> list:
    """Every VectorStore reachable from an engine / ShardedDQF / DQF."""
    sharded = getattr(target, "sharded", None)
    if sharded is None and hasattr(target, "shards"):
        sharded = target                      # a bare ShardedDQF
    if sharded is not None:
        return [sh.dqf.store for sh in sharded.shards]
    dqf = getattr(target, "dqf", None) or target
    store = getattr(dqf, "store", None)
    return [store] if store is not None else []


def install_chaos(target, plan: Optional[FaultPlan]):
    """Arm every fault point reachable from ``target`` with ``plan``.

    ``target`` is an engine (WaveEngine / PagedWaveEngine /
    ShardedEngine), a ShardedDQF, or a bare DQF.  Hooks armed: every
    tier block cache, the page pool (paged engines), and the engine's
    shard-event consult (sharded engine).  Passing ``plan=None`` is
    equivalent to :func:`uninstall_chaos`.  When the plan carries a
    :class:`ChaosClock` and the engine exposes a clock slot, the
    engine's deadline clock is left untouched — pass ``clock=`` at
    engine construction to share it.
    """
    if hasattr(target, "chaos"):
        target.chaos = plan
    for store in _stores_of(target):
        if getattr(store, "tiered", False):
            for cache in store.tier_caches():
                cache.chaos = plan
    pool = getattr(target, "pagepool", None)
    if pool is not None:
        pool.chaos = plan
    return plan


def uninstall_chaos(target) -> None:
    """Disarm every hook :func:`install_chaos` reached (healthy wiring)."""
    install_chaos(target, None)
