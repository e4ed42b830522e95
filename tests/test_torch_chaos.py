"""Port of the chaos harness (``repro_torch.chaos``) against the JAX package.

* ``FaultPlan``'s draws — tier reads (io faults, latency, broken blocks,
  first-fetch failures), shard events and probes, pool denials — and its
  ``injected`` tallies equal the reference's for the same seeds, and so do
  the splitmix64 units and the block cache's backoff jitter.
* ``install_chaos`` reaches the block caches of a bare DQF and of an
  engine's DQF and the paged engine's page pool, across growth too;
  ``uninstall_chaos`` disarms them.
* The reference's tier tests and property tests (``tests/test_chaos.py``)
  on the port's DQF and engines, on the CPU: a fault retried to success
  is bit-identical to the fault-free search, faults past their retries
  degrade lanes and raise nothing, the scrape carries the tier fetch
  counters, pool denials are transient, no tick raises under random
  plans, and a zero-rate plan is a bitwise no-op.
"""

import numpy as np
import pytest
import torch

from repro.chaos import ChaosClock as JClock
from repro.chaos import FaultPlan as JPlan
from repro.chaos import faults as jfaults
from repro.tiering import cache as jcache
from repro_torch.chaos import ChaosClock, FaultPlan, faults, install_chaos, \
    uninstall_chaos
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import DQF, TierConfig
from repro_torch.serving.engine import WaveEngine
from repro_torch.serving.paged_engine import PagedWaveEngine
from repro_torch.serving.status import SHED_POLICIES, EngineConfig, \
    QueryStatus
from repro_torch.tiering import cache as tcache
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests._hypothesis_compat import given, settings, st
from tests.test_chaos import tier_world  # noqa: F401  (fixture)
from tests.test_torch_search import port_cfg, saved  # noqa: F401

STATUSES = {s.value for s in QueryStatus}



# ------------------------------------------------------------ the draws
def _tier_trace(plan, blocks=40, attempts=3):
    out = []
    for block in range(blocks):
        for _ in range(attempts):
            try:
                plan.tier_read(block)
                out.append((block, True, plan.clock.t if plan.clock else 0))
            except IOError as e:
                out.append((block, False, str(e)))
    return out


PLANS = [dict(tier_io_rate=0.5), dict(tier_latency_rate=0.4,
                                      tier_latency_s=0.125),
         dict(tier_fail_first_fetch=True, tier_io_rate=0.2),
         dict(tier_broken_blocks=frozenset([3, 17]), tier_io_rate=0.1,
              tier_latency_rate=0.3)]


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 - 1])
@pytest.mark.parametrize("kw", range(len(PLANS)))
def test_tier_draws_equal_reference(seed, kw):
    mine = FaultPlan(seed=seed, clock=ChaosClock(), **PLANS[kw])
    ref = JPlan(seed=seed, clock=JClock(), **PLANS[kw])
    assert _tier_trace(mine) == _tier_trace(ref)
    assert mine.injected == ref.injected
    assert mine.clock.slept == ref.clock.slept
    mine.reset()
    ref.reset()
    assert _tier_trace(mine) == _tier_trace(ref)


@pytest.mark.parametrize("seed", [0, 5, 123456789])
def test_shard_and_pool_draws_equal_reference(seed):
    kw = dict(seed=seed, shard_fail_rate=0.3, pool_deny_rate=0.4,
              shard_fail_ticks={1: frozenset([2, 5])},
              shard_stall_ticks={0: frozenset([1, 3]), 2: frozenset([4])})
    mine, ref = FaultPlan(**kw), JPlan(**kw)
    for shard in range(3):
        for tick in range(12):
            assert mine.shard_ok(shard, tick) == ref.shard_ok(shard, tick)
            assert mine.shard_event(shard, tick) == ref.shard_event(shard,
                                                                    tick)
    assert [mine.deny_alloc() for _ in range(64)] == \
        [ref.deny_alloc() for _ in range(64)]
    assert mine.injected == ref.injected
    assert mine.injected["pool_deny"] > 0


def test_units_and_backoff_jitter_equal_reference():
    rng = np.random.default_rng(0)
    for seed, kind, a, b in rng.integers(0, 2 ** 62, size=(50, 4)):
        args = (int(seed), int(kind), int(a), int(b))
        assert faults._unit(*args) == jfaults._unit(*args)
        assert tcache._backoff_unit(*args[2:]) == \
            jcache._backoff_unit(*args[2:])


def test_chaos_clock_sleep_is_virtual():
    clk = ChaosClock()
    plan = FaultPlan(seed=0, tier_latency_rate=1.0, tier_latency_s=0.25,
                     clock=clk)
    plan.tier_read(3)
    assert clk.slept == pytest.approx(0.25)
    assert clk() == clk.now() == pytest.approx(0.25)
    with pytest.raises(IOError):
        FaultPlan(seed=0, tier_broken_blocks=frozenset([7])).tier_read(7)


# ----------------------------------------------------------- tier failures
def _load_tiered(world, name, **tier_over):
    """tests/test_chaos.py::_load_tiered, in the port, on the CPU."""
    kw = dict(mode="host", dir=str(world["tmp"].mktemp(name)),
              block_rows=16, cache_frac=0.25, fetch_backoff_s=0.0)
    kw.update(tier_over)
    cfg = port_cfg(world["cfg"], tier=TierConfig(**kw))
    return DQF.load(world["path"], cfg, device="cpu")


def _same(a, b):
    return torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


def test_install_chaos_reaches_caches_pool_and_engine(tier_world):
    dqf = _load_tiered(tier_world, "install")
    plan = FaultPlan(seed=3)
    assert install_chaos(dqf, plan) is plan
    assert all(c.chaos is plan for c in dqf.store.tier_caches())
    eng = PagedWaveEngine(dqf, capacity=8, tick_hops=4)
    other = FaultPlan(seed=4)
    install_chaos(eng, other)
    assert eng.pagepool.chaos is other
    assert all(c.chaos is other for c in dqf.store.tier_caches())
    dqf.insert(np.zeros((1, dqf.store.d), np.float32))     # grows
    assert (dqf.store.n, dqf.store.capacity) == (901, 1024)
    assert all(c.chaos is other for c in dqf.store.tier_caches())
    uninstall_chaos(eng)
    assert eng.pagepool.chaos is None
    assert all(c.chaos is None for c in dqf.store.tier_caches())
    fixed = WaveEngine(dqf, wave_size=4)
    install_chaos(fixed, plan)
    assert all(c.chaos is plan for c in dqf.store.tier_caches())


def test_tier_fault_retried_to_success_is_bit_identical(tier_world):
    q = tier_world["wl"].sample(48)
    plain = _load_tiered(tier_world, "plain")
    faulty = _load_tiered(tier_world, "faulty")
    plan = FaultPlan(seed=5, tier_fail_first_fetch=True)
    install_chaos(faulty, plan)
    assert _same(plain.search(q, record=False),
                 faulty.search(q, record=False))
    assert plan.injected["tier_io"] > 0
    counters = faulty.store.full_phase_cache().counters
    assert counters["fetch_retries"] > 0
    assert counters["fetch_failures"] == 0


def test_tier_fault_past_retries_degrades_not_raises(tier_world):
    dqf = _load_tiered(tier_world, "broken", fetch_retries=1)
    plan = FaultPlan(seed=5, tier_io_rate=1.0)     # every attempt fails
    install_chaos(dqf, plan)
    eng = WaveEngine(dqf, wave_size=8, tick_hops=4)
    rids = eng.submit(tier_world["wl"].sample(24))
    out = eng.run_until_drained()                  # must not raise
    assert set(rids) <= set(out["results"])
    degraded = [r for r in rids if out["results"][r]["degraded"]]
    assert degraded, "injected always-fail tier reads must mark results"
    assert all(out["results"][r]["status"] == "degraded"
               for r in degraded)
    counters = dqf.store.full_phase_cache().counters
    assert counters["fetch_failures"] > 0
    assert eng.stats.degraded == len(degraded)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("case", ["io_rate_1_retry", "first_fetch_2"])
def test_tier_degraded_path_matches_reference_per_query(tier_world, case,
                                                        paged):
    """The tier's degraded path held per query against the reference:
    both packages' engines over the same tiered checkpoint and the same
    plan (every read failing with 1 retry, or each block's first fetch
    failing with 2): status, degraded flag, ids and hops equal, dists
    within rtol 1e-5, and the injected tallies equal.  Frontier prefetch
    is off in both: its worker thread finishes when it finishes, so which
    blocks a tick finds cached (and so which reads fail) would depend on
    timing."""
    from repro.chaos import install_chaos as j_install_chaos
    from repro.serving.engine import WaveEngine as JWave
    from repro.serving.paged_engine import PagedWaveEngine as JPaged
    from tests.test_chaos import _load_tiered as j_load_tiered

    kw, retries = ((dict(tier_io_rate=1.0), 1) if case == "io_rate_1_retry"
                   else (dict(tier_fail_first_fetch=True), 2))
    q = tier_world["wl"].sample(24)
    name = f"{case}{int(paged)}"
    jd = j_load_tiered(tier_world, "j" + name, fetch_retries=retries)
    pd = _load_tiered(tier_world, "p" + name, fetch_retries=retries)
    jplan, plan = JPlan(seed=5, **kw), FaultPlan(seed=5, **kw)
    j_install_chaos(jd, jplan)
    install_chaos(pd, plan)
    if paged:
        je = JPaged(jd, capacity=8, tick_hops=4, prefetch=False)
        pe = PagedWaveEngine(pd, capacity=8, tick_hops=4, prefetch=False)
    else:
        je = JWave(jd, wave_size=8, tick_hops=4, prefetch=False)
        pe = WaveEngine(pd, wave_size=8, tick_hops=4, prefetch=False)
    ra, oa = je.submit(q), je.run_until_drained()
    rb, ob = pe.submit(q), pe.run_until_drained()
    for i, (a, b) in enumerate(zip(ra, rb)):
        want, got = oa["results"][a], ob["results"][b]
        for key in ("status", "degraded", "hops"):
            assert got[key] == want[key], f"query {i} {key}"
        np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]),
                                      err_msg=f"query {i} ids")
        np.testing.assert_allclose(got["dists"], np.asarray(want["dists"]),
                                   rtol=1e-5, atol=0.0,
                                   err_msg=f"query {i} dists")
    assert plan.injected == jplan.injected and plan.injected["tier_io"] > 0
    assert pe.stats.degraded == je.stats.degraded
    assert pe.stats.ticks == je.stats.ticks
    if case == "io_rate_1_retry":
        assert pe.stats.degraded > 0


def test_tier_metrics_published(tier_world):
    dqf = _load_tiered(tier_world, "metrics")
    install_chaos(dqf, FaultPlan(seed=1, tier_fail_first_fetch=True))
    dqf.search(tier_world["wl"].sample(16), record=False)
    keys = " ".join(dqf.scrape())
    assert "tier_fetch_retries_total" in keys
    assert "tier_fetch_failures_total" in keys


# -------------------------------------------------------------- page pool
@pytest.fixture(scope="module")
def port_dqf(built_dqf, saved):  # noqa: F811
    dqf, wl = built_dqf
    return dqf_from_arrays(saved, port_cfg(dqf.cfg), device="cpu"), wl


def test_pool_denial_is_transient(port_dqf):
    dqf, wl = port_dqf
    eng = PagedWaveEngine(dqf, capacity=8, tick_hops=4)
    plan = FaultPlan(seed=9, pool_deny_rate=0.6)
    install_chaos(eng, plan)
    rids = eng.submit(wl.sample(24))
    out = eng.run_until_drained()
    assert set(rids) <= set(out["results"])
    assert all(out["results"][r]["status"] in STATUSES for r in rids)
    assert eng.stats.completed == 24
    assert plan.injected["pool_deny"] > 0


# ------------------------------------------------------ property (hypothesis)
@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=4, deadline=None)
def test_no_tick_raises_and_every_rid_terminates(port_dqf, seed):
    dqf, wl = port_dqf
    rng = np.random.default_rng(seed)
    clk = ChaosClock()
    eng = PagedWaveEngine(
        dqf, capacity=8, tick_hops=4, clock=clk,
        engine_cfg=EngineConfig(
            max_queue=int(rng.integers(2, 12)),
            shed_policy=SHED_POLICIES[seed % len(SHED_POLICIES)]))
    plan = FaultPlan(seed=seed,
                     pool_deny_rate=float(rng.uniform(0.0, 0.7)),
                     clock=clk)
    install_chaos(eng, plan)
    rids = []
    for batch in range(3):
        dl = float(rng.uniform(5.0, 50.0)) if batch % 2 else None
        rids += eng.submit(wl.sample(8), deadline_ms=dl)
        eng.step()
        clk.advance(float(rng.uniform(0.0, 0.05)))
    out = eng.run_until_drained(max_ticks=2000)
    assert set(rids) <= set(out["results"])
    for r in rids:
        assert out["results"][r]["status"] in STATUSES


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=3, deadline=None)
def test_zero_rate_plan_is_bitwise_noop(port_dqf, seed):
    dqf, wl = port_dqf
    q = wl.sample(16)
    ea = WaveEngine(dqf, wave_size=8, tick_hops=4)
    eb = WaveEngine(dqf, wave_size=8, tick_hops=4)
    install_chaos(eb, FaultPlan(seed=seed))
    ra, rb = ea.submit(q), eb.submit(q)
    oa, ob = ea.run_until_drained(), eb.run_until_drained()
    for i in range(q.shape[0]):
        a, b = oa["results"][ra[i]], ob["results"][rb[i]]
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["dists"], b["dists"])
        assert a["status"] == b["status"] == "ok"


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=3, deadline=None)
def test_tiered_retry_to_success_property(tier_world, seed):
    q = tier_world["wl"].sample(24)
    plain = _load_tiered(tier_world, f"p{seed % 977}")
    faulty = _load_tiered(tier_world, f"f{seed % 977}")
    plan = FaultPlan(seed=seed, tier_fail_first_fetch=True)
    install_chaos(faulty, plan)
    assert _same(plain.search(q, record=False),
                 faulty.search(q, record=False))
    assert faulty.store.full_phase_cache().counters["fetch_failures"] == 0


@pytest.mark.parametrize("cls", [WaveEngine, PagedWaveEngine])
def test_zero_rate_plan_on_tiered_engines_is_noop(tier_world, cls):
    q = tier_world["wl"].sample(16)
    width = "wave_size" if cls is WaveEngine else "capacity"
    out = []
    for name, plan in (("noop_a", None), ("noop_b", FaultPlan(seed=7))):
        dqf = _load_tiered(tier_world, f"{name}_{cls.__name__}")
        eng = cls(dqf, tick_hops=4, **{width: 8})
        install_chaos(eng, plan)
        rids = eng.submit(q)
        res = eng.run_until_drained()["results"]
        out.append([res[r] for r in rids])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["dists"], b["dists"])
        assert a["status"] == b["status"] == "ok"
