"""The port's serving behaviours, split from ``tests/test_torch_serving.py``
along its sections.

* The reference's own rules (``tests/test_paged_engine.py``) on the port:
  the straggler, the evicted tenant, the cold tenant, the occupancy
  gauges, the page-pool invariants, the bucket schedule, the
  ``dense_seen`` round trip and admission writes.
* Shed and deadline with an injected clock, the admission controller, the
  perf sentinel's bucket budget, traces and the debug bundle.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

from repro.core import ZipfWorkload
from repro_torch.obs import ObsConfig
from repro_torch.serving import paged as pg
from repro_torch.serving.engine import WaveEngine
from repro_torch.serving.paged_engine import PagedWaveEngine
from repro_torch.serving.status import (AdmissionController, EngineConfig,
                                        QueryStatus, shed_victim)
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_serving import _built, _cfg, world_x  # noqa: F401


# ------------------------------------------------------- serving behaviours
def test_straggler_force_retires_at_max_hops(world_x):
    x = world_x
    dqf = _built(_cfg(False, max_hops=12, eval_gap=10 ** 6), x)
    eng = PagedWaveEngine(dqf, capacity=8, tick_hops=5, page_cols=128,
                          prefetch=False)
    rids = eng.submit(ZipfWorkload(x, seed=13).sample(24))
    out = eng.run_until_drained()
    assert len(out["results"]) == 24
    assert eng.stats.straggled >= 1
    for r in rids:
        assert out["results"][r]["hops"] <= 12
    assert eng.pagepool.live_count == 0
    assert eng.pagepool.free_lane_count == eng.capacity


@pytest.mark.parametrize("cls,width", [(WaveEngine, "wave_size"),
                                       (PagedWaveEngine, "capacity")])
def test_evicted_tenant_drops_under_continuous_admission(world_x, cls,
                                                         width):
    x = world_x
    dqf = _built(_cfg(False), x)
    wl = ZipfWorkload(x, seed=23)
    q, tg = wl.sample(400, with_targets=True)
    dqf.warm(q, tg, tenant="doomed")
    eng = cls(dqf, **{width: 4}, tick_hops=6, prefetch=False)
    live_rids = eng.submit(wl.sample(8))
    dead_rids = eng.submit(wl.sample(8), tenant="doomed")
    dqf.evict_tenant("doomed")
    dqf.create_tenant("doomed")
    q2, tg2 = ZipfWorkload(x, seed=29).sample(400, with_targets=True)
    dqf.warm(q2, tg2, tenant="doomed")
    fed_before = dqf.tenants.get("doomed").counter.since_rebuild
    out = eng.run_until_drained()
    assert len(out["results"]) == 16
    for r in dead_rids:
        assert out["results"][r]["status"] == "dropped"
    for r in live_rids:
        assert out["results"][r]["status"] == "ok"
    assert eng.stats.dropped == 8
    assert dqf.tenants.get("doomed").counter.since_rebuild == fed_before


def test_engine_rejects_unknown_or_cold_tenant(world_x):
    dqf = _built(_cfg(False), world_x)
    eng = WaveEngine(dqf, wave_size=8)
    q = ZipfWorkload(world_x, seed=3).sample(2)
    with pytest.raises(KeyError):
        eng.submit(q, tenant="nobody")
    dqf.create_tenant("cold")
    with pytest.raises(RuntimeError, match="no hot index"):
        eng.submit(q, tenant="cold")
    with pytest.raises(ValueError, match="queries must be"):
        eng.submit(q[:, :5])


def test_occupancy_gauges_track_live_lanes(world_x):
    x = world_x
    dqf = _built(_cfg(False), x)
    eng = PagedWaveEngine(dqf, capacity=8, tick_hops=4, page_cols=128,
                          prefetch=False, obs=ObsConfig())
    eng.submit(ZipfWorkload(x, seed=41).sample(20))
    eng.step()
    mid = eng.scrape()
    assert mid["engine_live_lanes"] == float(eng.pagepool.live_count) > 0
    assert 0.0 < mid["engine_occupancy_ratio"] <= 1.0
    assert mid["engine_queue_depth"] == float(len(eng.queue))
    assert mid["engine_lane_capacity"] == 8.0
    assert mid["page_pool_pages_in_use{pool=paged}"] == float(
        eng.pagepool.live_count * eng.pagepool.pages_per_lane)
    out = eng.run_until_drained()
    assert len(out["results"]) == 20
    done = eng.scrape()
    assert done["engine_live_lanes"] == 0.0
    assert done["engine_occupancy_ratio"] == 0.0
    assert done["engine_queue_depth"] == 0.0


def test_fixed_engine_occupancy_gauges(world_x):
    dqf = _built(_cfg(True), world_x)
    eng = WaveEngine(dqf, wave_size=16, tick_hops=8, obs=ObsConfig())
    eng.submit(ZipfWorkload(world_x, seed=4).sample(32))
    eng.step()
    mid = eng.scrape()
    assert mid["engine_live_lanes"] > 0
    assert 0.0 < mid["engine_occupancy_ratio"] <= 1.0
    assert mid["engine_queue_depth"] == float(len(eng.queue))
    eng.run_until_drained()
    assert eng.scrape()["engine_occupancy_ratio"] == 0.0


def test_sentinel_budget_traces_and_bundle(world_x, tmp_path):
    """The paged tick stays inside its pow2 bucket budget, every retired
    sampled query has a trace whose top id is its result's, and the
    debug bundle's sections are JSON with the torch provenance."""
    dqf = _built(_cfg(True), world_x)
    obs = ObsConfig(trace_rate=1.0, sentinel=True, sentinel_interval_s=0.0,
                    timeline=True)
    eng = PagedWaveEngine(dqf, capacity=16, tick_hops=4, page_cols=128,
                          prefetch=False, obs=obs)
    rids = eng.submit(ZipfWorkload(world_x, seed=5).sample(40))
    out = eng.run_until_drained()
    assert eng.sentinel.compile.executables("paged_tick") <= eng._n_widths
    traces = {t["rid"]: t for t in eng.traces}
    assert set(traces) == set(rids)
    for r in rids:
        assert traces[r]["top_id"] == int(out["results"][r]["ids"][0])
    assert eng.export_timeline()["traceEvents"]
    path = eng.debug_bundle(str(tmp_path / "bundle"), reason="test")
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["torch_version"] == torch.__version__
    for name in os.listdir(path):
        if name.endswith(".json"):
            json.load(open(os.path.join(path, name)))


# ------------------------------------------------- deadlines, shed, control
class _Clock:
    """A virtual clock the engines read (seconds)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("cls,width", [(WaveEngine, "wave_size"),
                                       (PagedWaveEngine, "capacity")])
def test_deadline_retires_in_flight_with_best_k(world_x, cls, width):
    dqf = _built(_cfg(True), world_x)
    clk = _Clock()
    eng = cls(dqf, **{width: 8}, tick_hops=1, clock=clk)
    rids = eng.submit(ZipfWorkload(world_x, seed=8).sample(8),
                      deadline_ms=50.0)
    eng.step()                       # seed + 1 hop: nobody finishes yet
    live = [r for r in rids if r not in eng._results]
    assert live
    clk.t += 1.0                     # blow every deadline
    eng.step()
    for r in live:
        res = eng._results[r]
        assert res["status"] == "deadline"
        assert res["ids"].shape == (dqf.cfg.k,)
        assert (res["ids"] < dqf.store.n).any()   # its best-k so far
    assert eng.stats.deadline_hit >= len(live)
    assert not eng._any_live()


def test_deadline_expires_queued_requests_empty(world_x):
    dqf = _built(_cfg(False), world_x)
    clk = _Clock()
    eng = PagedWaveEngine(dqf, capacity=4, tick_hops=2, clock=clk)
    rids = eng.submit(ZipfWorkload(world_x, seed=8).sample(12),
                      deadline_ms=10.0)
    clk.t += 1.0
    out = eng.run_until_drained()
    for r in rids:
        assert out["results"][r]["status"] == "deadline"
        assert (out["results"][r]["ids"] == dqf.store.capacity).all()
    assert eng.stats.completed == 0


@pytest.mark.parametrize("policy,served", [("reject-newest", [0, 1, 2, 3]),
                                           ("shed-oldest",
                                            [8, 9, 10, 11])])
def test_bounded_queue_sheds_with_explicit_status(world_x, policy, served):
    dqf = _built(_cfg(False), world_x)
    eng = WaveEngine(dqf, wave_size=4, tick_hops=4,
                     engine_cfg=EngineConfig(max_queue=4,
                                             shed_policy=policy))
    rids = eng.submit(ZipfWorkload(world_x, seed=2).sample(12))
    assert eng.stats.shed == 8
    out = eng.run_until_drained()
    assert set(rids) <= set(out["results"])     # every rid terminates
    ok = [r for r in rids if out["results"][r]["status"] == "ok"]
    assert ok == [rids[i] for i in served]
    assert eng.stats.terminal == {"shed": 8, "ok": 4}


def test_shed_victim_tenant_fair():
    entry = lambda rid, tenant: (rid, None, 0.0, tenant, 0, None)
    q = collections.deque([entry(0, "a"), entry(1, "a"), entry(2, "a"),
                           entry(3, "b")])
    assert shed_victim(q, entry(4, "b"), "tenant-fair")[0] == 2
    assert [e[0] for e in q] == [0, 1, 3, 4]
    assert shed_victim(q, entry(5, "a"), "tenant-fair")[0] == 5


def test_admission_controller_tightens_while_alert_fires(world_x):
    dqf = _built(_cfg(False), world_x)
    eng = PagedWaveEngine(dqf, capacity=4,
                          engine_cfg=EngineConfig(max_queue=10))

    class Monitor:
        on_fire, on_resolve = [], []

    ctl = AdmissionController(eng, Monitor, factor=0.5)
    assert eng.effective_max_queue() == 10
    Monitor.on_fire[0]("alert")
    assert eng.effective_max_queue() == 5
    Monitor.on_resolve[0]("alert")
    assert eng.effective_max_queue() == 10
    assert ctl.factor == 0.5
    assert QueryStatus("deadline") is QueryStatus.DEADLINE


# ---------------------------------------------------------------- allocator
def test_page_pool_invariants_under_random_trace():
    """Free lists + page table stay consistent through a random
    alloc/free trace: live lanes exactly partition the allocated pages,
    freed lanes point back at scratch, cu-lens is the exclusive prefix."""
    rng = np.random.default_rng(5)
    P, n = 16, 1000
    pool = pg.PagePool(P, n, page_cols=128)
    ppl = pool.pages_per_lane
    assert pool.n_pages == (P + 1) * ppl
    held = []

    def check():
        live = pool.live_lanes()
        assert pool.live_count + pool.free_lane_count == P
        assert set(live.tolist()).isdisjoint(pool._free_lanes)
        owned = [p for lane in live for p in pool.page_table[lane]]
        assert len(owned) == len(set(owned))            # no double owner
        assert set(owned).isdisjoint(pool._free_pages)
        assert set(owned).isdisjoint(pool._scratch_pages.tolist())
        assert len(owned) + len(pool._free_pages) == P * ppl
        for lane in pool._free_lanes:
            np.testing.assert_array_equal(pool.page_table[lane],
                                          pool._scratch_pages)
        np.testing.assert_array_equal(pool.cu_lens(),
                                      np.arange(len(live) + 1) * ppl)

    for _ in range(60):
        if pool.free_lane_count and (not held or rng.random() < 0.55):
            m = int(rng.integers(1, pool.free_lane_count + 1))
            held.extend(int(v) for v in pool.alloc(m))
        else:
            kill = [held.pop(int(rng.integers(len(held))))
                    for _ in range(int(rng.integers(1, len(held) + 1)))]
            pool.free(kill)
        check()
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(pool.free_lane_count + 1)


def test_live_bucket_pads_with_scratch_lane():
    pool = pg.PagePool(16, 500, page_cols=128)
    pool.alloc(5)
    lanes, pt, n_live = pool.live_bucket(4)
    assert n_live == 5
    assert lanes.shape[0] == 8                      # next power of two
    assert (lanes[5:] == pool.capacity).all()
    np.testing.assert_array_equal(pt[5:],
                                  np.tile(pool._scratch_pages, (3, 1)))
    pool.free(lanes[:5])
    lanes, _, n_live = pool.live_bucket(4)
    assert n_live == 0 and lanes.shape[0] == 4
    assert (lanes == pool.capacity).all()


def test_bucket_width_schedule():
    assert pg.bucket_width(0, 64) == pg.MIN_BUCKET
    assert pg.bucket_width(8, 64) == 8
    assert pg.bucket_width(9, 64) == 16
    assert pg.bucket_width(33, 64) == 64
    assert pg.bucket_width(3, 64, lo=4) == 4
    with pytest.raises(ValueError, match="power of two"):
        pg.PagePool(4, 100, page_cols=100)


def test_dense_seen_roundtrip_through_recycled_pages():
    """Dense rows → pages → dense survives a shuffled physical layout."""
    rng = np.random.default_rng(9)
    P, n, pc = 8, 700, 128
    pool = pg.PagePool(P, n, page_cols=pc)
    pool.free(pool.alloc(5))                    # scramble the free lists
    pool.free(pool.alloc(3))
    lanes = pool.alloc(4)
    ppl = pool.pages_per_lane
    dense = torch.as_tensor(rng.random((4, n + 1)) < 0.3)
    pt = torch.as_tensor(pool.page_table[lanes])
    pages = torch.nn.functional.pad(dense, (0, ppl * pc - (n + 1)))
    arr = torch.zeros((pool.n_pages, pc), dtype=torch.bool)
    arr[pt.long()] = pages.reshape(4, ppl, pc)
    assert torch.equal(pg.dense_seen(arr, pt, n + 1), dense)


def test_admit_wave_writes_only_real_lanes():
    """Padding entries of an admission bucket write nothing: the scratch
    lane's pages and row keep their bytes."""
    from repro_torch.core import beam_search as bs
    from tests.test_torch_cuda import make_world

    x_pad, adj_pad, _ = (torch.as_tensor(a) for a in make_world())
    n1 = adj_pad.shape[0]
    pool = pg.PagePool(6, n1 - 1, page_cols=64)
    ps = pg.zero_paged_state(6, 16, 18, pool.n_pages, 64, n1 - 1)
    ps.seen_pages[pool._scratch_pages] = True
    lanes = pool.alloc(3)
    lanes_pad = np.full(4, pool.capacity, np.int32)
    lanes_pad[:3] = lanes
    q = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (4, 18)).astype(np.float32))
    seeded = bs.init_state(x_pad, q, torch.arange(0, 200, 40), 16)
    mask = torch.tensor([True, True, True, False])
    pg.admit_wave(ps, torch.as_tensor(lanes_pad),
                  torch.as_tensor(pool.page_table[lanes_pad]), seeded, q,
                  q[:, 0], q[:, 1], mask, page_cols=64)
    assert bool(ps.seen_pages[pool._scratch_pages].all())
    assert not bool(ps.active[-1]) and bool(ps.active[lanes].all())
    assert torch.equal(pg.dense_seen(ps.seen_pages, torch.as_tensor(
        pool.page_table[lanes]), n1), seeded.seen[:3])
