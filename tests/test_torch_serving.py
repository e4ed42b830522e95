"""Port of the serving engines against the JAX package and against itself.

* Both port engines (``WaveEngine``, ``PagedWaveEngine``), composed and
  fused, against the JAX engines on one reference DQF carried across with
  ``convert.dqf_from_arrays``: per query ids and hops exactly equal, dists
  within rtol 1e-5 (the port sums squares in its own fixed order), equal
  tick counts; a diverging query is listed, never hidden.
* Within the port, the reference's own rules
  (``tests/test_paged_engine.py``) where they need no mutation or
  tiering: paged ≡ fixed bit for bit across none/sq8/pq and
  composed/fused, the mixed-tenant property, the straggler, the evicted
  tenant, the occupancy gauges, the page-pool invariants, the bucket
  schedule and the ``dense_seen`` round trip.
* Shed and deadline with an injected clock, the admission controller, the
  perf sentinel's bucket budget, traces and the debug bundle, and scrape
  keys equal to the JAX engines'.
"""

import collections
import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import DQF as JDQF
from repro.core import ZipfWorkload
from repro.serving.engine import WaveEngine as JWave
from repro.serving.paged_engine import PagedWaveEngine as JPaged
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import DQF, DQFConfig, QuantConfig
from repro_torch.obs import ObsConfig
from repro_torch.serving import paged as pg
from repro_torch.serving.engine import WaveEngine
from repro_torch.serving.paged_engine import PagedWaveEngine
from repro_torch.serving.status import (AdmissionController, EngineConfig,
                                        QueryStatus, shed_victim)
from tests.conftest import make_clustered
from tests.test_fused_hop import _fused_cfg as _jax_cfg
from tests.test_torch_search import port_cfg

ENGINES = {"fixed": (JWave, WaveEngine, "wave_size"),
           "paged": (JPaged, PagedWaveEngine, "capacity")}


@pytest.fixture(scope="module")
def world_x():
    return make_clustered(n=900, d=16, clusters=12, seed=31)


def _cfg(fused, **over):
    """tests/test_fused_hop.py::_fused_cfg, in the port."""
    base = dict(knn_k=10, out_degree=10, index_ratio=0.03, k=8,
                hot_pool=16, full_pool=32, max_hops=100, eval_gap=30,
                n_query_trigger=10 ** 6, fused=fused, fused_hops=4)
    base.update(over)
    return DQFConfig(**base)


def _built(cfg, x, seed=21):
    """tests/test_fused_hop.py::_built, in the port, on the CPU."""
    wl = ZipfWorkload(x, seed=seed)
    dqf = DQF(cfg, device="cpu").build(x)
    dqf.warm(wl.sample(600))
    dqf.fit_tree(wl.sample(256))
    return dqf


def diverging_queries(oa, ob, ra, rb, rtol=0.0):
    """Indices of queries whose ids, hops or dists differ (dists within
    ``rtol``; 0 = bit for bit)."""
    bad = []
    for i in range(len(ra)):
        a, b = oa["results"][ra[i]], ob["results"][rb[i]]
        same = (np.array_equal(a["ids"], b["ids"]) and a["hops"] == b["hops"]
                and (np.array_equal(a["dists"], b["dists"]) if rtol == 0
                     else np.allclose(a["dists"], b["dists"], rtol=rtol,
                                      atol=0)))
        if not same:
            bad.append(i)
    return bad


# ------------------------------------------------- against the JAX engines
@pytest.fixture(scope="module")
def jax_world(world_x, tmp_path_factory):
    """A reference DQF with a second tenant, and its saved arrays."""
    x = world_x
    wl = ZipfWorkload(x, seed=21)
    dqf = JDQF(_jax_cfg(False)).build(x)
    dqf.warm(wl.sample(600))
    q, tg = ZipfWorkload(x, seed=77).sample(600, with_targets=True)
    dqf.warm(q, tg, tenant="b")
    dqf.fit_tree(wl.sample(256))
    path = str(tmp_path_factory.mktemp("serving") / "dqf.npz")
    dqf.save(path)
    with np.load(path) as z:
        return dqf, {k: z[k] for k in z.files}, path


@pytest.mark.parametrize("kind", ["fixed", "paged"])
@pytest.mark.parametrize("fused", [False, True])
def test_engines_match_reference(world_x, jax_world, kind, fused):
    jdqf, arrays, _ = jax_world
    jdqf = copy.copy(jdqf)
    jdqf.cfg = dataclasses.replace(jdqf.cfg, fused=fused)
    port = dqf_from_arrays(arrays, port_cfg(jdqf.cfg), device="cpu")
    jcls, tcls, width = ENGINES[kind]
    extra = {"page_cols": 128} if kind == "paged" else {}
    ej = jcls(jdqf, **{width: 16}, tick_hops=6, prefetch=False, **extra)
    et = tcls(port, **{width: 16}, tick_hops=6, prefetch=False, **extra)
    assert et._fused is fused
    qa = ZipfWorkload(world_x, seed=6).sample(30)
    qb = ZipfWorkload(world_x, seed=78).sample(20)
    rj = ej.submit(qa) + ej.submit(qb, tenant="b")
    rt = et.submit(qa) + et.submit(qb, tenant="b")
    oj, ot = ej.run_until_drained(), et.run_until_drained()
    bad = diverging_queries(oj, ot, rj, rt, rtol=1e-5)
    assert bad == [], f"queries diverge from the reference: {bad}"
    assert et.stats.ticks == ej.stats.ticks
    assert [ot["results"][r]["tenant"] for r in rt] == \
        [oj["results"][r]["tenant"] for r in rj]


@pytest.mark.parametrize("kind", ["fixed", "paged"])
def test_scrape_keys_equal_reference(world_x, jax_world, kind):
    jdqf, arrays, path = jax_world
    q = ZipfWorkload(world_x, seed=9).sample(12)
    jcls, tcls, width = ENGINES[kind]
    ej = jcls(JDQF.load(path, jdqf.cfg), **{width: 8}, tick_hops=4,
              prefetch=False)
    et = tcls(dqf_from_arrays(arrays, port_cfg(jdqf.cfg), device="cpu"),
              **{width: 8}, tick_hops=4, prefetch=False)
    for _ in range(2):
        ej.submit(q)
        et.submit(q)
        ej.run_until_drained()
        et.run_until_drained()
        assert sorted(et.scrape()) == sorted(ej.scrape())


# ------------------------------------------------------ paged ≡ fixed, port
@pytest.mark.parametrize("quant_mode", ["none", "sq8", "pq"])
@pytest.mark.parametrize("fused", [False, True])
def test_paged_bitwise_equals_fixed_wave(world_x, quant_mode, fused):
    """Paged ≡ fixed per query, every table variant, composed and fused,
    with equal tick counts."""
    x = world_x
    qc = QuantConfig() if quant_mode == "none" else \
        QuantConfig(mode=quant_mode, pq_m=4, rerank_k=16)
    da = _built(_cfg(False, quant=qc), x)
    db = copy.copy(da)
    db.cfg = _cfg(fused, quant=qc)
    q = ZipfWorkload(x, seed=6).sample(40)
    ea = WaveEngine(da, wave_size=16, tick_hops=6, prefetch=False)
    eb = PagedWaveEngine(db, capacity=16, tick_hops=6, page_cols=128,
                         prefetch=False)
    assert eb._fused is fused
    ra, rb = ea.submit(q), eb.submit(q)
    oa, ob = ea.run_until_drained(), eb.run_until_drained()
    assert diverging_queries(oa, ob, ra, rb) == []
    assert ea.stats.ticks == eb.stats.ticks


def test_paged_parity_mixed_tenant_property(world_x):
    """A randomized mixed-tenant trace — interleaved submissions of three
    tenants across drain rounds — retires bit-identical results from both
    engines."""
    x = world_x
    tenants = [("t0", 101), ("t1", 202), ("t2", 303)]
    dqf = DQF(_cfg(False), device="cpu").build(x)
    for name, seed in tenants:
        q, tg = ZipfWorkload(x, seed=seed).sample(500, with_targets=True)
        dqf.warm(q, tg, tenant=name)
    dqf.fit_tree(ZipfWorkload(x, seed=7).sample(200), tenant="t0")
    db = copy.copy(dqf)
    db.cfg = _cfg(True)
    ea = WaveEngine(dqf, wave_size=8, tick_hops=5, prefetch=False)
    eb = PagedWaveEngine(db, capacity=8, tick_hops=5, page_cols=128,
                         prefetch=False)
    rng = np.random.default_rng(17)
    wls = {name: ZipfWorkload(x, seed=seed + 1) for name, seed in tenants}
    for _ in range(3):
        ra, rb = [], []
        for t in rng.permutation([name for name, _ in tenants]):
            q = wls[t].sample(int(rng.integers(3, 9)))
            ra += ea.submit(q, tenant=t)
            rb += eb.submit(q, tenant=t)
        oa, ob = ea.run_until_drained(), eb.run_until_drained()
        assert diverging_queries(oa, ob, ra, rb) == []


def test_open_loop_equals_closed_loop(world_x):
    """Queries admitted mid-stream (``step`` between bursts) retire with
    the closed-loop results, in both engines, with equal ticks."""
    x = world_x
    dqf = _built(_cfg(True), x)
    q = ZipfWorkload(x, seed=12).sample(48)
    closed = WaveEngine(dqf, wave_size=8, tick_hops=4, prefetch=False)
    rc = closed.submit(q)
    oc = closed.run_until_drained()
    outs = []
    for cls, width in ((WaveEngine, "wave_size"),
                       (PagedWaveEngine, "capacity")):
        eng = cls(dqf, **{width: 8}, tick_hops=4, prefetch=False)
        rids = []
        for burst in range(4):
            rids += eng.submit(q[burst * 12:(burst + 1) * 12])
            for _ in range(3):
                eng.step()
        out = eng.run_until_drained()
        assert diverging_queries(oc, out, rc, rids) == []
        outs.append(eng.stats.ticks)
    assert outs[0] == outs[1]


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
