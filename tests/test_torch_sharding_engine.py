"""Port of the sharded engine (``repro_torch.sharding.ShardedEngine``)
against the JAX package.

One reference ``ShardedDQF`` a shard count (S = 2 and 3, n = 600) is built
for the module: warmed, a second tenant "a" warmed, the tree fitted, and
saved shard by shard.  Each test loads a fresh reference twin and a fresh
port twin (on the CPU) from that state, runs the reference's
``ShardedEngine`` and the port's with the same submissions and tick
schedule, and holds every query's ids, hops, status and
``shards_responding`` equal and its dists within rtol 1e-5 (any divergent
query named), ``stats.ticks`` equal, and the traces and the counters fed
equal: fixed composed, fixed fused and paged, two tenants, traces at rate
1, churn with auto-compaction, and a quarantined shard under the same
``FaultPlan``.  In the port alone: paged ≡ fixed bit for bit, the
occupancy and page-pool counters, the refusal of quantized shards, the
shard cases of ``tests/test_chaos.py:280-347``, an engine ≡ the stacked
search without the tree (graph and mxu), capacity growth mid-flight and
the in-flight compaction refusal.
"""

import dataclasses

import numpy as np
import pytest

from repro.chaos import FaultPlan as JPlan
from repro.chaos import install_chaos as j_install_chaos
from repro.core.decision_tree import train_tree as j_train_tree
from repro.core.dqf import DQF as JDQF
from repro.core.types import DQFConfig as JConfig
from repro.obs import ObsConfig as JObs
from repro.sharding import ShardConfig as JShardConfig
from repro.sharding import ShardedDQF as JShardedDQF
from repro.sharding import ShardedEngine as JShardedEngine
from repro.sharding.sharded import _Shard as _JShard
from repro_torch.chaos import FaultPlan, install_chaos
from repro_torch.convert import sharded_from_arrays
from repro_torch.core import QuantConfig
from repro_torch.core.recall import ground_truth, recall_at_k
from repro_torch.obs import ObsConfig
from repro_torch.serving.status import EngineConfig
from repro_torch.sharding import ShardConfig, ShardedDQF, ShardedEngine
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_search import MAX_DIVERGENT, port_cfg
from tests.test_torch_sharding import CFG, _data, _shard_arrays

TRACE_KEYS = ("rid", "tenant", "seed_tick", "shards", "full_hops",
              "shard_hops", "straggled", "ticks_in_flight", "top_id")



@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One reference ShardedDQF at S = 2 and 3 (n = 600), warmed, tenant
    "a" warmed, saved; ``get(S) -> world``.  The S = 3 one carries a
    termination tree (the reference's ``train_tree`` on seeded features
    whose label stops a lane past 120 distance evaluations: the tick's
    tree check then ends most lanes early); the S = 2 one runs without
    it, every lane to exhaustion."""
    x, q = _data()
    cache = {}

    def get(S):
        if S not in cache:
            jsd = JShardedDQF(JConfig(**CFG),
                              JShardConfig(num_shards=S)).build(x)
            jsd.warm(q[:8])
            jsd.warm(q[:8], tenant="a")
            if S == 3:
                jsd.tree = _tree(jsd.cfg.tree_depth)
                for sh in jsd.shards:
                    sh.dqf.tree = jsd.tree
            tmp = tmp_path_factory.mktemp(f"engine{S}")
            paths = []
            for s, sh in enumerate(jsd.shards):
                paths.append(str(tmp / f"shard{s}.npz"))
                sh.dqf.save(paths[-1])
            cache[S] = dict(x=x, q=q, cfg=jsd.cfg, paths=paths,
                            arrays=_shard_arrays(jsd, tmp), tree=jsd.tree,
                            owner=dict(jsd._owner), next_ext=jsd._next_ext)
        return cache[S]

    return get


def _tree(depth):
    """A reference tree trained on seeded features (hot first, hot ratio,
    first, first / kth, dist_count, update_count) labelled "go on" below
    120 distance evaluations."""
    rng = np.random.default_rng(0)
    n = 4000
    feats = np.column_stack([
        rng.uniform(0, 30, n), rng.uniform(0, 1, n), rng.uniform(0, 30, n),
        rng.uniform(0, 1, n), rng.uniform(0, 400, n),
        rng.uniform(0, 100, n)]).astype(np.float32)
    return j_train_tree(feats, (feats[:, 4] < 120).astype(np.int32),
                        max_depth=depth)


def _port(world, **over):
    """A fresh port twin (CPU) of the world's saved state."""
    S = len(world["paths"])
    saved_tree = {k: v for k, v in world["arrays"][0].items()
                  if k.startswith("tree_")} or None
    return sharded_from_arrays(world["arrays"], dict(world["owner"]),
                               saved_tree, port_cfg(world["cfg"], **over),
                               ShardConfig(num_shards=S), device="cpu")


def _twins(world, **over):
    """A fresh reference twin and a fresh port twin of the world."""
    S = len(world["paths"])
    cfg = dataclasses.replace(world["cfg"], **over)
    jsd = JShardedDQF(cfg, JShardConfig(num_shards=S))
    jsd.shards = [_JShard(index=s, dqf=JDQF.load(p, cfg))
                  for s, p in enumerate(world["paths"])]
    jsd._owner = dict(world["owner"])
    jsd._next_ext = world["next_ext"]
    jsd._mesh = jsd._make_mesh()
    jsd.tree = world["tree"]
    for sh in jsd.shards:
        sh.dqf.tree = jsd.tree
    jsd._invalidate_stacked()
    return jsd, _port(world, **over)


def _plan(q):
    """Tenant "a" for the first 12 queries, the default for the rest."""
    return [("a", q[:12]), ("default", q[12:])]


def _serve(eng, plan):
    rids = []
    for tenant, qs in plan:
        rids += eng.submit(qs, tenant=tenant)
    out = eng.run_until_drained()
    return [out["results"][r] for r in rids], out


def _compare(ref, port, what):
    """Per query: ids, hops, status, degraded flag and shards_responding
    equal, dists within rtol 1e-5; the divergent queries are named and
    held within ``MAX_DIVERGENT``."""
    bad = []
    for i, (a, b) in enumerate(zip(ref, port)):
        same = (np.array_equal(a["ids"], b["ids"])
                and np.allclose(a["dists"], b["dists"], rtol=1e-5, atol=0.0)
                and a["hops"] == b["hops"])
        if not same:
            bad.append(i)
        for key in ("status", "degraded", "shards_responding", "tenant"):
            assert a[key] == b[key], f"{what}: query {i} {key}"
    assert len(bad) <= MAX_DIVERGENT * len(ref), \
        f"{what}: {len(bad)}/{len(ref)} queries diverge: {bad}"
    return bad


def _counters(sd):
    return [{t.name: (t.counter.counts.copy(), t.counter.since_rebuild)
             for t in sh.dqf.tenants} for sh in sd.shards]


def _assert_same_counters(jsd, psd):
    for a, b in zip(_counters(jsd), _counters(psd)):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(b[name][0], a[name][0])
            assert b[name][1] == a[name][1]


def _bits(ra, rb, what):
    for i, (a, b) in enumerate(zip(ra, rb)):
        np.testing.assert_array_equal(a["ids"], b["ids"],
                                      err_msg=f"{what}: q{i} ids")
        np.testing.assert_array_equal(a["dists"].view(np.int32),
                                      b["dists"].view(np.int32),
                                      err_msg=f"{what}: q{i} dists")
        assert a["hops"] == b["hops"], f"{what}: q{i} hops"


# --------------------------------------------------------- against JAX
# the paged engine runs fused here (its composed tick is held to the
# fixed composed one bit for bit below), at one bucket width: the wave's
MODES = {"composed": dict(fused=False), "fused": dict(fused=True),
         "paged": dict(fused=True, paged=True, min_bucket=16)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("num_shards", [2, 3])
def test_engine_matches_reference(worlds, num_shards, mode):
    """Both engines on carried twins, two tenants interleaved, traces at
    rate 1: per query equal, ticks equal, every trace equal, the counters
    each tenant fed equal and fed once a query."""
    world = worlds(num_shards)
    fused = MODES[mode]["fused"]
    jsd, psd = _twins(world, fused=fused)
    base = [sh.dqf.tenants.get("a").counter.since_rebuild
            for sh in psd.shards]
    kw = dict(wave_size=16, tick_hops=4, page_cols=128,
              paged=MODES[mode].get("paged", False),
              min_bucket=MODES[mode].get("min_bucket", 8))
    je = JShardedEngine(jsd, **kw, obs=JObs(trace_rate=1.0,
                                            trace_capacity=256))
    pe = ShardedEngine(psd, **kw, obs=ObsConfig(trace_rate=1.0,
                                                trace_capacity=256))
    plan = _plan(world["q"])
    ref, _ = _serve(je, plan)
    port, _ = _serve(pe, plan)
    _compare(ref, port, f"S={num_shards} {mode}")
    assert pe.stats.ticks == je.stats.ticks
    assert pe.stats.completed == je.stats.completed == len(world["q"])
    assert all(r["status"] == "ok" and r["shards_responding"] == num_shards
               for r in port)
    _assert_same_counters(jsd, psd)
    for sh, b in zip(psd.shards, base):
        assert sh.dqf.tenants.get("a").counter.since_rebuild == b + 12
    jt = sorted(je.traces, key=lambda t: t["rid"])
    pt = sorted(pe.traces, key=lambda t: t["rid"])
    assert len(pt) == len(jt) == len(world["q"])
    for a, b in zip(jt, pt):
        assert {k: a[k] for k in TRACE_KEYS} == {k: b[k] for k in TRACE_KEYS}
        assert b["total_ms"] >= b["service_ms"] >= 0
    if kw["paged"]:
        assert pe.pagepool.live_count == 0


def test_engine_churn_auto_compact_matches_reference(worlds):
    """``tests/test_sharded.py:290-305`` on both packages: serve, delete
    30 of shard 0's rows between drains, serve again; the tombstone ratio
    trips the drain-and-compact, and the results, ticks, compactions and
    the state after the compaction are equal."""
    world = worlds(3)
    jsd, psd = _twins(world)
    kw = dict(wave_size=16, tick_hops=4, auto_compact=True,
              compact_ratio=0.05)
    je, pe = JShardedEngine(jsd, **kw), ShardedEngine(psd, **kw)
    q = world["q"]
    plan = [("default", q[:8])]
    _compare(*(_serve(e, plan)[0] for e in (je, pe)), "first drain")
    _assert_same_counters(jsd, psd)
    dead = psd.shards[0].dqf.store.ext_ids[:30].astype(np.int64)
    assert jsd.delete(dead) == psd.delete(dead) == 30
    ref, jout = _serve(je, [("default", q)])
    port, pout = _serve(pe, [("default", q)])
    _compare(ref, port, "after the delete")
    assert pout["compactions"] == jout["compactions"] >= 1
    assert pe.stats.ticks == je.stats.ticks
    assert pe.stats.completed == 8 + len(q)
    got = np.stack([r["ids"] for r in port])
    assert (got >= -1).all() and not set(got.ravel()) & set(dead.tolist())
    gt = ground_truth(world["x"], q, 5)
    assert recall_at_k(np.where(got < 0, 0, got), gt) > 0.6
    for a, b in zip(jsd.shards, psd.shards):
        assert a.dqf.store.n == b.dqf.store.n
        np.testing.assert_array_equal(a.dqf.store.ext_ids[:a.dqf.store.n],
                                      b.dqf.store.ext_ids[:b.dqf.store.n])
    assert psd._owner == jsd._owner


def test_quarantine_routes_around_as_reference(worlds):
    """``tests/test_chaos.py:280-310`` on both packages under the same
    plan (shard 1 fails every tick): per query equal, every result over
    the two responding shards and degraded, none from shard 1, one
    quarantine, and the recall of the explicit dropout merge."""
    world = worlds(3)
    jsd, psd = _twins(world)
    je = JShardedEngine(jsd, wave_size=16, tick_hops=4)
    pe = ShardedEngine(psd, wave_size=16, tick_hops=4)
    fail = {1: frozenset(range(100_000))}
    jplan, plan = JPlan(seed=2, shard_fail_ticks=fail), \
        FaultPlan(seed=2, shard_fail_ticks=fail)
    j_install_chaos(je, jplan)
    install_chaos(pe, plan)
    q = world["q"]
    ref, _ = _serve(je, [("default", q)])
    port, _ = _serve(pe, [("default", q)])
    _compare(ref, port, "shard 1 failing")
    assert pe.stats.ticks == je.stats.ticks
    assert plan.injected == jplan.injected
    for r in port:
        assert r["shards_responding"] == 2 and r["degraded"]
        assert r["status"] == "degraded"
    assert pe.health.quarantined[1] and pe.health.quarantines == 1
    assert pe.scrape()["shard_quarantine_total"] == 1.0
    st = psd.shards[1].dqf.store
    got = np.stack([r["ids"] for r in port])
    assert not set(got[got >= 0].tolist()) & set(st.ext_ids[:st.n].tolist())
    ids_deg, _, cov = psd.search_degraded(q, [True, False, True])
    assert cov == pytest.approx(2 / 3)
    gt = ground_truth(world["x"], q, psd.cfg.k)
    assert recall_at_k(np.where(got < 0, 0, got), gt) \
        > recall_at_k(np.where(ids_deg < 0, 0, ids_deg), gt) - 0.08


# ----------------------------------------------------------- port alone
@pytest.mark.parametrize("fused", [False, True])
def test_paged_bitwise_equals_fixed(worlds, fused):
    """``tests/test_sharded.py:307-327`` on the port: the paged engine
    retires the fixed engine's results bit for bit, composed and fused,
    with the same tick schedule, and frees every lane."""
    world = worlds(3)
    ea = ShardedEngine(_port(world, fused=fused), wave_size=16,
                       tick_hops=6)
    eb = ShardedEngine(_port(world, fused=fused), wave_size=16,
                       tick_hops=6, paged=True, page_cols=128)
    plan = _plan(world["q"])
    _bits(_serve(ea, plan)[0], _serve(eb, plan)[0], "paged vs fixed")
    assert ea.stats.ticks == eb.stats.ticks
    assert eb.pagepool.live_count == 0


def test_fused_bitwise_equals_composed(worlds):
    """The fused tick (one hop launch over S·W lanes with the per-lane
    table base) ≡ the composed one, bit for bit, tree included."""
    world = worlds(2)
    ea = ShardedEngine(_port(world, fused=False), wave_size=8, tick_hops=4)
    eb = ShardedEngine(_port(world, fused=True), wave_size=8, tick_hops=4)
    plan = _plan(world["q"])
    _bits(_serve(ea, plan)[0], _serve(eb, plan)[0], "fused vs composed")
    assert ea.stats.ticks == eb.stats.ticks


@pytest.mark.parametrize("hot_mode", ["graph", "mxu"])
def test_engine_equals_stacked_search_without_tree(worlds, hot_mode):
    """Without the tree every lane runs to exhaustion, so the engine's
    merged answers equal ``ShardedDQF.search``'s bit for bit (the stacked
    search merges each shard's top-k, the engine whole pools)."""
    world = worlds(2)
    sd = _port(world, hot_mode=hot_mode)
    assert sd.tree is None
    want = sd.search(world["q"], record=False, tenant="a")
    eng = ShardedEngine(sd, wave_size=8, tick_hops=5)
    got, _ = _serve(eng, [("a", world["q"])])
    np.testing.assert_array_equal(np.stack([r["ids"] for r in got]),
                                  want.ids)
    np.testing.assert_array_equal(np.stack([r["dists"] for r in got]),
                                  want.dists)


def test_paged_continuous_occupancy_and_pool_counters(worlds):
    """``tests/test_sharded.py:330-346`` and ``:393-405`` on the port:
    more requests than lanes turn lanes over, the occupancy gauge follows
    the allocator, and the shared pool's counters balance."""
    world = worlds(2)
    eng = ShardedEngine(_port(world), wave_size=4, tick_hops=4, paged=True,
                        page_cols=128)
    q = world["q"]
    eng.submit(np.concatenate([q, q]))
    out = eng.run_until_drained()
    assert eng.stats.completed == 2 * len(q) and eng.stats.ticks > 1
    done = eng.scrape()
    assert done["sharded_engine_occupancy_ratio"] == 0.0
    assert done["sharded_engine_live_lanes"] == 0.0
    ppl = eng.pagepool.pages_per_lane
    assert done["page_pool_alloc_total{pool=sharded}"] >= 2 * len(q) * ppl
    assert done["page_pool_free_total{pool=sharded}"] == \
        done["page_pool_alloc_total{pool=sharded}"]
    assert done["page_pool_pages_in_use{pool=sharded}"] == 0.0
    got = np.stack([out["results"][r]["ids"] for r in range(len(q))])
    gt = ground_truth(world["x"], q, 5)
    assert recall_at_k(np.where(got < 0, 0, got), gt) > 0.6


def test_trace_rate_zero_records_nothing(worlds):
    eng = ShardedEngine(_port(worlds(2)), wave_size=8, tick_hops=4,
                        obs=ObsConfig(trace_rate=0.0))
    eng.submit(worlds(2)["q"][:16])
    eng.run_until_drained()
    assert eng.stats.completed == 16
    assert len(eng.traces) == 0 and eng.traces.total == 0


def test_rejects_quant(worlds):
    """``tests/test_sharded.py:408``: quantized shards are refused."""
    x, q = _data(n=120)
    cfg = port_cfg(worlds(2)["cfg"], quant=QuantConfig(mode="sq8"))
    sd = ShardedDQF(cfg, 2, device="cpu").build(x)
    with pytest.raises(ValueError):
        ShardedEngine(sd)


@pytest.mark.parametrize("paged", [False, True])
def test_growth_mid_flight_and_compact_refusal(worlds, paged):
    """An insert that grows the common capacity while lanes are in flight
    re-pads the wave state and the results equal those of an engine
    over the grown index; a compaction while lanes are in flight
    raises."""
    world = worlds(2)
    sd = _port(world)
    sd._sync_stacked()
    cap = sd._stk_cap
    eng = ShardedEngine(sd, wave_size=16, tick_hops=2, paged=paged,
                        page_cols=128)
    q = world["q"]
    eng.submit(q)
    eng.step()
    grow = cap - min(sh.dqf.store.n for sh in sd.shards) + 1
    rows = np.random.default_rng(3).standard_normal(
        (2 * grow, q.shape[1])).astype(np.float32)
    new = sd.insert(rows)
    np.testing.assert_array_equal(new, len(world["x"]) + np.arange(len(rows)))
    out = eng.run_until_drained()
    assert sd._stk_cap > cap and eng._cap == sd._stk_cap
    got = np.stack([out["results"][r]["ids"] for r in range(len(q))])
    assert got.shape == (len(q), 5) and (got >= -1).all()
    gt = ground_truth(np.concatenate([world["x"], rows]), q, 5)
    assert recall_at_k(np.where(got < 0, 0, got), gt) > 0.6
    eng.submit(q[:4])
    eng.step()
    sd.delete(new[:1])
    sd.shards[0].dqf.compact()
    with pytest.raises(RuntimeError):
        eng.step()


def test_shard_recovers_after_probes(worlds):
    """``tests/test_chaos.py:313-331`` on the port: a shard failing two
    ticks is quarantined, then re-admitted after two clean probes."""
    world = worlds(3)
    eng = ShardedEngine(
        _port(world), wave_size=4, tick_hops=4,
        engine_cfg=EngineConfig(quarantine_after=2, recover_after=2))
    install_chaos(eng, FaultPlan(seed=4,
                                 shard_fail_ticks={2: frozenset(range(2))}))
    q = world["q"]
    rids = eng.submit(q)
    out = eng.run_until_drained()
    assert set(rids) <= set(out["results"])
    assert eng.health.quarantines == 1 and eng.health.readmissions == 1
    assert not eng.health.quarantined.any()
    responding = [out["results"][r]["shards_responding"] for r in rids]
    assert max(responding) == 3 and min(responding) >= 2


@pytest.mark.parametrize("paged", [False, True])
def test_chaos_off_bit_identical(worlds, paged):
    """``tests/test_chaos.py:334-347`` on the port: a zero-rate plan is a
    bitwise no-op."""
    world = worlds(3)
    ea = ShardedEngine(_port(world), wave_size=8, tick_hops=4, paged=paged)
    eb = ShardedEngine(_port(world), wave_size=8, tick_hops=4, paged=paged)
    install_chaos(eb, FaultPlan(seed=0))
    plan = [("default", world["q"])]
    ra, rb = _serve(ea, plan)[0], _serve(eb, plan)[0]
    _bits(ra, rb, "zero-rate plan")
    assert all(b["status"] == "ok" and b["shards_responding"] == 3
               and not b["degraded"] for b in rb)


def test_stall_misses_merge_without_quarantine(worlds):
    """A stalled shard misses its ticks' merges (degraded results) but is
    never quarantined; the fleet scrape carries the engine's series."""
    world = worlds(2)
    eng = ShardedEngine(_port(world), wave_size=8, tick_hops=4,
                        engine_cfg=EngineConfig(quarantine_after=1))
    install_chaos(eng, FaultPlan(seed=1, shard_stall_ticks={
        0: frozenset(range(100_000))}))
    rids = eng.submit(world["q"][:8])
    out = eng.run_until_drained()
    assert eng.health.quarantines == 0
    owned = eng.sharded.shards[0].dqf.store
    for r in rids:
        res = out["results"][r]
        assert res["degraded"] and res["shards_responding"] == 1
        assert not set(res["ids"].tolist()) & set(
            owned.ext_ids[:owned.n].tolist())
    sc = eng.scrape()
    assert sc["sharded_engine_degraded_total"] == 8.0
    assert sc["sharded_engine_shards_responding"] == 1.0
