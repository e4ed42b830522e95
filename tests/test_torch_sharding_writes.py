"""Port of the sharded index's writes (``ShardedDQF.insert/delete/compact``
and the rebalance) and of ``ShardHealth``, against the JAX package.

One reference ``ShardedDQF`` a world is built for the module (n = 600 at
S = 2 and 4, the rebalance world of ``tests/test_sharded.py:158-181`` at
n = 900 and S = 3) and saved shard by shard.  Each test loads a fresh
reference twin and a fresh port twin (:func:`repro_torch.convert.
sharded_from_arrays`, on the CPU) from that state and puts both through
the same writes; after each step the owner map, ``_next_ext``, every
shard's store, adjacency and tenant counters must be equal, and the
searches too (ids equal, dists within rtol 1e-5, any divergent lane
named).  The port-only cases of ``tests/test_sharded.py:107-142`` run on
the port twin, and the health state machine is held to the reference's
over a seeded random sequence of events.
"""

import numpy as np
import pytest

from repro.core.dqf import DQF as JDQF
from repro.core.types import DQFConfig as JConfig
from repro.obs import MetricsRegistry as JRegistry
from repro.sharding import ShardConfig as JShardConfig
from repro.sharding import ShardedDQF as JShardedDQF
from repro.sharding import ShardHealth as JShardHealth
from repro.sharding.sharded import _Shard as _JShard
from repro_torch.convert import sharded_from_arrays
from repro_torch.obs import MetricsRegistry
from repro_torch.sharding import ShardConfig, ShardHealth
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_search import port_cfg
from tests.test_torch_sharding import (CFG, D, _data, _divergent_lanes,
                                       _shard_arrays)

WORLDS = {2: 600, 4: 600, 3: 900}       # S -> rows



@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One reference ShardedDQF a shard count in ``WORLDS``, built and
    warmed once (the S = 3 one with a second tenant, "a"), saved as its
    shards' checkpoints; returns ``get(S) -> world``."""
    cache = {}

    def get(S):
        if S not in cache:
            x, q = _data(n=WORLDS[S])
            jsd = JShardedDQF(JConfig(**CFG),
                              JShardConfig(num_shards=S)).build(x)
            jsd.warm(q[:8])
            if S == 3:
                jsd.warm(q[8:16], tenant="a")
            tmp = tmp_path_factory.mktemp(f"writes{S}")
            paths = []
            for s, sh in enumerate(jsd.shards):
                paths.append(str(tmp / f"shard{s}.npz"))
                sh.dqf.save(paths[-1])
            cache[S] = dict(x=x, q=q, cfg=jsd.cfg, paths=paths,
                            arrays=_shard_arrays(jsd, tmp),
                            owner=dict(jsd._owner), next_ext=jsd._next_ext)
        return cache[S]

    return get


def _twins(world):
    """A fresh reference ShardedDQF and a fresh port one (CPU) over the
    world's saved state."""
    S = len(world["paths"])
    jsd = JShardedDQF(world["cfg"], JShardConfig(num_shards=S))
    jsd.shards = [_JShard(index=s, dqf=JDQF.load(p, world["cfg"]))
                  for s, p in enumerate(world["paths"])]
    jsd._owner = dict(world["owner"])
    jsd._next_ext = world["next_ext"]
    jsd._mesh = jsd._make_mesh()
    jsd._invalidate_stacked()
    psd = sharded_from_arrays(world["arrays"], dict(world["owner"]), None,
                              port_cfg(world["cfg"]),
                              ShardConfig(num_shards=S), device="cpu")
    return jsd, psd


def _assert_same_state(jsd, psd, what):
    """Owner map, next ext id, and every shard's store, adjacency and
    tenant counters equal between the reference and the port."""
    assert psd._owner == jsd._owner, what
    assert psd._next_ext == jsd._next_ext, what
    for s, (a, b) in enumerate(zip(jsd.shards, psd.shards)):
        ja, pa = a.dqf, b.dqf
        n = ja.store.n
        assert pa.store.n == n, (what, s)
        np.testing.assert_array_equal(pa.store.ext_ids[:n],
                                      ja.store.ext_ids[:n], err_msg=what)
        np.testing.assert_array_equal(pa.store.alive[:n], ja.store.alive[:n],
                                      err_msg=what)
        np.testing.assert_array_equal(pa.store.x[:n], ja.store.x[:n],
                                      err_msg=what)
        np.testing.assert_array_equal(pa.full.adj[:n],
                                      np.asarray(ja.full.adj)[:n],
                                      err_msg=f"{what}: shard {s} adjacency")
        assert sorted(pa.tenants.names()) == sorted(ja.tenants.names())
        for t in ja.tenants:
            pt = pa.tenants.get(t.name)
            np.testing.assert_array_equal(pt.counter.counts,
                                          t.counter.counts, err_msg=what)
            assert pt.counter.since_rebuild == t.counter.since_rebuild
            np.testing.assert_array_equal(pt.hot.ids, t.hot.ids,
                                          err_msg=f"{what}: hot ids")


def _assert_same_search(jsd, psd, q, tenant="default"):
    a = jsd.search(q, record=False, tenant=tenant)
    b = psd.search(q, record=False, tenant=tenant)
    return _divergent_lanes(a, b)


# ------------------------------------------------------------------ writes
@pytest.mark.parametrize("num_shards", [2, 4])
def test_writes_match_reference(worlds, num_shards):
    """``tests/test_sharded.py:107-122``'s churn on both packages: insert
    40 rows, delete every 7th of the first 60 ids, compact; equal state
    and searches after each step."""
    world = worlds(num_shards)
    jsd, psd = _twins(world)
    q = world["q"]
    _assert_same_state(jsd, psd, "carried")
    rows = np.random.default_rng(9).standard_normal((40, D)).astype(
        np.float32)
    np.testing.assert_array_equal(psd.insert(rows), jsd.insert(rows))
    _assert_same_state(jsd, psd, "insert")
    _assert_same_search(jsd, psd, q)
    dead = np.arange(0, 60, 7)
    assert psd.delete(dead) == jsd.delete(dead)
    _assert_same_state(jsd, psd, "delete")
    _assert_same_search(jsd, psd, q)
    rep_p, rep_j = psd.compact(), jsd.compact()
    assert rep_p == rep_j
    _assert_same_state(jsd, psd, "compact")
    _assert_same_search(jsd, psd, q)
    with pytest.raises(KeyError):
        psd.delete(dead[:1])             # gone from the owner map


def test_rebalance_matches_reference(worlds):
    """``tests/test_sharded.py:158-181`` on both packages: traffic pinned
    to shard 0's rows moves them at compaction; the same rows move, the
    same counter mass goes with them, and the port's result stays
    oracle-exact."""
    world = worlds(3)
    jsd, psd = _twins(world)
    donor_ext = psd.shards[0].dqf.store.ext_ids[:5].astype(np.int64)
    for sd in (jsd, psd):
        for _ in range(5):
            sd.record(np.tile(donor_ext, (20, 1)))
        sd.rebuild_hot()
    _assert_same_state(jsd, psd, "recorded")
    masses = [psd._shard_mass(sh) for sh in psd.shards]
    assert masses == [jsd._shard_mass(sh) for sh in jsd.shards]
    before = dict(psd._owner)
    rep_p, rep_j = psd.compact(), jsd.compact()
    assert rep_p == rep_j and rep_p["rebalanced_rows"] > 0
    moved = sorted(e for e, s in psd._owner.items() if before[e] != s)
    assert moved == sorted(e for e, s in jsd._owner.items()
                           if before[e] != s)
    assert len(moved) == rep_p["rebalanced_rows"]
    assert {before[e] for e in moved} == {0}
    assert psd.scrape()["shard_rebalanced_rows_total"] \
        == jsd.scrape()["shard_rebalanced_rows_total"] \
        == rep_p["rebalanced_rows"]
    _assert_same_state(jsd, psd, "rebalanced")
    for t in ("default", "a"):
        _assert_same_search(jsd, psd, world["q"], tenant=t)
    a = psd.search(world["q"], record=False)
    b = psd.search_oracle(world["q"])
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    res = psd.search(np.ascontiguousarray(world["x"][donor_ext]),
                     record=False)
    assert set(donor_ext.tolist()) <= set(res.ids[:, 0].tolist())


def test_no_rebalance_when_balanced_or_disabled(worlds):
    """No traffic skew, or ``rebalance=False``: compaction moves nothing,
    as in the reference."""
    world = worlds(2)
    jsd, psd = _twins(world)
    assert psd.compact()["rebalanced_rows"] == \
        jsd.compact()["rebalanced_rows"] == 0
    _, psd = _twins(world)
    psd.scfg = ShardConfig(num_shards=2, rebalance=False)
    donor = psd.shards[0].dqf.store.ext_ids[:5].astype(np.int64)
    psd.record(np.tile(donor, (50, 1)))
    psd.rebuild_hot()
    assert psd.compact()["rebalanced_rows"] == 0
    assert psd.scrape()["shard_rebalanced_rows_total"] == 0


# ---------------------------------------------------- port-only, churn
def _assert_parity(sd, q):
    a = sd.search(q, record=False)
    b = sd.search_oracle(q)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    return a


def test_parity_under_churn(worlds):
    """``tests/test_sharded.py:107-122`` on the port: the stacked search
    equals the oracle across insert, delete and compact, never returns a
    deleted id, and compaction leaves the external results as they
    were."""
    world = worlds(4)
    _, sd = _twins(world)
    q = world["q"]
    rng = np.random.default_rng(9)
    ext_new = sd.insert(rng.standard_normal((40, D)).astype(np.float32))
    assert ext_new.size == 40
    dead = np.arange(0, 60, 7)
    sd.delete(dead)
    res = _assert_parity(sd, q)
    assert not set(res.ids.ravel().tolist()) & set(dead.tolist())
    before = sd.search(q, record=False).ids
    sd.compact()
    _assert_parity(sd, q)
    np.testing.assert_array_equal(before, sd.search(q, record=False).ids)


def test_insert_balances_and_delete_routes(worlds):
    """``tests/test_sharded.py:133-142`` on the port, plus the refusals
    of ``insert``."""
    _, sd = _twins(worlds(4))
    counts0 = [sh.dqf.store.live_count for sh in sd.shards]
    sd.insert(np.random.default_rng(5).standard_normal(
        (20, D)).astype(np.float32))
    counts1 = [sh.dqf.store.live_count for sh in sd.shards]
    assert sum(counts1) == sum(counts0) + 20
    assert max(counts1) - min(counts1) <= max(counts0) - min(counts0) + 1
    with pytest.raises(KeyError):
        sd.delete([10 ** 6])
    row = np.zeros((1, D), np.float32)
    with pytest.raises(ValueError):
        sd.insert(row, ext_ids=[0])                     # already owned
    with pytest.raises(ValueError):
        sd.insert(row, ext_ids=[2 ** 31])               # past int32
    with pytest.raises(ValueError):
        sd.insert(np.zeros((2, D), np.float32), ext_ids=[10 ** 6])
    ext = sd.insert(row, ext_ids=[10 ** 6])
    assert sd._owner[10 ** 6] in range(4) and sd._next_ext == 10 ** 6 + 1
    np.testing.assert_array_equal(ext, [10 ** 6])


# ------------------------------------------------------------------ health
@pytest.mark.parametrize("seed", [0, 1])
def test_health_state_machine_matches_reference(seed):
    """``ShardHealth`` and the reference's over one seeded sequence of
    fail/stall/clean events and probes: equal masks, quarantine state,
    counters and scrapes at every tick."""
    rng = np.random.default_rng(seed)
    S = 4
    reg, jreg = MetricsRegistry(), JRegistry()
    mine = ShardHealth(S, quarantine_after=2, recover_after=2, registry=reg)
    ref = JShardHealth(S, quarantine_after=2, recover_after=2,
                       registry=jreg)
    kinds = np.array([None, None, "fail", "stall"], object)
    for _ in range(200):
        events = {s: ev for s in range(S)
                  if (ev := kinds[rng.integers(0, 4)]) is not None}
        for a, b in zip(mine.observe(events), ref.observe(events)):
            np.testing.assert_array_equal(a, b)
        for s in np.flatnonzero(ref.quarantined):
            ok = bool(rng.random() < 0.6)
            assert mine.probe(int(s), ok) == ref.probe(int(s), ok)
        np.testing.assert_array_equal(mine.quarantined, ref.quarantined)
        assert mine.responding() == ref.responding()
        assert (mine.quarantines, mine.readmissions) == \
            (ref.quarantines, ref.readmissions)
        assert reg.scrape() == jreg.scrape()
    assert mine.quarantines > 0 and mine.readmissions > 0
    for bad in (dict(quarantine_after=0), dict(recover_after=0)):
        with pytest.raises(ValueError):
            ShardHealth(S, **bad)
