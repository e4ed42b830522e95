"""The port's own mutation scenarios, split from
``tests/test_torch_mutation.py`` along its sections.

* ``tests/test_store_mutation.py``'s scenarios on the port alone: inserts
  are searchable, no tombstoned id is returned, external ids survive
  compaction, churned recall against a rebuild, the insert → delete →
  compact → save → load round trip, engines serving across churn, a
  rebuilt instance, delete's refusal, compaction refused in flight and
  run by the engines at drain.
* The churn and growth cases of ``tests/test_paged_engine.py`` on the
  port's engines: paged ≡ fixed under churn at drain boundaries, capacity
  growth with lanes in flight.
"""

import os

import numpy as np
import pytest
import torch

from repro.core import ZipfWorkload
from repro_torch.core import DQF, DQFConfig, QuantConfig, ground_truth, \
    recall_at_k
from repro_torch.serving.engine import WaveEngine
from repro_torch.serving.paged_engine import PagedWaveEngine
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests._hypothesis_compat import given, settings, st
from tests.conftest import make_clustered
from tests.test_torch_serving import _built, _cfg, diverging_queries


def _small_cfg(**over):
    """tests/test_store_mutation.py::_small_cfg, in the port."""
    base = dict(knn_k=10, out_degree=10, index_ratio=0.03, k=10,
                hot_pool=16, full_pool=32, max_hops=100,
                n_query_trigger=10 ** 6)
    base.update(over)
    return DQFConfig(**base)


# --------------------------------------------------- the port's scenarios
@pytest.fixture(scope="module")
def churn_world():
    """tests/test_store_mutation.py::churn_world, on the port."""
    x = make_clustered(n=1200, d=16, clusters=16, seed=11)
    dqf = DQF(_small_cfg(quant=QuantConfig(mode="sq8", rerank_k=32)),
              device="cpu").build(x)
    wl = ZipfWorkload(x, seed=12)
    _, t = wl.sample(3000, with_targets=True)
    dqf.counter.record(t)
    dqf.rebuild_hot()
    return dqf, wl, x


def test_insert_is_searchable(churn_world):
    dqf, wl, x = churn_world
    rng = np.random.default_rng(0)
    new_rows = x[rng.choice(x.shape[0], 40)] \
        + 0.02 * rng.standard_normal((40, x.shape[1])).astype(np.float32)
    n_before = dqf.store.n
    ext = dqf.insert(new_rows)
    assert ext.shape == (40,)
    res = dqf.search(np.ascontiguousarray(new_rows[:16]), record=False)
    ids = res.ids.numpy()
    hit = (ids == np.arange(n_before, n_before + 16)[:, None]).any(axis=1)
    assert hit.mean() >= 0.8


@pytest.fixture(scope="module")
def tombstone_world():
    """tests/test_store_mutation.py::tombstone_world, on the port."""
    x = make_clustered(n=1000, d=16, clusters=16, seed=41)
    dqf = DQF(_small_cfg(quant=QuantConfig(mode="sq8", rerank_k=32)),
              device="cpu").build(x)
    wl = ZipfWorkload(x, seed=42)
    _, t = wl.sample(2500, with_targets=True)
    dqf.counter.record(t)
    dqf.rebuild_hot()
    return dqf, wl, x


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=5, deadline=None)
def test_search_never_returns_tombstoned(tombstone_world, seed):
    dqf, wl, x = tombstone_world
    rng = np.random.default_rng(seed)
    live = dqf.store.live_ids()
    victims = rng.choice(live, size=max(1, live.size // 20), replace=False)
    dqf.delete(dqf.store.to_external(victims))
    q = wl.sample(64)
    for res in (dqf.search(q, record=False), dqf.search_baseline(q),
                dqf.search_dual_beam(q)):
        ids = res.ids.numpy()
        real = ids[(ids >= 0) & (ids < dqf.store.n)]
        assert dqf.store.alive[real].all(), "tombstoned id returned"


def test_external_ids_stable_across_compact(churn_world):
    dqf, wl, x = churn_world
    live = dqf.store.live_ids()
    probe = live[:: max(1, live.size // 50)]
    ext = dqf.store.to_external(probe)
    vecs = dqf.store.x[probe].copy()
    out = dqf.compact()
    assert out["dropped"] >= 0
    back = dqf.store.to_internal(ext)
    np.testing.assert_array_equal(dqf.store.x[back], vecs)
    q = wl.sample(32)
    ids = dqf.search(q, record=False).ids.numpy()
    ext_ids = dqf.to_external(ids)
    valid = ext_ids >= 0
    np.testing.assert_array_equal(
        dqf.store.to_internal(ext_ids[valid]), ids[valid])


def test_churn_recall_matches_rebuild():
    """10% churn ≈ a from-scratch rebuild (±2 recall points), with
    quantization on end to end."""
    x = make_clustered(n=1200, d=16, clusters=16, seed=31)
    cfg = _small_cfg(quant=QuantConfig(mode="sq8", rerank_k=32))
    dqf = DQF(cfg, device="cpu").build(x)
    wl = ZipfWorkload(x, seed=32)
    _, t = wl.sample(3000, with_targets=True)
    dqf.counter.record(t)
    dqf.rebuild_hot()
    rng = np.random.default_rng(33)
    n = x.shape[0]
    victims = rng.choice(n, size=n // 10, replace=False)
    dqf.insert(make_clustered(n=n // 10, d=16, clusters=16, seed=34))
    dqf.delete(dqf.store.to_external(victims))
    dqf.compact()
    live_x = dqf.store.x
    q = wl.sample(128)
    gt = ground_truth(live_x, q, cfg.k)
    rec_churned = recall_at_k(dqf.search(q, record=False).ids.numpy(), gt)
    fresh = DQF(cfg, device="cpu").build(live_x)
    _, t2 = wl.sample(3000, with_targets=True)
    surviving = np.isin(t2, dqf.store.ext_ids)
    fresh.counter.record(dqf.store.to_internal(t2[surviving]))
    fresh.rebuild_hot()
    rec_fresh = recall_at_k(fresh.search(q, record=False).ids.numpy(), gt)
    assert rec_churned >= rec_fresh - 0.02, (rec_churned, rec_fresh)


def test_insert_delete_compact_save_load_roundtrip(tmp_path, churn_world):
    dqf, wl, x = churn_world
    rng = np.random.default_rng(5)
    dqf.insert(make_clustered(n=30, d=16, clusters=16, seed=6))
    live = dqf.store.live_ids()
    dqf.delete(dqf.store.to_external(
        rng.choice(live, size=25, replace=False)))
    dqf.compact()
    q = wl.sample(48)
    p = str(tmp_path / "churned.npz")
    dqf.save(p)
    loaded = DQF.load(p, dqf.cfg, device="cpu")
    a = dqf.search(q, record=False)
    b = loaded.search(q, record=False)
    for u, v in zip(a, b):
        if isinstance(u, torch.Tensor):
            assert torch.equal(u, v)
    np.testing.assert_array_equal(dqf.store.ext_ids, loaded.store.ext_ids)
    np.testing.assert_array_equal(dqf.store.alive, loaded.store.alive)
    assert loaded.store.capacity == dqf.store.capacity
    assert loaded.counter.since_rebuild == dqf.counter.since_rebuild
    assert sorted(os.listdir(tmp_path)) == ["churned.npz"]   # no staging


def test_engine_serves_across_churn(churn_world):
    dqf, wl, x = churn_world
    eng = WaveEngine(dqf, wave_size=16, tick_hops=8)
    r0 = eng.submit(wl.sample(24))
    eng.run_until_drained()
    dqf.insert(make_clustered(n=20, d=16, clusters=16, seed=7))
    live = dqf.store.live_ids()
    rng = np.random.default_rng(8)
    dqf.delete(dqf.store.to_external(rng.choice(live, 20, replace=False)))
    r1 = eng.submit(wl.sample(24))
    out = eng.run_until_drained()
    assert all(r in out["results"] for r in r0 + r1)
    for rid in r1:
        ids = out["results"][rid]["ids"]
        ids = ids[(ids >= 0) & (ids < dqf.store.n)]
        assert dqf.store.alive[ids].all()


def test_rebuild_same_instance_serves_new_data():
    """A second build() on the same DQF drops every cached device table."""
    x1 = make_clustered(n=300, d=8, seed=51)
    x2 = make_clustered(n=300, d=8, seed=52) + 100.0
    dqf = DQF(_small_cfg(knn_k=8, out_degree=8), device="cpu").build(x1)
    assert dqf.hot is None
    dqf.build(x2)
    res = dqf.search_baseline(np.ascontiguousarray(x2[:8]))
    assert np.allclose(res.dists.numpy()[:, 0], 0.0, atol=1e-3)


def test_delete_refuses_to_empty_index(churn_world):
    dqf, wl, x = churn_world
    live_ext = dqf.store.to_external(dqf.store.live_ids())
    before_alive = dqf.store.alive.copy()
    epoch = dqf.store.epoch
    with pytest.raises(ValueError, match="rebuild instead"):
        dqf.delete(live_ext)
    np.testing.assert_array_equal(dqf.store.alive, before_alive)
    assert dqf.store.epoch == epoch


@pytest.mark.parametrize("cls,width", [(WaveEngine, "wave_size"),
                                       (PagedWaveEngine, "capacity")])
def test_engine_refuses_compact_in_flight(churn_world, cls, width):
    dqf, wl, x = churn_world
    eng = cls(dqf, **{width: 8}, tick_hops=2)
    eng.submit(wl.sample(16))
    eng._init_wave()
    dqf.compact()
    with pytest.raises(RuntimeError, match="drain"):
        eng._tick()


@pytest.mark.parametrize("cls,width", [(WaveEngine, "wave_size"),
                                       (PagedWaveEngine, "capacity")])
def test_engine_auto_compacts_at_drain(cls, width):
    """Past the tombstone ratio the engine stops refilling, drains and
    compacts through ``DQF.compact``; queued queries then resume."""
    x = make_clustered(n=600, d=16, clusters=12, seed=61)
    dqf = _built(_cfg(True), x)
    wl = ZipfWorkload(x, seed=62)
    eng = cls(dqf, **{width: 8}, tick_hops=4, compact_ratio=0.05)
    rids = eng.submit(wl.sample(24))
    eng.step()
    live = dqf.store.live_ids()
    dead_ext = dqf.store.to_external(live[::10])
    dqf.delete(dead_ext)
    out = eng.run_until_drained()
    assert eng.stats.compactions == 1 and dqf.store.n == 600 - 60
    assert dqf.store.live_count == dqf.store.n
    assert all(out["results"][r]["status"] == "ok" for r in rids)
    # the first 8 retired before the compaction, in the old id space; the
    # rest ran after it, in the new one
    ids = np.stack([out["results"][r]["ids"] for r in rids[8:]])
    assert (ids < dqf.store.n).all()
    assert not np.isin(dqf.to_external(ids), dead_ext).any()


# ------------------------------------- the paged engine's churn and growth
@pytest.fixture(scope="module")
def world_x():
    return make_clustered(n=900, d=16, clusters=12, seed=31)


def test_paged_parity_under_churn_at_drain_boundaries(world_x):
    """tests/test_paged_engine.py:69 on the port: the same insert/delete
    churn applied to both stores between drains keeps the engines
    bit-identical round after round; a compaction last."""
    x = world_x
    da = _built(_cfg(False), x)
    db = _built(_cfg(True), x)
    ea = WaveEngine(da, wave_size=16, tick_hops=6, prefetch=False)
    eb = PagedWaveEngine(db, capacity=16, tick_hops=6, page_cols=128,
                         prefetch=False)
    wl = ZipfWorkload(x, seed=11)
    rng = np.random.default_rng(2)
    for rnd in range(4):
        q = wl.sample(20)
        ra, rb = ea.submit(q), eb.submit(q)
        oa, ob = ea.run_until_drained(), eb.run_until_drained()
        assert diverging_queries(oa, ob, ra, rb) == []
        if rnd == 2:
            da.compact()
            db.compact()
            continue
        new = make_clustered(n=16, d=16, clusters=12, seed=50 + rnd)
        da.insert(new)
        db.insert(new)
        dead = da.store.to_external(
            rng.choice(da.store.live_ids(), 10, replace=False))
        da.delete(dead)
        db.delete(dead)
    assert da.store.capacity == db.store.capacity == 1024


@pytest.mark.parametrize("cls,width", [(WaveEngine, "wave_size"),
                                       (PagedWaveEngine, "capacity")])
def test_capacity_growth_with_lanes_in_flight(world_x, cls, width):
    """tests/test_paged_engine.py:181 on the port (both engines): store
    growth mid-stream re-pads (fixed) or re-pages (paged) the live lanes;
    results stay valid and the engine tracks the new capacity."""
    x = world_x
    dqf = _built(_cfg(False), x)
    eng = cls(dqf, **{width: 8}, tick_hops=4, prefetch=False)
    q = ZipfWorkload(x, seed=37).sample(20)
    rids = eng.submit(q)
    eng.step()
    cap0 = dqf.store.capacity
    dqf.insert(make_clustered(n=64, d=16, clusters=12, seed=53))
    assert dqf.store.capacity > cap0
    out = eng.run_until_drained()
    assert len(out["results"]) == 20
    assert eng._cap == dqf.store.capacity
    if cls is PagedWaveEngine:
        assert eng.pagepool.n_ids == dqf.store.capacity
    ids = np.stack([out["results"][r]["ids"] for r in rids])
    valid = ids[(ids >= 0) & (ids < dqf.store.n)]
    assert dqf.store.alive[valid].all()
    assert recall_at_k(ids, ground_truth(x, q, eng.cfg.k)) > 0.5
