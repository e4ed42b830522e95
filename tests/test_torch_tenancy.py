"""Port of tenancy and the store against the JAX package.

* ``repro_torch.store.VectorStore`` ≡ ``repro.store.VectorStore`` through
  one add / mark_dead / compact / grow sequence: rows, liveness, external
  ids, epochs, capacity, remaps, checkpoint arrays and padded device
  tables equal, codes included for sq8; then the same sequence on tiered
  stores of both packages, their block caches' maps and counters equal.
* A multi-tenant reference DQF (``DQF.save``) carried across with
  ``convert.dqf_from_arrays``: every tenant's counter and hot index, the
  stacked ``(T_pad, H_pad+1, ·)`` tables byte-equal to the reference's
  ``TenantRegistry.stacked``, the incremental per-slot update equal to a
  full restack, ``hot_phase_stacked`` (graph, composed and through the
  fused hop's per-lane table base, and mxu) and per-tenant
  ``DQF.search`` against the reference's on the same queries (ids and
  counters per lane, dists within rtol 1e-5, at most 1% of lanes
  diverging through a float32 near-tie, listed), and the tenant lifecycle
  (slots, reuse, ``gen``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import quant as jquant
from repro.core import DQF as JDQF
from repro.core import QuantConfig as JQuant
from repro.core.dynamic_search import hot_phase_stacked as j_stacked
from repro.store import VectorStore as JStore
from repro.tiering import TierConfig as JTier
from repro_torch import quant as tquant
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import QuantConfig as TQuant
from repro_torch.core import beam_search as tbs
from repro_torch.core.dynamic_search import hot_phase_stacked as t_stacked
from repro_torch.store import VectorStore as TStore
from repro_torch.tiering import TierConfig as TTier
from tests.conftest import make_clustered
from tests.test_multitenant import CFG, disjoint_workloads
from tests.test_torch_search import MAX_DIVERGENT, assert_lanes_match, \
    port_cfg

TENANTS = 3


def saved_arrays(dqf, tmp_path_factory) -> dict:
    path = tmp_path_factory.mktemp("mt") / "dqf.npz"
    dqf.save(str(path))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def mt_pair(small_data, tmp_path_factory):
    """A reference DQF serving three tenants with disjoint Zipf heads (the
    default tenant stays cold) and its arrays as ``np.load`` gives them."""
    dqf = JDQF(CFG).build(small_data)
    wls = disjoint_workloads(small_data, TENANTS, seed=3)
    for t, wl in enumerate(wls):
        q, tg = wl.sample(1500, with_targets=True)
        dqf.warm(q, tg, tenant=f"t{t}")
    dqf.fit_tree(wls[0].sample(300), tenant="t0")
    return dqf, wls, saved_arrays(dqf, tmp_path_factory)


def port_of(arrays):
    return dqf_from_arrays(arrays, port_cfg(CFG), device="cpu")


# ------------------------------------------------------------------ store
def assert_stores_equal(js, ts, epochs=True):
    assert (ts.n, ts.d, ts.capacity, ts.next_ext) == \
        (js.n, js.d, js.capacity, js.next_ext)
    if epochs:                                # checkpoints keep none
        assert (ts.epoch, ts.rows_epoch, ts.remap_epoch) == \
            (js.epoch, js.rows_epoch, js.remap_epoch)
    assert ts.live_count == js.live_count
    assert ts.should_compact(0.05) == js.should_compact(0.05)
    ja, ta = js.to_arrays(), ts.to_arrays()
    assert sorted(ja) == sorted(ta)
    for key in ja:
        np.testing.assert_array_equal(np.asarray(ta[key]),
                                      np.asarray(ja[key]), err_msg=key)
    np.testing.assert_array_equal(ts.padded_rows().numpy(),
                                  np.asarray(js.padded_rows()))
    np.testing.assert_array_equal(ts.padded_live().numpy(),
                                  np.asarray(js.padded_live()))
    adj = np.random.default_rng(ts.n).integers(-1, ts.n, (ts.n, 6))
    np.testing.assert_array_equal(ts.pad_adjacency(adj).numpy(),
                                  np.asarray(js.pad_adjacency(adj)))
    if js.quant is not None:
        np.testing.assert_array_equal(
            ts.padded_quant_table().codes.numpy(),
            np.asarray(js.padded_quant_table().codes))


@pytest.mark.parametrize("mode", ["none", "sq8"])
def test_store_matches_reference_through_mutations(mode, tmp_path):
    x = make_clustered(n=300, d=12, clusters=6, seed=4)
    more = make_clustered(n=90, d=12, clusters=6, seed=5)
    jq = tq = None
    if mode == "sq8":
        jq = jquant.build_quantizer(x, JQuant(mode="sq8"))
        tq = tquant.build_quantizer(x, TQuant(mode="sq8"))
    js, ts = JStore(x, quant=jq), TStore(x, quant=tq)
    assert_stores_equal(js, ts)
    steps = [
        lambda s: s.add(more[:20]),                       # grows capacity
        lambda s: s.mark_dead(np.arange(0, 300, 7)),
        lambda s: s.add(more[20:50], ext_ids=np.arange(1000, 1030)),
        lambda s: s.mark_dead(np.array([1001, 1005, 3])),
        lambda s: s.compact(),
        lambda s: s.add(more[50:]),
        lambda s: s.mark_dead(np.array([2, 1010])),
    ]
    for step in steps:
        jr, tr = step(js), step(ts)
        if hasattr(jr, "remap"):
            np.testing.assert_array_equal(tr.remap, jr.remap)
            assert tr.dropped == jr.dropped
        else:
            np.testing.assert_array_equal(np.asarray(tr), np.asarray(jr))
        assert_stores_equal(js, ts)
    np.testing.assert_array_equal(ts.to_internal([1000, 1029]),
                                  js.to_internal([1000, 1029]))
    with pytest.raises(ValueError, match="tombstoned"):
        ts.mark_dead(np.array([2]))
    with pytest.raises(ValueError, match="already in use"):
        ts.add(more[:1], ext_ids=np.array([1000]))
    # the same sequence on tiered stores: rows and codes in block files,
    # growth resizing them and re-keying the caches
    if mode == "sq8":
        jq = jquant.build_quantizer(x, JQuant(mode="sq8"))
        tq = tquant.build_quantizer(x, TQuant(mode="sq8"))
    tier = dict(mode="host", block_rows=16, cache_frac=0.25)
    js = JStore(x, quant=jq, tier=JTier(dir=str(tmp_path / "j"), **tier))
    ts = TStore(x, quant=tq, tier=TTier(dir=str(tmp_path / "t"), **tier))
    assert js.tiered and ts.tiered
    for step in steps:
        jr, tr = step(js), step(ts)
        if hasattr(jr, "remap"):
            np.testing.assert_array_equal(tr.remap, jr.remap)
        assert_stores_equal(js, ts)
        assert len(ts.tier_caches()) == len(js.tier_caches())
        for jc, tc in zip(js.tier_caches(), ts.tier_caches()):
            assert (tc.name, tc.counters) == (jc.name, jc.counters)
            np.testing.assert_array_equal(tc._map, jc._map)


def test_store_arrays_cross_load():
    x = make_clustered(n=200, d=12, clusters=6, seed=6)
    js = JStore(x)
    js.add(x[:9])
    js.mark_dead(np.arange(0, 200, 11))
    ts = TStore.from_arrays(js.to_arrays())
    assert_stores_equal(js, ts, epochs=False)
    back = JStore.from_arrays(ts.to_arrays())
    assert_stores_equal(back, ts, epochs=False)


# ---------------------------------------------------------------- tenants
def test_convert_carries_every_tenant(mt_pair):
    dqf, _, arrays = mt_pair
    port = port_of(arrays)
    assert port.tenants.names() == dqf.tenants.names()
    for jt in dqf.tenants:
        tt = port.tenants.get(jt.name)
        assert tt.slot == jt.slot
        np.testing.assert_array_equal(tt.counter.counts, jt.counter.counts)
        assert tt.counter.since_rebuild == jt.counter.since_rebuild
        if jt.hot is None:
            assert tt.hot is None
        else:
            np.testing.assert_array_equal(tt.hot.ids, jt.hot.ids)
            np.testing.assert_array_equal(tt.hot.graph.adj, jt.hot.graph.adj)
            assert tt.hot.version == jt.hot.version


def test_stacked_tables_byte_equal_reference(mt_pair):
    dqf, _, arrays = mt_pair
    port = port_of(arrays)
    want = dqf.tenants.stacked(dqf.store)
    got = port.tenants.stacked(port.store)
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    assert (got.t_pad, got.h_pad) == (want.t_pad, want.h_pad)


def test_stacked_incremental_update_matches_full_rebuild(mt_pair):
    _, _, arrays = mt_pair
    port = port_of(arrays)
    reg, store = port.tenants, port.store
    before = [t.clone() for t in reg.stacked(store)]
    port.rebuild_hot(hot_ids=port.tenants.get("t2").hot.ids[::-1].copy(),
                     tenant="t2")
    incr = reg.stacked(store)                 # incremental path
    full = reg._build_stack(store, *reg._stack_key[0])
    for got, want in zip(incr, full):
        assert torch.equal(got, want)
    other = reg.slot_of("t1")
    assert torch.equal(before[2][other], incr.ids[other])
    assert not torch.equal(before[2][reg.slot_of("t2")],
                           incr.ids[reg.slot_of("t2")])


@pytest.mark.parametrize("mode,fused", [("graph", False), ("graph", True),
                                        ("mxu", False)],
                         ids=["graph", "graph-fused", "mxu"])
def test_hot_phase_stacked_matches_reference(mt_pair, mode, fused):
    dqf, wls, arrays = mt_pair
    port = port_of(arrays)
    stk_j = dqf.tenants.stacked(dqf.store)
    stk_t = port.tenants.stacked(port.store)
    rng = np.random.default_rng(8)
    tidx = rng.integers(0, TENANTS + 1, 120).astype(np.int32)
    q = np.concatenate([wls[max(t - 1, 0)].sample(1) for t in tidx])
    kw = dict(pool_size=CFG.hot_pool, max_hops=CFG.max_hops, mode=mode)
    jpool, jstats = j_stacked(stk_j.x, stk_j.adj, stk_j.entries,
                              stk_j.mask, jnp.asarray(tidx),
                              jnp.asarray(q), **kw)
    tpool, tstats = t_stacked(stk_t.x, stk_t.adj, stk_t.entries,
                              stk_t.mask, torch.as_tensor(tidx),
                              torch.as_tensor(q), fused=fused, **kw)
    bad = ~(np.asarray(jpool.ids) == tpool.ids.numpy()).all(1)
    bad |= ~np.isclose(np.asarray(jpool.dists), tpool.dists.numpy(),
                       rtol=1e-5, atol=1e-5).all(1)
    for f in ("dist_count", "hops", "update_count"):
        bad |= np.asarray(getattr(jstats, f)) != getattr(tstats, f).numpy()
    lanes = np.flatnonzero(bad).tolist()
    assert len(lanes) <= MAX_DIVERGENT * len(tidx), \
        f"{len(lanes)} lanes diverge from the reference: {lanes}"
    cold = tidx == 0                          # the default tenant is cold
    assert cold.any() and bool((tpool.ids.numpy()[cold]
                                == stk_t.h_pad).all())


def test_lane_views_equal_per_lane_tables(mt_pair):
    """The stacked hot phase's ``LaneTable`` views, composed and through
    the fused hop's per-lane table base, ≡ the reference's materialized
    per-lane ``(B, H+1, ·)`` tables and ``(B, E)`` entries, bit for bit,
    through the port's own composed beam search."""
    _, wls, arrays = mt_pair
    port = port_of(arrays)
    stk = port.tenants.stacked(port.store)
    rng = np.random.default_rng(3)
    tidx = torch.as_tensor(rng.integers(0, TENANTS + 1, 40))
    q = torch.as_tensor(wls[1].sample(40))
    x, adj = stk.x[tidx], stk.adj[tidx]
    state = tbs.init_state(x, q, stk.entries[tidx], CFG.hot_pool)
    state = tbs.beam_loop(x, adj, q, state, CFG.max_hops)
    for fused in (False, True):
        pool, stats = t_stacked(stk.x, stk.adj, stk.entries, stk.mask, tidx,
                                q, pool_size=CFG.hot_pool,
                                max_hops=CFG.max_hops, fused=fused)
        for a, b in zip(tuple(pool) + tuple(stats),
                        tuple(state.pool) + tuple(state.stats)):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), fused


@pytest.mark.parametrize("tenant", ["t0", "t2"])
def test_tenant_search_matches_reference(mt_pair, tenant):
    dqf, wls, arrays = mt_pair
    port = port_of(arrays)
    q = wls[int(tenant[1])].sample(150)
    assert_lanes_match(dqf.search(q, record=False, tenant=tenant),
                       port.search(q, record=False, tenant=tenant))
    with pytest.raises(RuntimeError, match="hot index missing"):
        port.search(q, tenant="default")


def test_tenant_lifecycle_matches_reference(mt_pair):
    dqf, _, arrays = mt_pair
    port = port_of(arrays)
    jreg = JDQF(CFG).build(make_clustered(n=120, d=8, clusters=4)).tenants
    treg = port.tenants
    for reg in (jreg, treg):
        for name in ("t0", "t1", "t2"):
            if name not in reg:
                reg.create(name)
        reg.evict("t1")
        reg.create("x")                          # reuses t1's slot
        reg.create("y")
        reg.evict("x")
        reg.create("t1")
    for name in ("default", "t0", "t2", "y", "t1"):
        assert treg.slot_of(name) == jreg.slot_of(name), name
    assert treg.get("t1").gen > treg.get("y").gen
    with pytest.raises(ValueError, match="default"):
        treg.evict("default")
    with pytest.raises(KeyError, match="unknown tenant"):
        treg.get("x")
    with pytest.raises(ValueError, match="already exists"):
        treg.create("y")


def test_scrape_keys_equal_reference(mt_pair):
    dqf, _, arrays = mt_pair
    port = port_of(arrays)
    want, got = dqf.scrape(), port.scrape()
    assert sorted(got) == sorted(want)
    for key in want:
        if key.startswith(("tenant", "store_")):
            assert got[key] == want[key], key
