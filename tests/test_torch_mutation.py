"""Port of the mutable index and its checkpoints against the JAX package.

* The host-side graph maintenance (``greedy_search_host``,
  ``_reprune_row``, ``_angle_keep``, ``link_new_rows``,
  ``patch_dead_edges``, ``compact_adjacency``, ``repair_free_adjacency``)
  and the preference fan-out (``QueryCounter.grow``/``remap``,
  ``TenantState.remap_hot``, ``TenantRegistry.grow``/``remap``/
  ``hot_tenants_containing``) on the same numpy inputs in both packages:
  outputs equal bit for bit.
* A reference ``DQF`` and its port twin (``dqf_from_arrays`` of the
  reference's checkpoint), float32 and sq8, through insert → delete →
  compact: after each step the external ids, the full adjacency, the
  entries, the remap, the counters and the hot ids are equal, the rebuilt
  hot graph has at least 0.99 of its rows identical, and the port's search
  over the reference's re-carried state equals the reference's (ids, hops,
  dist_count, terminated_early; dists within rtol 1e-5).
* Checkpoints across packages: each package's ``save`` loads in the
  other's ``load`` and searches the same; every refusal of ``load``
  raises; the save is staged and published by one rename.

The port's own scenarios (``tests/test_store_mutation.py``'s, and the
paged engine's churn and growth cases) are in
``tests/test_torch_mutation_churn.py``, whose ``churn_world`` the
checkpoint tests here share.
"""

import os

import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.core import DQF as JDQF
from repro.core import DQFConfig as JConfig
from repro.core import QuantConfig as JQuant
from repro.core import ZipfWorkload
from repro.core import hot_index as jhot
from repro.core import ssg as jssg
from repro.tenancy import TenantRegistry as JRegistry
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import DQF, QuantConfig
from repro_torch.core import hot_index as thot
from repro_torch.core import ssg as tssg
from repro_torch.tenancy import TenantRegistry as TRegistry
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.conftest import make_clustered
from tests.test_torch_mutation_churn import churn_world  # noqa: F401
from tests.test_torch_search import port_cfg

CFG = JConfig(knn_k=10, out_degree=10, index_ratio=0.03, k=10, hot_pool=16,
              full_pool=32, max_hops=100, n_query_trigger=10 ** 6)
SQ8 = dict(mode="sq8", rerank_k=32)


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _saved(dqf, path) -> str:
    """``dqf.save`` (either package); the file it wrote (``.npz`` is
    appended when missing)."""
    dqf.save(str(path))
    return str(path) if str(path).endswith(".npz") else f"{path}.npz"


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """A reference float32 DQF with hot index and tree, saved; and an sq8
    twin of the checkpoint (the reference's sq8 codes of the same rows)."""
    x = make_clustered(n=1200, d=16, clusters=16, seed=11)
    dqf = JDQF(CFG).build(x)
    wl = ZipfWorkload(x, seed=12)
    _, t = wl.sample(3000, with_targets=True)
    dqf.counter.record(t)
    dqf.rebuild_hot()
    dqf.fit_tree(wl.sample(300))
    d = tmp_path_factory.mktemp("mut")
    f32 = d / "f32.npz"
    dqf.save(str(f32))
    arrays = _arrays(f32)
    arrays.update(jquant.build_quantizer(x, JQuant(**SQ8)).to_arrays())
    sq8 = d / "sq8.npz"
    np.savez(sq8, **arrays)
    return x, wl, {"f32": str(f32), "sq8": str(sq8)}


def _pair(ref_ckpt, mode):
    """A fresh reference DQF (both stores at epoch 0) and its port twin."""
    x, wl, paths = ref_ckpt
    jcfg = CFG if mode == "f32" else \
        JConfig(**{**CFG.__dict__, "quant": JQuant(**SQ8)})
    tcfg = port_cfg(CFG) if mode == "f32" else \
        port_cfg(CFG, quant=QuantConfig(**SQ8))
    ref = JDQF.load(paths[mode], jcfg)
    port = dqf_from_arrays(_arrays(paths[mode]), tcfg, device="cpu")
    assert ref.store.epoch == port.store.epoch == 0
    return ref, port, tcfg


# ------------------------------------------------------------ host helpers
def _free_slot_world(seed=3, n=300, d=12, R=8):
    """Rows and a free-slot (-1) adjacency with some short rows."""
    rng = np.random.default_rng(seed)
    x = make_clustered(n=n, d=d, clusters=6, seed=seed)
    adj = np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
    adj = adj.astype(np.int32)
    adj[rng.random((n, R)) < 0.2] = -1
    adj = np.take_along_axis(adj, np.argsort(adj < 0, axis=1,
                                             kind="stable"), 1)
    return x, np.ascontiguousarray(adj), rng


def test_angle_keep_matches_reference():
    rng = np.random.default_rng(0)
    cos_a = np.cos(np.deg2rad(60.0))
    for d in (3, 16):          # d = 3: many pairs near the angle threshold
        vec = rng.standard_normal((400, d)).astype(np.float32)
        dist = np.einsum("cd,cd->c", vec, vec)
        order = np.argsort(dist, kind="stable")
        vec, dist = vec[order], dist[order]
        for R in (4, 10, 200):
            assert tssg._angle_keep(vec, dist, R, cos_a) == \
                jssg._angle_keep(vec, dist, R, cos_a)


@pytest.mark.parametrize("tombstones", [False, True])
def test_greedy_search_host_matches_reference(tombstones):
    x, adj, rng = _free_slot_world()
    alive = None
    if tombstones:
        alive = rng.random(x.shape[0]) > 0.2
    for i in range(8):
        q = x[rng.integers(x.shape[0])] + 0.1 * i
        ent = rng.choice(x.shape[0], 4, replace=False)
        kw = dict(pool_size=24, max_hops=64, alive=alive)
        np.testing.assert_array_equal(
            tssg.greedy_search_host(x, adj, ent, q, **kw),
            jssg.greedy_search_host(x, adj, ent, q, **kw))


def test_reprune_row_matches_reference():
    x, adj, rng = _free_slot_world()
    params_t = tssg.SSGParams(out_degree=8, candidate_cap=30)
    params_j = jssg.SSGParams(out_degree=8, candidate_cap=30)
    a, b = adj.copy(), adj.copy()
    for p in rng.choice(x.shape[0], 20, replace=False):
        cand = np.concatenate([rng.integers(-1, x.shape[0], 60), [p]])
        tssg._reprune_row(x, a, int(p), cand, params_t)
        jssg._reprune_row(x, b, int(p), cand, params_j)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tombstones", [False, True])
def test_link_new_rows_matches_reference(tombstones):
    x, adj, rng = _free_slot_world(n=340)
    n0 = 300
    adj[adj >= n0] = -1
    adj[n0:] = -1
    adj = np.ascontiguousarray(np.take_along_axis(
        adj, np.argsort(adj < 0, axis=1, kind="stable"), 1))
    alive = np.ones(x.shape[0], bool)
    if tombstones:
        alive[rng.choice(n0, 30, replace=False)] = False
    ent = np.flatnonzero(alive[:n0])[:4]
    a, b = adj.copy(), adj.copy()
    kw = dict(alive=alive if tombstones else None)
    tssg.link_new_rows(x, a, np.arange(n0, 340),
                       tssg.SSGParams(knn_k=8, out_degree=8), ent, **kw)
    jssg.link_new_rows(x, b, np.arange(n0, 340),
                       jssg.SSGParams(knn_k=8, out_degree=8), ent, **kw)
    np.testing.assert_array_equal(a, b)
    assert (a[n0:] >= 0).any(axis=1).all()      # every new row linked


def test_patch_dead_edges_matches_reference():
    x, adj, rng = _free_slot_world()
    alive = np.ones(x.shape[0], bool)
    dead = rng.choice(x.shape[0], 40, replace=False)
    alive[dead] = False
    a, b = adj.copy(), adj.copy()
    tssg.patch_dead_edges(x, a, dead, alive)
    jssg.patch_dead_edges(x, b, dead, alive)
    np.testing.assert_array_equal(a, b)
    live_rows = a[alive]
    assert not np.isin(live_rows[live_rows >= 0], dead).any()


def test_compact_adjacency_and_repair_match_reference():
    x, adj, rng = _free_slot_world()
    keep = rng.random(x.shape[0]) > 0.3
    remap = np.full(x.shape[0], -1, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    got = tssg.compact_adjacency(adj, remap)
    want = jssg.compact_adjacency(adj, remap)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    xs = np.ascontiguousarray(x[keep])
    # the compaction leaves orphans: the repair must reach them all
    entry = int(np.argmax((got >= 0).sum(axis=1)))
    rep_t = tssg.repair_free_adjacency(xs, got, entry)
    rep_j = jssg.repair_free_adjacency(xs, got, entry)
    np.testing.assert_array_equal(rep_t, rep_j)
    assert not np.array_equal(rep_t, got)
    seen = np.zeros(xs.shape[0], bool)
    tssg._bfs(np.where(rep_t < 0, xs.shape[0], rep_t), seen,
              np.array([entry]))
    assert seen.all()


def test_counter_grow_and_remap_match_reference():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (40, 4))
    cs = [m.QueryCounter(n=50, trigger=10) for m in (thot, jhot)]
    for c in cs:
        c.record(ids)
        c.grow(64)
    remap = np.full(64, -1, np.int64)
    keep = rng.random(64) > 0.25
    remap[keep] = np.arange(int(keep.sum()))
    for c in cs:
        c.remap(remap)
    t, j = cs
    np.testing.assert_array_equal(t.counts, j.counts)
    assert (t.n, t.since_rebuild, t.due) == (j.n, j.since_rebuild, j.due)
    # the surviving rows keep their mass exactly; the clock keeps running
    assert t.counts.sum() == np.bincount(ids.ravel(), minlength=64)[
        keep].sum()
    assert t.since_rebuild == 40
    with pytest.raises(ValueError):
        t.grow(10)


def _registries(n=60):
    """Both packages' registries with the same three tenants' counters and
    hot ids (hot graphs are not needed by the fan-out)."""
    regs = [TRegistry(n, trigger=5), JRegistry(n, trigger=5)]
    rng = np.random.default_rng(2)
    recs = [rng.integers(0, n, (30, 3)) for _ in range(3)]
    hot = [rng.choice(n, 8, replace=False).astype(np.int32)
           for _ in range(3)]
    for reg, mod in zip(regs, (thot, jhot)):
        for i, name in enumerate(("default", "a", "b")):
            t = reg.get(name) if name == "default" else reg.create(name)
            t.counter.record(recs[i])
            g = mod.SSGIndex(adj=np.zeros((8, 2), np.int32),
                             entries=np.zeros(1, np.int32), n=8)
            t.set_hot(mod.HotIndex(graph=g, ids=hot[i], build_seconds=0.0))
    return regs, hot


def test_remap_hot_matches_reference():
    (treg, jreg), hot = _registries()
    remap = np.arange(60, dtype=np.int64)[::-1].copy()
    dropped = remap.copy()
    dropped[hot[1][0]] = -1
    for name, r in (("default", remap), ("a", dropped)):
        t, j = treg.get(name), jreg.get(name)
        before = t.hot_token
        assert t.remap_hot(r) == j.remap_hot(r)
        np.testing.assert_array_equal(t.hot.ids, j.hot.ids)
        assert t.hot.ids.dtype == np.int32
        assert (t.hot_token - before, t.hot_token) == \
            (int(r is remap), j.hot_token)
    assert treg.get("a").remap_hot(dropped) is False


def test_registry_fanout_matches_reference():
    (treg, jreg), hot = _registries()
    probe = np.array([hot[1][3], 59, 58])
    assert treg.hot_tenants_containing(probe) == \
        jreg.hot_tenants_containing(probe)
    for reg in (treg, jreg):
        reg.grow(70)
    keep = np.ones(70, bool)
    keep[[hot[2][0], 5, 66]] = False
    remap = np.full(70, -1, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    assert treg.remap(remap) == jreg.remap(remap)
    for name in ("default", "a", "b"):
        t, j = treg.get(name), jreg.get(name)
        np.testing.assert_array_equal(t.counter.counts, j.counter.counts)
        np.testing.assert_array_equal(t.hot.ids, j.hot.ids)
    assert treg._n == jreg._n == 67
    assert treg.create("c").counter.n == 67


def test_stacked_rekeys_on_growth_and_remap(ref_ckpt):
    """The stacked tables follow capacity growth and remapped hot ids: the
    incremental stack equals a full restack after each."""
    x, wl, _ = ref_ckpt
    _, port, _ = _pair(ref_ckpt, "f32")
    q, tg = ZipfWorkload(x, seed=77).sample(600, with_targets=True)
    port.warm(q, tg, tenant="b")
    reg = port.tenants
    reg.stacked(port.store)

    def check():
        incr = reg.stacked(port.store)
        full = reg._build_stack(port.store, *reg._stack_key[0])
        for got, want in zip(incr, full):
            assert torch.equal(got, want)
        return incr

    port.insert(x[:40] + 0.01)
    grown = check()
    assert int(grown.ids.max()) == port.store.capacity == 2048
    live = port.store.live_ids()
    dead = np.setdiff1d(live[::7], np.concatenate(
        [t.hot.ids for t in reg]))                    # no hot row dies
    port.delete(port.store.to_external(dead))
    port.compact()
    remapped = check()
    slot = reg.slot_of("b")
    h = reg.get("b").hot.size
    np.testing.assert_array_equal(remapped.ids[slot, :h].numpy(),
                                  reg.get("b").hot.ids)
    np.testing.assert_array_equal(
        remapped.x[slot, :h].numpy(), port.store.x[reg.get("b").hot.ids])


# ------------------------------------------------------ DQF against the JAX
def _assert_same_search(ref, port_state, q):
    """The reference's searches against the port's over the reference's
    re-carried state: ids, hops, dist_count, terminated_early equal; dists
    within rtol 1e-5."""
    pairs = ((ref.search(q, record=False), port_state.search(q, record=False)),
             (ref.search_baseline(q), port_state.search_baseline(q)))
    for want, got in pairs:
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-5, atol=0)
        for f in ("dist_count", "hops", "terminated_early"):
            np.testing.assert_array_equal(
                getattr(got.stats, f).numpy(),
                np.asarray(getattr(want.stats, f)), err_msg=f)


def _assert_same_state(ref, port):
    np.testing.assert_array_equal(port.store.ext_ids, ref.store.ext_ids)
    np.testing.assert_array_equal(port.store.alive, ref.store.alive)
    assert (port.store.capacity, port.store.next_ext, port.store.epoch) == \
        (ref.store.capacity, ref.store.next_ext, ref.store.epoch)
    np.testing.assert_array_equal(port.full.adj, ref.full.adj)
    assert port.full.adj.dtype == ref.full.adj.dtype
    np.testing.assert_array_equal(port._adj_buf, ref._adj_buf)
    np.testing.assert_array_equal(port.full.entries, ref.full.entries)
    np.testing.assert_array_equal(port.counter.counts, ref.counter.counts)
    assert port.counter.since_rebuild == ref.counter.since_rebuild
    np.testing.assert_array_equal(port.hot.ids, ref.hot.ids)
    assert port.hot.version == ref.hot.version
    same_rows = (port.hot.graph.adj == ref.hot.graph.adj).all(axis=1)
    assert same_rows.mean() >= 0.99, same_rows.mean()


@pytest.mark.parametrize("mode", ["f32", "sq8"])
def test_dqf_sequence_matches_reference(ref_ckpt, mode, tmp_path):
    x, wl, _ = ref_ckpt
    ref, port, tcfg = _pair(ref_ckpt, mode)
    rng = np.random.default_rng(0)
    q = wl.sample(64)
    new = x[rng.choice(x.shape[0], 40)] \
        + 0.02 * rng.standard_normal((40, x.shape[1])).astype(np.float32)
    hot_before = ref.hot.ids.copy()
    live = ref.store.live_ids()
    victims = np.concatenate([rng.choice(live, 55, replace=False),
                              hot_before[:5]])
    steps = (("insert", lambda d: d.insert(new)),
             ("delete", lambda d: d.delete(d.store.to_external(victims))),
             ("compact", lambda d: d.compact()))
    for name, step in steps:
        want, got = step(ref), step(port)
        if name == "insert":
            np.testing.assert_array_equal(got, want)
        elif name == "delete":
            assert got == want == victims.size
            assert ref.hot.version == 1             # the hot rebuild ran
        else:
            np.testing.assert_array_equal(got["remap"], want["remap"])
            assert (got["dropped"], got["n"]) == \
                (want["dropped"], want["n"])
        _assert_same_state(ref, port)
        carried = dqf_from_arrays(_arrays(_saved(ref, tmp_path / name)),
                                  tcfg, device="cpu")
        _assert_same_search(ref, carried, q)
    assert port.store.capacity == 2048 and port.store.n == 1240 - 60
    np.testing.assert_array_equal(
        port.to_external(np.array([[0, port.store.n, -1]])),
        ref.to_external(np.array([[0, ref.store.n, -1]])))


# ------------------------------------------------ checkpoints across packages
@pytest.mark.parametrize("mode", ["f32", "sq8"])
def test_checkpoints_load_across_packages(ref_ckpt, mode, tmp_path):
    """A churned port DQF saved by the port loads in the reference, and the
    reference's save of the same state loads in ``DQF.load``: each searches
    as its source does."""
    x, wl, _ = ref_ckpt
    ref, port, tcfg = _pair(ref_ckpt, mode)
    qb, tb = ZipfWorkload(x, seed=77).sample(400, with_targets=True)
    for d in (ref, port):
        d.warm(qb, tb, tenant="b")
        d.insert(x[:30] + 0.05)
        d.delete(d.store.to_external(np.arange(0, 600, 9)))
    q = wl.sample(48)
    from_port = JDQF.load(_saved(port, tmp_path / "p"), ref.cfg)
    from_ref = DQF.load(_saved(ref, tmp_path / "r.npz"), tcfg,
                        device="cpu")
    for a, b in ((from_port, ref), (from_ref, port)):
        np.testing.assert_array_equal(a.full.adj, b.full.adj)
        np.testing.assert_array_equal(a.store.ext_ids, b.store.ext_ids)
        assert a.store.next_ext == b.store.next_ext
        assert a.tenants.names() == b.tenants.names() == ["default", "b"]
        for name in ("default", "b"):
            ta, tb_ = a.tenants.get(name), b.tenants.get(name)
            np.testing.assert_array_equal(ta.counter.counts,
                                          tb_.counter.counts)
            np.testing.assert_array_equal(ta.hot.ids, tb_.hot.ids)
            np.testing.assert_array_equal(ta.hot.graph.adj,
                                          tb_.hot.graph.adj)
        assert (a.quant is None) == (mode == "f32")
    _assert_same_search(from_port, port, q)
    _assert_same_search(ref, from_ref, q)


@pytest.mark.parametrize("wrong", ["dim", "metric", "quant absent",
                                   "quant mode", "pq shape"])
def test_load_refusals(ref_ckpt, tmp_path, wrong):
    """Each contract mismatch the reference's load refuses, the port's
    refuses too (through ``DQF.load`` and ``dqf_from_arrays`` alike)."""
    x, _, paths = ref_ckpt
    arrays = _arrays(paths["f32"])
    quant = {"quant absent": QuantConfig(**SQ8),
             "quant mode": QuantConfig(mode="pq", pq_m=4),
             "pq shape": QuantConfig(mode="pq", pq_m=8)}.get(wrong)
    over = {} if quant is None else {"quant": quant}
    if wrong == "dim":
        over["dim"] = 8
    elif wrong == "metric":
        arrays["metric"] = np.array("ip")   # a checkpoint of another metric
    elif wrong != "quant absent":
        saved = "sq8" if wrong == "quant mode" else "pq"
        arrays.update(jquant.build_quantizer(
            x, JQuant(mode=saved, pq_m=4, pq_iters=2)).to_arrays())
    path = str(tmp_path / "wrong.npz")
    np.savez(path, **arrays)
    jover = dict(over)
    if quant is not None:
        jover["quant"] = JQuant(mode=quant.mode, pq_m=quant.pq_m,
                                rerank_k=quant.rerank_k)
    with pytest.raises(ValueError):
        JDQF.load(path, JConfig(**{**CFG.__dict__, **jover}))
    cfg = port_cfg(CFG, **over)
    with pytest.raises(ValueError):
        DQF.load(path, cfg, device="cpu")
    with pytest.raises(ValueError):
        dqf_from_arrays(arrays, cfg, device="cpu")


def test_load_runs_on_the_card_by_default(ref_ckpt):
    _, _, paths = ref_ckpt
    if torch.cuda.is_available():
        assert DQF.load(paths["f32"], port_cfg(CFG)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DQF.load(paths["f32"], port_cfg(CFG))
    assert DQF.load(paths["f32"], port_cfg(CFG),
                    device="cpu").device.type == "cpu"


def test_save_publishes_by_one_rename(churn_world, tmp_path, monkeypatch):
    """A crash before the commit leaves the old checkpoint whole and no
    staging directory behind."""
    dqf = churn_world[0]
    p = tmp_path / "ckpt.npz"
    dqf.save(str(p))
    before = p.read_bytes()

    def crash(*a):
        raise OSError("crash before commit")

    monkeypatch.setattr(os, "replace", crash)
    dqf.insert(np.ones((1, 16), np.float32))
    with pytest.raises(OSError, match="before commit"):
        dqf.save(str(p))
    assert p.read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["ckpt.npz"]


def test_index_nbytes_exposition_and_bundle(churn_world, tmp_path):
    dqf = churn_world[0]
    assert dqf.index_nbytes() == dqf.memory_report()
    assert "store_rows_inserted_total" in dqf.exposition()
    out = dqf.debug_bundle(str(tmp_path / "b"), reason="test")
    files = set(os.listdir(out))
    assert {"scrape.json", "exposition.prom", "MANIFEST.json"} <= files


def test_streaming_updates_example_runs_on_cpu(capsys):
    from repro_torch.examples import streaming_updates

    streaming_updates.main(["--device", "cpu", "--n", "600", "--rounds",
                            "2"])
    out = capsys.readouterr().out
    assert "dead-in-results=0" in out and "handles survive" in out
