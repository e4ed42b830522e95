"""Port search against the JAX package on the reference's own index.

The reference ``built_dqf`` (conftest) is saved with ``DQF.save`` and its
arrays are carried into the port by ``repro_torch.convert.dqf_from_arrays``.
Both packages then search the same graph, hot index and tree with the same
queries.  Ids, ``dist_count``, ``hops`` and ``terminated_early`` must match
per lane.  A lane may diverge only through a float32 near-tie (the port
sums squares in its own fixed order), so the tolerance is at most 1% of
lanes, and the diverging lanes are listed in the failure message.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ZipfWorkload
from repro.core import beam_search as jbs
from repro.core.dynamic_search import dynamic_search as j_dynamic
from repro.core.dynamic_search import hot_phase as j_hot
from repro.core.tree_training import collect_training_data as j_collect
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import DQFConfig as TConfig
from repro_torch.core import TierConfig as TTier
from repro_torch.core import beam_search as tbs
from repro_torch.core.dynamic_search import dynamic_search as t_dynamic
from repro_torch.core.dynamic_search import hot_phase as t_hot
from repro_torch.core.tree_training import collect_training_data as t_collect
from tests._torch_threads import one_torch_thread  # noqa: F401

MAX_DIVERGENT = 0.01


def port_cfg(cfg, **over):
    """The port's ``DQFConfig`` of a reference one (its quantizer dropped,
    its tier carried over as the port's ``TierConfig``)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(TConfig)
          if f.name not in ("quant", "tier")}
    kw["tier"] = TTier(**dataclasses.asdict(cfg.tier))
    kw.update(over)
    return TConfig(**kw)


@pytest.fixture(scope="module")
def saved(built_dqf, tmp_path_factory):
    dqf, _ = built_dqf
    path = tmp_path_factory.mktemp("ckpt") / "dqf.npz"
    dqf.save(str(path))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def queries(small_data):
    return ZipfWorkload(small_data, seed=5).sample(200)


def assert_lanes_match(ref, port, fields=("dist_count", "hops",
                                          "terminated_early"), atol=0.0):
    B = np.asarray(ref.ids).shape[0]
    bad = ~(np.asarray(ref.ids) == port.ids.cpu().numpy()).all(axis=1)
    bad |= ~np.isclose(np.asarray(ref.dists), port.dists.cpu().numpy(),
                       rtol=1e-5, atol=atol).all(axis=1)
    for f in fields:
        bad |= (np.asarray(getattr(ref.stats, f))
                != getattr(port.stats, f).cpu().numpy())
    lanes = np.flatnonzero(bad).tolist()
    assert len(lanes) <= MAX_DIVERGENT * B, \
        f"{len(lanes)}/{B} lanes diverge from the reference: {lanes}"
    return lanes


@pytest.mark.parametrize("fused", [False, True])
def test_beam_search_matches_reference(built_dqf, saved, queries, fused):
    dqf, _ = built_dqf
    port = dqf_from_arrays(saved, port_cfg(dqf.cfg), device="cpu")
    c = dqf.cfg
    want = jbs.beam_search(
        dqf._dev["x_pad"], dqf._dev["adj_pad"], dqf._dev["entries"],
        jnp.asarray(queries), pool_size=c.full_pool, k=c.k,
        max_hops=c.max_hops, live_pad=dqf._dev["live_pad"])
    got = tbs.beam_search(
        port._dev["x_pad"], port._dev["adj_pad"], port._dev["entries"],
        torch.as_tensor(queries), pool_size=c.full_pool, k=c.k,
        max_hops=c.max_hops, live_pad=port._dev["live_pad"], fused=fused)
    assert_lanes_match(want, got, ("dist_count", "hops"))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_tree", [False, True])
def test_dynamic_search_matches_reference(built_dqf, saved, queries, fused,
                                          with_tree):
    dqf, _ = built_dqf
    port = dqf_from_arrays(saved, port_cfg(dqf.cfg), device="cpu")
    c = dqf.cfg
    kw = dict(k=c.k, hot_pool_size=c.hot_pool, full_pool_size=c.full_pool,
              eval_gap=c.eval_gap, add_step=c.add_step,
              tree_depth=c.tree_depth, max_hops=c.max_hops)
    hd = dqf.tenants.default.hot_tables(dqf.store)
    want, want_hot, _ = j_dynamic(
        dqf._dev["x_pad"], dqf._dev["adj_pad"], hd["x_hot_pad"],
        hd["adj_hot_pad"], hd["hot_ids_pad"], hd["hot_entries"],
        dqf.tree.arrays if with_tree else None, jnp.asarray(queries),
        live_pad=dqf._dev["live_pad"], **kw)
    th = port.hot_tables()
    got, got_hot, _ = t_dynamic(
        port._dev["x_pad"], port._dev["adj_pad"], th["x_hot_pad"],
        th["adj_hot_pad"], th["hot_ids_pad"], th["hot_entries"],
        port.tree.arrays if with_tree else None, torch.as_tensor(queries),
        live_pad=port._dev["live_pad"], fused=fused, fused_hops=4, **kw)
    assert_lanes_match(want, got)
    np.testing.assert_array_equal(np.asarray(want_hot.dist_count),
                                  got_hot.dist_count.numpy())
    if with_tree:
        assert got.stats.terminated_early.any()


@pytest.mark.parametrize("fused", [False, True])
def test_whole_slice_after_checkpoint(built_dqf, saved, queries, fused):
    """DQF.save in the reference → dqf_from_arrays → DQF.search."""
    dqf, _ = built_dqf
    port = dqf_from_arrays(saved, port_cfg(dqf.cfg, fused=fused),
                           device="cpu")
    assert port.hot.size == dqf.hot.size
    np.testing.assert_array_equal(port.counter.counts, dqf.counter.counts)
    assert_lanes_match(dqf.search(queries, record=False),
                       port.search(queries, record=False))
    assert_lanes_match(dqf.search_dual_beam(queries),
                       port.search_dual_beam(queries))
    assert_lanes_match(dqf.search_baseline(queries),
                       port.search_baseline(queries), ("dist_count", "hops"))


@pytest.mark.parametrize("fused", [False, True])
def test_hot_phase_graph_matches_reference(built_dqf, saved, queries, fused):
    """The graph hot phase, composed or through the fused hop (one launch
    on the card), against the reference's ``hot_phase`` on its own hot
    index: pool ids, dists and counters per lane; the two port routes
    equal bit for bit."""
    dqf, _ = built_dqf
    port = dqf_from_arrays(saved, port_cfg(dqf.cfg), device="cpu")
    c = dqf.cfg
    hd = dqf.tenants.default.hot_tables(dqf.store)
    th = port.hot_tables()
    kw = dict(pool_size=c.hot_pool, max_hops=c.max_hops)
    jpool, jstats = j_hot(hd["x_hot_pad"], hd["adj_hot_pad"],
                          hd["hot_entries"], jnp.asarray(queries), **kw)
    q = torch.as_tensor(queries)
    args = (th["x_hot_pad"], th["adj_hot_pad"], th["hot_entries"], q)
    pool, stats = t_hot(*args, fused=fused, **kw)
    bad = ~(np.asarray(jpool.ids) == pool.ids.numpy()).all(1)
    bad |= ~np.isclose(np.asarray(jpool.dists), pool.dists.numpy(),
                       rtol=1e-5, atol=0).all(1)
    for f in ("dist_count", "hops", "update_count"):
        bad |= np.asarray(getattr(jstats, f)) != getattr(stats, f).numpy()
    lanes = np.flatnonzero(bad).tolist()
    assert len(lanes) <= MAX_DIVERGENT * len(queries), \
        f"{len(lanes)} lanes diverge from the reference: {lanes}"
    other, other_stats = t_hot(*args, fused=not fused, **kw)
    for a, b in zip(tuple(pool) + tuple(stats),
                    tuple(other) + tuple(other_stats)):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_search_records_into_counter(built_dqf, saved, queries):
    dqf, _ = built_dqf
    port = dqf_from_arrays(saved, port_cfg(dqf.cfg), device="cpu")
    before = port.counter.counts.sum()
    res = port.search(queries[:16])
    assert port.counter.counts.sum() == before + res.ids.numel()
    assert port.counter.since_rebuild == int(saved["counter_since"]) + 16


def test_fused_equals_composed_within_port(built_dqf, saved, queries):
    dqf, _ = built_dqf
    a = dqf_from_arrays(saved, port_cfg(dqf.cfg, fused=False), device="cpu")
    b = dqf_from_arrays(saved, port_cfg(dqf.cfg, fused=True, fused_hops=5),
                        device="cpu")
    ra, rb = a.search(queries, record=False), b.search(queries, record=False)
    assert torch.equal(ra.ids, rb.ids)
    assert torch.equal(ra.dists.view(torch.int32), rb.dists.view(torch.int32))
    for f in ra.stats._fields:
        assert torch.equal(getattr(ra.stats, f), getattr(rb.stats, f)), f


def test_tree_training_data_matches_reference(built_dqf, saved, queries):
    dqf, _ = built_dqf
    port = dqf_from_arrays(saved, port_cfg(dqf.cfg), device="cpu")
    c = dqf.cfg
    kw = dict(k=c.k, hot_pool_size=c.hot_pool, full_pool_size=c.full_pool,
              eval_gap=c.eval_gap, max_hops=c.max_hops)
    q = queries[:64]
    hd = dqf.tenants.default.hot_tables(dqf.store)
    jf, jl = j_collect(dqf._dev["x_pad"], dqf._dev["adj_pad"],
                       hd["x_hot_pad"], hd["adj_hot_pad"],
                       hd["hot_ids_pad"], hd["hot_entries"], q,
                       live_pad=dqf._dev["live_pad"], **kw)
    th = port.hot_tables()
    tf, tl = t_collect(port._dev["x_pad"], port._dev["adj_pad"],
                       th["x_hot_pad"], th["adj_hot_pad"],
                       th["hot_ids_pad"], th["hot_entries"], q,
                       live_pad=port._dev["live_pad"], **kw)
    assert tf.shape == jf.shape
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tf, jf, rtol=1e-5)
