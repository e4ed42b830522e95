"""Port index build against the JAX package's build, on the same data.

The port's build is batched tensor code; the reference's is per-node
numpy.  Their float32 sums run in different orders, so near-ties may fall
differently: each stage states its own tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import knng as jknng
from repro.core import ssg as jssg
from repro.core.decision_tree import predict_jax
from repro.core.recall import ground_truth as j_ground_truth
from repro_torch.core import DQF as TDQF
from repro_torch.core import DQFConfig as TConfig
from repro_torch.core import ZipfWorkload as TZipf
from repro_torch.core import knng as tknng
from repro_torch.core import ssg as tssg
from repro_torch.core.decision_tree import predict, tree_arrays
from repro_torch.core.recall import ground_truth, recall_at_k
from tests.conftest import make_clustered
from tests._torch_threads import one_torch_thread  # noqa: F401


def rows_identical(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).all(axis=1).mean())


@pytest.fixture(scope="module")
def data():
    return make_clustered(n=1500)


@pytest.fixture(scope="module")
def knn_graph(data):
    return jknng.exact_knn(data, 12)[0]


def test_exact_knn_matches_reference(data, knn_graph):
    got, d = tknng.exact_knn(data, 12)
    assert rows_identical(got, knn_graph) >= 0.99
    assert d.shape == (1500, 12) and np.all(np.diff(d, axis=1) >= -1e-3)


def test_reverse_sample_exactly_equal(knn_graph):
    n, k = knn_graph.shape
    ids = knn_graph.astype(np.int64)
    want = jknng._reverse_sample(ids, n, 5, np.random.default_rng(3))
    got = tknng._reverse_sample(torch.as_tensor(ids), n, 5,
                                np.random.default_rng(3))
    np.testing.assert_array_equal(got.numpy(), want)


def test_nn_descent_matches_reference(data):
    want = jknng.build_knng(data, 12, exact_threshold=0, seed=4)
    got = tknng.build_knng(data, 12, exact_threshold=0, seed=4)
    assert got.shape == want.shape and got.dtype == np.int32
    assert rows_identical(got, want) >= 0.99


def test_ssg_prune_matches_reference(data, knn_graph):
    params = jssg.SSGParams(knn_k=12, out_degree=12)
    want = jssg.ssg_prune(data, knn_graph, params)
    got = tssg.ssg_prune(data, knn_graph,
                         tssg.SSGParams(**dataclasses.asdict(params)))
    assert rows_identical(got, want) >= 0.99


@pytest.mark.parametrize("R", [4, 12])
def test_ensure_connected_reaches_every_node(data, knn_graph, R):
    adj = tssg.ssg_prune(data, knn_graph,
                         tssg.SSGParams(knn_k=12, out_degree=R))
    fixed = tssg.ensure_connected(data, adj, 0)
    seen = np.zeros(1500, bool)
    tssg._bfs(fixed.astype(np.int64), seen, np.array([0]))
    assert seen.all()
    if R == 12:
        # rows stay the reference's where no host row is full of repair
        # edges; nearest hosts come from a matmul expansion here and from
        # a numpy sum there, so a near-tie may pick another host
        want = jssg.ensure_connected(data, adj, 0)
        assert rows_identical(fixed, want) >= 0.99


def star_graph(orphans: int, R: int = 4, C: int = 20, d: int = 8):
    """A reachable ring of C nodes far from the origin (entry 0), a hub at
    the origin (id C, its row full of ring edges, reached from node 5),
    and ``orphans`` isolated nodes at ±e_i: the hub is every orphan's
    nearest reachable node, and orphans are farther from each other."""
    rng = np.random.default_rng(0)
    n = C + 1 + orphans
    x = np.zeros((n, d), np.float32)
    x[:C] = 10.0 * np.eye(d, dtype=np.float32)[0] \
        + 0.1 * rng.standard_normal((C, d)).astype(np.float32)
    axes = np.concatenate([np.eye(d), -np.eye(d)]).astype(np.float32)
    x[C + 1:] = axes[:orphans]
    adj = np.full((n, R), n, np.int32)
    ring = np.arange(C)
    adj[:C, 0], adj[:C, 1] = (ring + 1) % C, (ring - 1) % C
    adj[5, 2] = C
    adj[C] = [1, 2, 3, 4]
    return x, adj, C


def test_ensure_connected_evictions_match_reference():
    """As many orphans as the hub has slots: each evicts a ring edge, in
    the reference's order, and the port's graph is the reference's."""
    x, adj, _ = star_graph(orphans=4)
    want = jssg.ensure_connected(x, adj, 0)
    np.testing.assert_array_equal(tssg.ensure_connected(x, adj, 0), want)


def test_ensure_connected_repairs_where_reference_stalls():
    """Sixteen orphans share a hub of four slots.  The reference evicts a
    repair edge for each orphan past the fourth, re-orphaning another,
    and never converges; the port, once a round makes no progress, sends
    an orphan to its nearest reachable node that still has room."""
    x, adj, hub = star_graph(orphans=16)
    with pytest.raises(RuntimeError, match="did not converge"):
        jssg.ensure_connected(x, adj, 0)
    got = tssg.ensure_connected(x, adj, 0)
    assert jssg._reachable(got, 0).all()
    np.testing.assert_array_equal(got[:hub], adj[:hub])   # ring untouched
    added = got[got != adj]
    assert added.size and np.all(added > hub)             # orphans only
    assert np.all(got[hub] > hub)       # the hub's row is repair edges


def test_medoid_and_entries_match_reference(data, knn_graph):
    assert tssg.medoid(data) == jssg.medoid(data)
    p = dict(knn_k=12, out_degree=12)
    want = jssg.build_ssg(data, jssg.SSGParams(**p), knng=knn_graph)
    got = tssg.build_ssg(data, tssg.SSGParams(**p), knng=knn_graph)
    np.testing.assert_array_equal(got.entries, want.entries)
    assert rows_identical(got.adj, want.adj) >= 0.99


def test_ground_truth_matches_reference(data):
    q = TZipf(data, seed=2).sample(64)
    np.testing.assert_array_equal(ground_truth(data, q, 10),
                                  j_ground_truth(data, q, 10))


def test_port_build_recall_within_one_point(built_dqf, small_data):
    """The port's own build → warm → fit_tree, recall@10 against the
    reference's own build on the same data and the same queries."""
    ref, _ = built_dqf
    cfg = TConfig(**{f.name: getattr(ref.cfg, f.name)
                     for f in dataclasses.fields(TConfig)
                     if f.name != "quant"})
    port = TDQF(cfg, device="cpu").build(small_data)
    wl = TZipf(small_data, beta=1.2, sigma=0.05, seed=1)
    _, targets = wl.sample(4000, with_targets=True)
    port.counter.record(targets)
    port.rebuild_hot()
    port.fit_tree(wl.sample(400))
    np.testing.assert_array_equal(port.hot.ids, ref.hot.ids)
    q = TZipf(small_data, seed=5).sample(200)
    gt = ground_truth(small_data, q, 10)
    r_ref = recall_at_k(np.asarray(ref.search(q, record=False).ids), gt)
    r_port = recall_at_k(port.search(q, record=False).ids.numpy(), gt)
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert rows_identical(port.full.adj, ref.full.adj) >= 0.99


def test_tree_predict_matches_predict_jax(built_dqf):
    ref, _ = built_dqf
    arrays = ref.tree.arrays
    port = tree_arrays(*(np.asarray(a) for a in arrays))
    rng = np.random.default_rng(11)
    feats = np.abs(rng.standard_normal((500, 6)).astype(np.float32)) \
        * np.array([20, 1, 20, 1, 200, 20], np.float32)
    want = np.asarray(predict_jax(arrays, jnp.asarray(feats),
                                  ref.tree.depth))
    got = predict(port, torch.as_tensor(feats), ref.tree.depth).numpy()
    np.testing.assert_array_equal(got, want)
