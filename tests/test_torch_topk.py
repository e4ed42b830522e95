"""Port of the brute-force top-k scorer and the mxu hot phase, against the
JAX package.

* ``repro_torch.kernels.ref.fused_topk_l2`` ≡ ``repro.kernels.ref
  .fused_topk_l2`` on integer-valued data, where every sum is exact, so
  ids and dists are equal, ties (duplicated rows) and k > N included.
* The row split of ``csrc/fused_topk_l2.cu``: per-range top-k lists
  merged in (key, id) order equal ``ref.fused_topk_l2`` over all rows, bit
  for bit (ranges shorter than k, all rows equal, k > N); and its path for
  k > 448 (each range sorted whole, the lists merged in pairs by rank)
  emulated in plain torch, at k = 449, 1024, N and past N, with ties.
* On continuous data against ``fused_topk_l2_pallas(interpret=True)``, as
  ``tests/test_kernels.py`` runs it: ids equal, dists within rtol 1e-5
  (the port sums over d in index order, XLA in its own).
* ``hot_mode="mxu"`` ``dynamic_search`` against the reference's on the
  reference's own index: hot pools' ids equal; ids, counters and flags
  per lane, at most 1% of lanes diverging through a near-tie, listed.
  Result dists that come from the hot phase keep their expansion value,
  whose rounding error scales with ``|q|² + |x|²`` and not with the
  distance (a query next to a row has a tiny distance and a large
  cancellation), so dists are held within rtol 1e-5 plus an atol of
  1e-5 · max(|q|² + |x|²).
* The port's mxu recall ≥ its graph recall − 0.02, as
  ``tests/test_dqf_system.py`` holds the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.dynamic_search import dynamic_search as j_dynamic
from repro.core.dynamic_search import hot_phase as j_hot
from repro.kernels import ref as jref
from repro.kernels.fused_scorer import fused_topk_l2_pallas
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import DQF, DQFConfig, ZipfWorkload
from repro_torch.core.dynamic_search import dynamic_search as t_dynamic
from repro_torch.core.dynamic_search import hot_phase as t_hot
from repro_torch.core.recall import ground_truth, recall_at_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.test_torch_cuda import duplicated_rows, topk_rows
from tests.test_torch_search import (assert_lanes_match, port_cfg,  # noqa: F401
                                     queries, saved)
from tests._torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("B,N,k,d", [
    (5, 40, 10, 24), (4, 7, 12, 24), (33, 100, 7, 8), (1, 1, 1, 18),
    (64, 256, 32, 24), (3, 31, 64, 18)])
def test_topk_matches_jax_reference_exactly(B, N, k, d):
    rng = np.random.default_rng(N + k)
    x = rng.integers(-3, 4, (N, d)).astype(np.float32)
    if N > 3:
        x[N // 2:N // 2 + N // 4] = x[:N // 4]           # exact ties
    q = rng.integers(-3, 4, (B, d)).astype(np.float32)
    wd, wi = jref.fused_topk_l2(q, x, k=k)
    gd, gi = tref.fused_topk_l2(torch.as_tensor(q), torch.as_tensor(x), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32
    if k > N:
        assert (gi.numpy()[:, N:] == N).all()
        assert np.isinf(gd.numpy()[:, N:]).all()


@pytest.mark.parametrize("B,N,k,bq,bn", [
    (5, 40, 10, 8, 8), (33, 100, 7, 16, 32), (64, 256, 32, 32, 64),
    (4, 7, 12, 8, 8)])
def test_topk_matches_pallas_interpret(B, N, k, bq, bn):
    rng = np.random.default_rng(B * N)
    q = rng.standard_normal((B, 24)).astype(np.float32)
    x = rng.standard_normal((N, 24)).astype(np.float32)
    wd, wi = fused_topk_l2_pallas(q, x, k=k, bq=bq, bn=bn, interpret=True)
    gd, gi = tops.fused_topk_l2(torch.as_tensor(q), torch.as_tensor(x), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    finite = np.isfinite(np.asarray(wd))
    np.testing.assert_array_equal(finite, np.isfinite(gd.numpy()))
    np.testing.assert_allclose(gd.numpy()[finite], np.asarray(wd)[finite],
                               rtol=1e-5, atol=1e-3)


def test_topk_chunks_give_one_sort_order(monkeypatch):
    """The running merge over row chunks equals one stable sort."""
    x = torch.as_tensor(duplicated_rows(300, 18, 3))
    q = torch.as_tensor(np.random.default_rng(4).standard_normal((6, 18))
                        .astype(np.float32))
    q[0] = x[0]
    d2 = tref.pairwise_l2(q, x)
    order = torch.sort(d2, dim=1, stable=True).indices[:, :20]
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 6 * 7)   # 7-row chunks
    gd, gi = tref.fused_topk_l2(q, x, k=20)
    assert torch.equal(gi, order.to(torch.int32))
    assert torch.equal(gd, d2.gather(1, order))
    assert gi[0, 0] == 0 and gi[0, 1] == 150          # the tie, smaller id


def merge_row_ranges(q, x, k, P):
    """``csrc/fused_topk_l2.cu``'s split, in plain torch: the per-range
    ``ref.fused_topk_l2`` lists of P contiguous row ranges (ids offset, a
    short range's (+inf, n) padding dropped) merged by a stable sort in
    (key, id), then padded (+inf, N) past min(N, k)."""
    B, N = q.shape[0], x.shape[0]
    span = -(-N // P)
    keys, ids = [], []
    for lo in range(0, N, span):
        d, i = tref.fused_topk_l2(q, x[lo:lo + span], k=k)
        real = i < x[lo:lo + span].shape[0]
        keys.append(torch.where(real, d, torch.inf))
        ids.append(torch.where(real, i + lo, torch.iinfo(torch.int32).max))
    keys, ids = torch.cat(keys, 1), torch.cat(ids, 1)
    by_id = torch.sort(ids, dim=1, stable=True).indices
    keys, ids = keys.gather(1, by_id), ids.gather(1, by_id)
    by_key = torch.sort(keys, dim=1, stable=True).indices[:, :k]
    keys, ids = keys.gather(1, by_key), ids.gather(1, by_key)
    if keys.shape[1] < k:
        pad = k - keys.shape[1]
        keys = torch.cat([keys, torch.full((B, pad), torch.inf)], 1)
        ids = torch.cat([ids, torch.full((B, pad), N, dtype=torch.int32)], 1)
    ids = torch.where(ids == torch.iinfo(torch.int32).max, N, ids)
    return keys, ids


@pytest.mark.parametrize("B,N,k,d,P,equal", [
    (5, 300, 20, 18, 4, False),      # ranges longer than k
    (6, 100, 64, 24, 2, False),      # each range shorter than k
    (4, 50, 10, 8, 3, True),         # all rows equal: every key ties
    (3, 30, 40, 8, 3, False),        # k > N
    (7, 5003, 32, 128, 12, False)])  # the mxu shape's split, a ragged tail
def test_topk_row_ranges_merge_to_one_sort(B, N, k, d, P, equal):
    """The union of per-range top-k lists holds the global top-k, so
    merging them in (key, id) order is ``ref.fused_topk_l2`` bit for bit:
    the argument the kernel's row split rests on."""
    rng = np.random.default_rng(B + N + P)
    x = torch.as_tensor(topk_rows(N, d, N, equal))
    q = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32))
    q[0] = x[0]
    want_d, want_i = tref.fused_topk_l2(q, x, k=k)
    got_d, got_i = merge_row_ranges(q, x, k, P)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    if equal:
        assert torch.equal(got_i[:, :min(N, k)],
                           torch.arange(min(N, k), dtype=torch.int32)
                           .expand(B, -1))


INT_MAX = torch.iinfo(torch.int32).max


def range_rows(N, k):
    """``csrc/fused_topk_l2.cu::topk_range_rows``: the least power of two
    >= k and 1024, at most 8192, and no more than N needs."""
    c = 1024
    while c < k and c < 8192:
        c <<= 1
    while c > 32 and c // 2 >= N:
        c >>= 1
    return c


def rank_pairs(lists, k):
    """One round of the merge launch: list l's entry i goes to i + its rank
    in list l ^ 1 by (key, id), kept below k; an odd last list passes."""
    out = []
    for a in range(0, len(lists), 2):
        if a + 1 == len(lists):
            out.append(lists[a])
            continue
        (ak, ai), (bk, bi) = lists[a], lists[a + 1]
        keys = torch.full((ak.shape[0], k), float("nan"))
        ids = torch.full((ak.shape[0], k), -1, dtype=torch.int32)
        for (xk, xi), (yk, yi) in (((ak, ai), (bk, bi)),
                                   ((bk, bi), (ak, ai))):
            below = ((yk[:, None, :] < xk[:, :, None])
                     | ((yk[:, None, :] == xk[:, :, None])
                        & (yi[:, None, :] < xi[:, :, None])))
            pos = torch.arange(k)[None, :] + below.sum(-1)
            keep = pos < k
            for b in range(xk.shape[0]):
                keys[b, pos[b][keep[b]]] = xk[b][keep[b]]
                ids[b, pos[b][keep[b]]] = xi[b][keep[b]]
        out.append((keys, ids))
    return out


def range_sort_merge(q, x, k):
    """``csrc/fused_topk_l2.cu``'s path for k > 448 in plain torch: the
    plain version's keys, each range of ``range_rows`` rows sorted whole by
    (key, id) and cut or padded (+inf, INT_MAX) to k, the lists merged in
    pairs by rank, then (+inf, N) past min(N, k)."""
    B, N = q.shape[0], x.shape[0]
    C = range_rows(N, k)
    keys = tref.pairwise_l2(q, x)
    lists = []
    for lo in range(0, N, C):
        kr = torch.full((B, C), float("inf"))
        ir = torch.full((B, C), INT_MAX, dtype=torch.int32)
        m = min(C, N - lo)
        kr[:, :m] = keys[:, lo:lo + m]
        ir[:, :m] = torch.arange(lo, lo + m, dtype=torch.int32)
        order = torch.sort(kr, dim=1, stable=True).indices   # ids ascend
        kr, ir = kr.gather(1, order)[:, :k], ir.gather(1, order)[:, :k]
        pad = k - kr.shape[1]
        lists.append((torch.cat([kr, torch.full((B, pad), float("inf"))], 1),
                      torch.cat([ir, torch.full((B, pad), INT_MAX,
                                                dtype=torch.int32)], 1)))
    while len(lists) > 1:
        lists = rank_pairs(lists, k)
    kd, ki = lists[0]
    real = ki != INT_MAX
    return (torch.where(real, kd, float("inf")),
            torch.where(real, ki, N).to(torch.int32))


@pytest.mark.parametrize("B,N,k,d,equal", [
    (3, 2500, 449, 18, False),       # 3 ranges of 1024 rows
    (2, 2500, 1024, 8, False),       # k = one range
    (3, 700, 700, 18, False),        # k = N
    (2, 1100, 1500, 8, False),       # k > N
    (2, 300, 449, 6, True),          # all rows equal: every key ties
    (1, 8400, 8300, 4, False)])      # k > C: two ranges, padded lists
def test_topk_large_k_range_sort_merge(B, N, k, d, equal):
    """The kernel's path past k = 448 equals ``ref.fused_topk_l2``, bit for
    bit: whole-range sorts hold each range's top-k and the pairwise rank
    merge of the launch after it keeps (key, id) order."""
    rng = np.random.default_rng(B + N + k)
    x = torch.as_tensor(topk_rows(N, d, N, equal))
    q = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32))
    q[0] = x[0]
    want_d, want_i = tref.fused_topk_l2(q, x, k=k)
    got_d, got_i = range_sort_merge(q, x, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    if equal:
        assert torch.equal(got_i[:, :min(N, k)],
                           torch.arange(min(N, k), dtype=torch.int32)
                           .expand(B, -1))


def test_pairwise_l2_is_the_sequential_expansion():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 5)).astype(np.float32)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    want = np.empty((3, 4), np.float32)
    for b in range(3):
        for i in range(4):
            qq = xx = dot = np.float32(0)
            for c in range(5):
                qq = np.float32(qq + np.float32(q[b, c] * q[b, c]))
                xx = np.float32(xx + np.float32(x[i, c] * x[i, c]))
                dot = np.float32(dot + np.float32(q[b, c] * x[i, c]))
            want[b, i] = np.float32(np.float32(qq + xx)
                                    - np.float32(2 * dot))
    got = tref.pairwise_l2(torch.as_tensor(q), torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)


def expansion_atol(q, x):
    """Rounding scale of (|q|² + |x|²) − 2 q·x on these inputs."""
    return 1e-5 * float((q * q).sum(1).max() + (x * x).sum(1).max())


def test_mxu_hot_phase_matches_reference(built_dqf, saved, queries):
    dqf, _ = built_dqf
    port = dqf_from_arrays(saved, port_cfg(dqf.cfg), device="cpu")
    hd = dqf.tenants.default.hot_tables(dqf.store)
    th = port.hot_tables()
    kw = dict(pool_size=dqf.cfg.hot_pool, max_hops=dqf.cfg.max_hops,
              mode="mxu")
    want, want_stats = j_hot(hd["x_hot_pad"], hd["adj_hot_pad"],
                             hd["hot_entries"], jnp.asarray(queries), **kw)
    got, got_stats = t_hot(th["x_hot_pad"], th["adj_hot_pad"],
                           th["hot_entries"], torch.as_tensor(queries), **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(
        got.dists.numpy(), np.asarray(want.dists), rtol=1e-5,
        atol=expansion_atol(queries, dqf.x[dqf.hot.ids]))
    assert not got.expanded.any()
    np.testing.assert_array_equal(got_stats.dist_count.numpy(),
                                  np.asarray(want_stats.dist_count))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_tree", [False, True])
def test_mxu_dynamic_search_matches_reference(built_dqf, saved, queries,
                                              fused, with_tree):
    dqf, _ = built_dqf
    port = dqf_from_arrays(saved, port_cfg(dqf.cfg), device="cpu")
    c = dqf.cfg
    kw = dict(k=c.k, hot_pool_size=c.hot_pool, full_pool_size=c.full_pool,
              eval_gap=c.eval_gap, add_step=c.add_step,
              tree_depth=c.tree_depth, max_hops=c.max_hops, hot_mode="mxu")
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
    assert_lanes_match(want, got, atol=expansion_atol(queries, dqf.x))
    np.testing.assert_array_equal(np.asarray(want_hot.dist_count),
                                  got_hot.dist_count.numpy())
    assert (got_hot.dist_count.numpy() == dqf.hot.size).all()


def test_mxu_search_through_dqf_matches_reference(built_dqf, saved, queries):
    dqf, _ = built_dqf
    cfg = dataclasses.replace(dqf.cfg, hot_mode="mxu")
    port = dqf_from_arrays(saved, port_cfg(cfg, fused=True), device="cpu")
    saved_cfg = dqf.cfg
    dqf.cfg = cfg
    try:
        want = dqf.search(queries, record=False)
    finally:
        dqf.cfg = saved_cfg
    assert_lanes_match(want, port.search(queries, record=False),
                       atol=expansion_atol(queries, dqf.x))


def test_mxu_hot_mode_matches_graph_recall(small_data):
    """Port of tests/test_dqf_system.py::test_mxu_hot_mode_matches_graph_recall."""
    cfg = DQFConfig(knn_k=12, out_degree=12, index_ratio=0.03, k=10,
                    hot_pool=16, full_pool=32, max_hops=120, fused=True)
    wl = ZipfWorkload(small_data, seed=5)
    dqf = DQF(cfg, device="cpu").build(small_data)
    _, t = wl.sample(3000, with_targets=True)
    dqf.counter.record(t)
    dqf.rebuild_hot()
    q = wl.sample(96)
    gt = ground_truth(small_data, q, 10)
    r_graph = recall_at_k(dqf.search_dual_beam(q).ids.numpy(), gt)
    dqf.cfg = dataclasses.replace(cfg, hot_mode="mxu")
    r_mxu = recall_at_k(dqf.search_dual_beam(q).ids.numpy(), gt)
    assert r_mxu >= r_graph - 0.02
