"""Port of the paged fused hop: plain version against the JAX package.

* ``repro_torch.kernels.ref.fused_hop_paged`` ≡ ``repro.kernels.ref.
  fused_hop_paged`` in f32, sq8 and pq, with and without the tree, on
  shuffled page tables drawn from a pool larger than needed, with random
  bytes in unreferenced pages and in the tails, and padding lanes that
  alias one scratch row: ids, counters and flags exactly equal, dists
  within rtol 1e-5 (the port sums squares in a fixed halving order), the
  whole pool equal.
* Within the port, the paged plain version ≡ the dense one bit for bit
  once the pool is read back through ``dense_seen`` (the reference's own
  rule, ``tests/test_fused_hop.py::test_paged_interpret_parity``), the
  tails come back zeroed and the unreferenced pages untouched.
* The CUDA wrapper refuses what its kernel does not take, before launch.
"""

import numpy as np
import pytest
import torch


from repro.kernels import ref as jref
from repro_torch.core import beam_search as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_hop import fused_hop_paged_cuda
from repro_torch.serving.paged import dense_seen
from tests.test_torch_cuda import (make_tree, make_world, paged_case,
                                   quant_table)
from tests.test_torch_fused_hop import J, T, diverging_lanes

KW = dict(hops=15, max_hops=40, k=5, eval_gap=25, add_step=6, tree_depth=4)


def world_case(mode, B, n_pad, page_cols, use_tree, use_live, seed):
    """Port-side inputs of one paged hop: (hs, pt, adj, q, live, spec,
    tree, hf, hr) on the CPU."""
    x_pad, adj_pad, live = map(T, make_world(seed=seed))
    rng = np.random.default_rng(300 + seed)
    q = T(rng.standard_normal((B, 18)).astype(np.float32))
    table = x_pad if mode == "f32" else quant_table(x_pad.numpy(), mode, q)
    spec = tops.table_spec(table)
    live_pad = live if use_live else None
    entries = T(np.arange(0, 220, 37).astype(np.int32))
    hs, pt = paged_case(tbs.to_hop_state(tbs.init_state(
        x_pad, q, entries, 16, live_pad)), page_cols, n_pad, rng)
    tree = hf = hr = None
    if use_tree:
        tree = tuple(map(T, make_tree()))
        hf = T(rng.uniform(1, 6, B).astype(np.float32))
        hr = T(rng.uniform(0.5, 1.5, B).astype(np.float32))
    return hs, pt, adj_pad, q, live_pad, spec, tree, hf, hr


def clone(hs):
    return hs._replace(seen=hs.seen.clone())


@pytest.mark.parametrize("mode", ["f32", "sq8", "pq"])
@pytest.mark.parametrize("use_tree", [False, True])
@pytest.mark.parametrize("page_cols", [64, 256])
def test_paged_plain_matches_jax_reference(mode, use_tree, page_cols):
    hs, pt, adj, q, live, spec, tree, hf, hr = world_case(
        mode, 12, 3, page_cols, use_tree, True, seed=page_cols)
    jhs = jref.HopState(*(J(f.numpy()) for f in hs))
    jspec = (mode,) + tuple(None if t is None else J(t.numpy())
                            for t in spec[1:])
    want = jref.fused_hop_paged(
        jhs, J(pt.numpy()), J(adj.numpy()), J(q.numpy()), J(live.numpy()),
        *jspec, None if tree is None else tuple(J(t.numpy()) for t in tree),
        None if hf is None else J(hf.numpy()),
        None if hr is None else J(hr.numpy()), page_cols=page_cols, **KW)
    got = tref.fused_hop_paged(clone(hs), pt, adj, q, live, *spec, tree, hf,
                               hr, page_cols=page_cols, **KW)
    assert diverging_lanes(want, got) == [], "lanes diverge from JAX"
    np.testing.assert_array_equal(np.asarray(want.seen), got.seen.numpy())
    if use_tree:
        assert np.asarray(want.evals_done).any()     # the tree was consulted


@pytest.mark.parametrize("mode", ["f32", "sq8", "pq"])
@pytest.mark.parametrize("use_live", [False, True])
def test_paged_plain_equals_dense_within_port(mode, use_live):
    """Paged ≡ dense bit for bit through ``dense_seen``; tails come back
    zeroed; unreferenced pages are untouched."""
    B, n_pad, pc = 10, 2, 64
    hs, pt, adj, q, live, spec, tree, hf, hr = world_case(
        mode, B, n_pad, pc, True, use_live, seed=5)
    n1 = adj.shape[0]
    dense_in = hs._replace(seen=dense_seen(hs.seen, pt, n1).clone())
    want = tref.fused_hop(dense_in, adj, q, live, *spec, tree, hf, hr, **KW)
    pool0 = hs.seen.clone()
    got = tref.fused_hop_paged(clone(hs), pt, adj, q, live, *spec, tree, hf,
                               hr, page_cols=pc, **KW)
    for f in tref.HopState._fields:
        if f == "seen":
            continue
        a, b = getattr(want, f), getattr(got, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert torch.equal(dense_seen(got.seen, pt, n1), want.seen)
    ppl = pt.shape[1]
    rows = got.seen[pt.long()].reshape(B, ppl * pc)
    assert not bool(rows[:, n1:].any())                   # tails zeroed
    untouched = torch.ones(got.seen.shape[0], dtype=torch.bool)
    untouched[pt.long().flatten()] = False
    assert bool(untouched.any())
    assert torch.equal(got.seen[untouched], pool0[untouched])


def test_dry_wave_retires_every_lane():
    """A wave that runs dry: every lane exhausts its pool, padding stays
    inert, the plain versions agree."""
    x_pad, adj_pad, live = map(T, make_world(n=40, R=4, seed=9,
                                             dead_every=0,
                                             sentinel_rows=(1,)))
    rng = np.random.default_rng(1)
    B = 5
    q = T(rng.standard_normal((B, 18)).astype(np.float32))
    hs, pt = paged_case(tbs.to_hop_state(tbs.init_state(
        x_pad, q, T(np.arange(0, 40, 9).astype(np.int32)), 8)), 64, 1, rng)
    n1 = adj_pad.shape[0]
    dense = tref.fused_hop(hs._replace(seen=dense_seen(hs.seen, pt,
                                                       n1).clone()),
                           adj_pad, q, None, "f32", x_pad, hops=64,
                           max_hops=512)
    got = tops.fused_hop_paged(clone(hs), pt, adj_pad, q, None, x_pad,
                               page_cols=64, hops=64, max_hops=512)
    assert not bool(got.active.any())
    assert torch.equal(got.ids, dense.ids)
    assert torch.equal(dense_seen(got.seen, pt, n1), dense.seen)


def test_cuda_wrapper_refuses_before_launch():
    hs, pt, adj, q, live, spec, *_ = world_case("f32", 4, 1, 64, False,
                                                True, seed=2)
    kw = dict(hops=2, max_hops=8)
    with pytest.raises(ValueError, match="power of two"):
        fused_hop_paged_cuda(hs, pt, adj, q, live, *spec, page_cols=48,
                             **kw)
    with pytest.raises(ValueError, match="page pool"):
        fused_hop_paged_cuda(hs, pt, adj, q, live, *spec, page_cols=128,
                             **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fused_hop_paged_cuda(hs, pt, adj, q, live, *spec, page_cols=64,
                             **kw)
