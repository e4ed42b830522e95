"""Port of the fused wave-hop: plain version against the JAX package.

* ``repro_torch.kernels.ref.fused_hop`` ≡ ``repro.kernels.ref.fused_hop``
  on the same numpy-seeded worlds: ids, expanded flags, seen bitmap,
  counters, ``terminated`` and ``stop_at`` exactly equal; dists within
  rtol 1e-5 (the port sums squares in a fixed halving order, XLA:CPU in
  its own order).
* Within the port, the fused plain version ≡ the composed per-hop loop,
  bit for bit, and so is ``fused_beam_loop`` on its CPU route and on its
  card route (one launch, run through the plain version).
* The stable order: ``repro.kernels.bitonic.bitonic_sort_stable``'s
  permutation ≡ ``torch.sort(stable=True)``'s on tie-heavy keys.
* The CUDA hop's merge emulated in plain torch (``rank_merge``: sort the
  candidates, place every entry by rank; the full network for a pool that
  is not sorted) ≡ the plain version's stable sort of [pool | candidates],
  with ties, ``INF_DIST`` and +inf slots, duplicate ids and unsorted pools.
* The per-lane table base: ``ref.fused_hop`` over stacked tables with
  ``lane_base`` ≡ the same lanes hopped over their own tenant's tables.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import beam_search as jbs
from repro.kernels import ref as jref
from repro.kernels.bitonic import bitonic_sort_stable
from repro_torch.core import beam_search as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.test_torch_cuda import make_tree, make_world

INT_MAX = np.iinfo(np.int32).max


def T(a):
    return None if a is None else torch.as_tensor(np.array(a))


def J(a):
    return None if a is None else jnp.asarray(a)


def port_state(jhs) -> tref.HopState:
    return tref.HopState(*(T(np.asarray(f)) for f in jhs))


def diverging_lanes(want, got):
    """Lanes whose ids, counters or flags differ (listed, never hidden)."""
    bad = set()
    for f in tref.HopState._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "dists":
            diff = ~np.isclose(a, b, rtol=1e-5, atol=0)
        else:
            diff = a != b
        bad |= set(np.flatnonzero(diff.reshape(diff.shape[0], -1).any(1)))
    return sorted(bad)


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("use_tree", [False, True])
@pytest.mark.parametrize("use_live", [False, True])
def test_hop_matches_jax_reference(B, use_tree, use_live):
    x_pad, adj_pad, live = make_world(seed=B)
    rng = np.random.default_rng(100 + B)
    q = rng.standard_normal((B, 18)).astype(np.float32)
    entries = np.arange(0, 220, 37).astype(np.int32)
    live_pad = live if use_live else None
    hs = jbs.to_hop_state(jbs.init_state(J(x_pad), J(q), J(entries), 16,
                                         J(live_pad)))
    tree = make_tree() if use_tree else None
    hf = rng.uniform(1, 6, B).astype(np.float32) if use_tree else None
    hr = rng.uniform(0.5, 1.5, B).astype(np.float32) if use_tree else None
    kw = dict(hops=15, max_hops=40, k=5, eval_gap=25, add_step=6,
              tree_depth=4)
    want = jref.fused_hop(hs, J(adj_pad), J(q), J(live_pad), "f32",
                          J(x_pad), None, None,
                          None if tree is None else tuple(map(J, tree)),
                          J(hf), J(hr), **kw)
    got = tref.fused_hop(port_state(hs), T(adj_pad), T(q), T(live_pad),
                         "f32", T(x_pad), None, None,
                         None if tree is None else tuple(map(T, tree)),
                         T(hf), T(hr), **kw)
    assert diverging_lanes(want, got) == [], "lanes diverge from JAX"
    if use_tree:
        assert np.asarray(want.evals_done).any()     # the tree was consulted


@pytest.mark.parametrize("use_live", [False, True])
def test_fused_plain_equals_composed_loop(use_live):
    """Mirror of test_oracle_matches_composed_loop, inside the port."""
    x_pad, adj_pad, live = map(T, make_world())
    live_pad = live if use_live else None
    B, L, H = 6, 16, 14
    q = T(np.random.default_rng(3).standard_normal((B, 18))
          .astype(np.float32))
    entries = T(np.arange(0, 220, 31).astype(np.int32))
    state = tbs.init_state(x_pad, q, entries, L, live_pad)
    hs = tbs.to_hop_state(state._replace(seen=state.seen.clone()))
    want = state
    for _ in range(H):
        want = tbs.expand_step(x_pad, adj_pad, q, want, live_pad)
        want = want._replace(active=want.active & (want.stats.hops < 48))
    got = tref.fused_hop(hs, adj_pad, q, live_pad, "f32", x_pad, hops=H,
                         max_hops=48)
    expect = tbs.to_hop_state(want, got.evals_done, got.stop_at)
    for f in tref.HopState._fields:
        a, b = getattr(expect, f), getattr(got, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def _beam_world():
    x_pad, adj_pad, live = map(T, make_world())
    q = T(np.random.default_rng(4).standard_normal((6, 18))
          .astype(np.float32))
    entries = T(np.arange(0, 220, 31).astype(np.int32))
    return x_pad, adj_pad, live, q, tbs.init_state(x_pad, q, entries, 16,
                                                    live)


@pytest.mark.parametrize("max_hops", [-1, 0, 1, 5, 48])
def test_fused_beam_loop_routes_equal_composed_loop(monkeypatch, max_hops):
    """``fused_beam_loop`` ≡ ``beam_loop`` bit for bit on both routes: the
    CPU's (``fused_hops`` at a time) and the card's (one launch of
    ``max(max_hops, 1)`` hops, run here through the plain version), with
    ``max_hops`` <= 0 included: an active lane expands once before the cap
    applies."""
    x_pad, adj_pad, live, q, state = _beam_world()
    fresh = lambda: state._replace(seen=state.seen.clone())
    want = tbs.beam_loop(x_pad, adj_pad, q, fresh(), max_hops, live)
    cpu = tbs.fused_beam_loop(x_pad, adj_pad, q, fresh(), max_hops, live,
                              fused_hops=3)
    calls = []

    def card_hop(*args, hops, **kw):
        calls.append(hops)
        return tref.fused_hop(*args, hops=hops, **kw)

    monkeypatch.setattr(tops, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(tops, "fused_hop_cuda", card_hop)
    card = tbs.fused_beam_loop(x_pad, adj_pad, q, fresh(), max_hops, live)
    assert calls == [max(max_hops, 1)]
    for got in (cpu, card):
        assert not bool(got.active.any())
        for a, b in zip(tbs.to_hop_state(want), tbs.to_hop_state(got)):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stable_order_matches_jax_bitonic(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 4, (8, 128)).astype(np.float32)   # heavy ties
    keys[:, ::5] = np.inf
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), keys.shape)
    _, perm = bitonic_sort_stable(jnp.asarray(keys), jnp.asarray(pos))
    want = torch.sort(torch.as_tensor(keys), dim=1, stable=True).indices
    np.testing.assert_array_equal(np.asarray(perm), want.numpy())


def rank_merge(pool_d, pool_i, pool_e, cand_d, cand_i):
    """``csrc/fused_hop.cu``'s merge in plain torch.  A sorted pool keeps
    its order; pool entry i goes to i + #(candidates with key < its key),
    the candidate of rank j among the candidates by (key, position) to
    j + #(pool entries with key <= its key) (the kernel counts both over
    the warp), and only ranks below L are kept.  A lane whose pool is not sorted takes the full stable sort of
    [pool | candidates], as the kernel's network does."""
    B, L = pool_d.shape
    R = cand_d.shape[1]
    order = torch.sort(cand_d, dim=1, stable=True).indices
    sk, si = cand_d.gather(1, order), cand_i.gather(1, order)
    pool_rank = (torch.arange(L)[None, :]
                 + torch.searchsorted(sk, pool_d.contiguous(), right=False))
    cand_rank = (torch.arange(R)[None, :]
                 + torch.searchsorted(pool_d.contiguous(), sk, right=True))
    out_d = torch.full((B, L + R), float("nan"))
    out_i = torch.full((B, L + R), -1, dtype=torch.int32)
    out_e = torch.zeros((B, L + R), dtype=torch.bool)
    out_d.scatter_(1, pool_rank, pool_d)
    out_i.scatter_(1, pool_rank, pool_i)
    out_e.scatter_(1, pool_rank, pool_e)
    out_d.scatter_(1, cand_rank, sk)
    out_i.scatter_(1, cand_rank, si)
    unsorted = (pool_d[:, 1:] < pool_d[:, :-1]).any(dim=1)
    full = torch.sort(torch.cat([pool_d, cand_d], 1), dim=1,
                      stable=True).indices
    cat_i = torch.cat([pool_i, cand_i], 1)
    cat_e = torch.cat([pool_e, torch.zeros_like(cand_i, dtype=torch.bool)],
                      1)
    u = unsorted[:, None]
    out_d = torch.where(u, torch.cat([pool_d, cand_d], 1).gather(1, full),
                        out_d)
    out_i = torch.where(u, cat_i.gather(1, full), out_i)
    out_e = torch.where(u, cat_e.gather(1, full), out_e)
    return out_d[:, :L], out_i[:, :L], out_e[:, :L]


@pytest.mark.parametrize("L,R,unsorted", [
    (16, 10, False), (64, 32, False), (64, 32, True), (10, 70, False),
    (24, 40, True), (1, 5, False), (100, 7, True)])
def test_rank_merge_equals_stable_sort(L, R, unsorted):
    """The CUDA hop's merge (emulated) ≡ the plain version's stable sort of
    [pool | candidates | +inf pad], the first L kept: tie-heavy keys,
    ``INF_DIST`` slots in both, +inf pool slots, duplicate ids, and pools
    that are not sorted (the full network's branch)."""
    rng = np.random.default_rng(L * R + unsorted)
    B = 40
    pool_d = np.sort(rng.integers(0, 6, (B, L)).astype(np.float32), 1)
    pool_d[::3, L // 2:] = tref.INF_DIST               # empty slots
    pool_d[1::5, max(L - 2, 0):] = np.inf
    cand_d = rng.integers(0, 7, (B, R)).astype(np.float32)
    cand_d[:, ::4] = tref.INF_DIST                     # invalid neighbours
    pool_i = rng.integers(0, 50, (B, L)).astype(np.int32)
    cand_i = rng.integers(0, 50, (B, R)).astype(np.int32)
    cand_i[:, -1] = cand_i[:, 0]                       # an id twice
    pool_e = rng.random((B, L)) < 0.4
    if unsorted:
        for b in range(0, B, 2):
            perm = rng.permutation(L)
            pool_d[b], pool_i[b], pool_e[b] = (pool_d[b][perm],
                                               pool_i[b][perm],
                                               pool_e[b][perm])
    args = [torch.as_tensor(a) for a in (pool_d, pool_i, pool_e, cand_d,
                                         cand_i)]
    got = rank_merge(*args)
    cat_d = torch.cat([args[0], args[3],
                       torch.full((B, 3), float("inf"))], 1)
    cat_i = torch.cat([args[1], args[4],
                       torch.zeros((B, 3), dtype=torch.int32)], 1)
    cat_e = torch.cat([args[2], torch.zeros((B, R + 3), dtype=torch.bool)],
                      1)
    order = torch.sort(cat_d, dim=1, stable=True).indices[:, :L]
    want = (cat_d.gather(1, order), cat_i.gather(1, order),
            cat_e.gather(1, order))
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert bool((pool_d[:, 1:] < pool_d[:, :-1]).any()) == unsorted


def test_lane_base_equals_per_lane_tables():
    """``ref.fused_hop`` with ``lane_base`` over a (T, n+1, ·) stack ≡ each
    tenant's lanes hopped over that tenant's own tables, every field."""
    NT, B, L = 3, 12, 16
    worlds = [make_world(seed=10 + t) for t in range(NT)]
    x_st, adj_st, live_st = (T(np.stack([w[i] for w in worlds]))
                             for i in range(3))
    n1 = x_st.shape[1]
    rng = np.random.default_rng(7)
    tid = torch.as_tensor(rng.integers(0, NT, B))
    q = T(rng.standard_normal((B, 18)).astype(np.float32))
    entries = T(np.arange(0, 220, 37).astype(np.int32))
    kw = dict(hops=9, max_hops=40)
    lanes = [torch.nonzero(tid == t).flatten() for t in range(NT)]
    st = tbs.init_state(tbs.LaneTable(x_st, tid), q, entries, L)
    got = tref.fused_hop(tbs.to_hop_state(st), adj_st, q, live_st, "f32",
                         x_st, lane_base=(tid * n1).to(torch.int32), **kw)
    for t in range(NT):
        sel = lanes[t]
        sub = tbs.init_state(x_st[t], q[sel], entries, L)
        want = tref.fused_hop(tbs.to_hop_state(sub), adj_st[t], q[sel],
                              live_st[t], "f32", x_st[t], **kw)
        for f in tref.HopState._fields:
            a, b = getattr(want, f), getattr(got, f)[sel]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (t, f)


def test_sq_l2_is_the_halving_sum():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((3, 7, 18)).astype(np.float32)
    q = rng.standard_normal((3, 1, 18)).astype(np.float32)
    s = np.pad((g - q) * (g - q), ((0, 0), (0, 0), (0, 14)))
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    got = tref.sq_l2(torch.as_tensor(g), torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(got, s[..., 0])


def test_ops_dispatch_cpu_goes_to_plain_version():
    x_pad, adj_pad, live = map(T, make_world())
    q = T(np.random.default_rng(4).standard_normal((4, 18))
          .astype(np.float32))
    entries = T(np.arange(0, 220, 53).astype(np.int32))
    st = tbs.init_state(x_pad, q, entries, 8, live)
    hs_a = tbs.to_hop_state(st._replace(seen=st.seen.clone()))
    hs_b = tbs.to_hop_state(st._replace(seen=st.seen.clone()))
    got = tops.fused_hop(hs_a, adj_pad, q, live, x_pad, hops=3, max_hops=64)
    want = tref.fused_hop(hs_b, adj_pad, q, live, "f32", x_pad, hops=3,
                          max_hops=64)
    for f in tref.HopState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert tops.table_spec(x_pad)[0] == "f32"
    with pytest.raises(TypeError):
        tops.table_spec(object())
