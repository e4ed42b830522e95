"""Port of the fused wave-hop: plain version against the JAX package.

* ``repro_torch.kernels.ref.fused_hop`` ≡ ``repro.kernels.ref.fused_hop``
  on the same numpy-seeded worlds: ids, expanded flags, seen bitmap,
  counters, ``terminated`` and ``stop_at`` exactly equal; dists within
  rtol 1e-5 (the port sums squares in a fixed halving order, XLA:CPU in
  its own order).
* Within the port, the fused plain version ≡ the composed per-hop loop,
  bit for bit.
* The stable order: ``repro.kernels.bitonic.bitonic_sort_stable``'s
  permutation ≡ ``torch.sort(stable=True)``'s on tie-heavy keys.
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stable_order_matches_jax_bitonic(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 4, (8, 128)).astype(np.float32)   # heavy ties
    keys[:, ::5] = np.inf
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), keys.shape)
    _, perm = bitonic_sort_stable(jnp.asarray(keys), jnp.asarray(pos))
    want = torch.sort(torch.as_tensor(keys), dim=1, stable=True).indices
    np.testing.assert_array_equal(np.asarray(perm), want.numpy())


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
