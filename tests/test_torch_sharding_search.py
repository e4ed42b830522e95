"""The port's stacked sharded search against its own sequential oracle.

One port-built ``ShardedDQF`` a shard count (``repro_torch.sharding``,
built, warmed and tree-fitted once for the module, on the CPU), carried
into a fresh twin for every case: the stacked search (every shard's hot
phase, seed and full phase as S·B lanes, merged by ``pool_merge``) is bit
for bit with ``search_oracle`` (per-shard searches, a host stable merge)
at 2, 3 and 4 shards, fused and composed, with and without the tree, in
``hot_mode="mxu"``, with two tenants and across tombstones; at one shard
the port's build and search equal a plain port ``DQF``'s.  The cases
against the JAX package are in ``tests/test_torch_sharding.py``, split
from it for its time.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import DQF, DQFConfig, beam_search as bs
from repro_torch.core.recall import ground_truth, recall_at_k
from repro_torch.sharding import ShardedDQF
from tests.test_torch_sharding import CFG, _assert_parity, _data
from tests._torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def built():
    """One port ShardedDQF a shard count in {2, 3, 4}, built, warmed on
    ``q[:8]`` and fitted on ``q``; at S = 3 tenants "a" and "b" are
    warmed too.  Returned as per-shard arrays and the owner map."""
    x, q = _data()
    cache = {}

    def get(S):
        if S not in cache:
            sd = ShardedDQF(DQFConfig(**CFG), S, device="cpu").build(x)
            sd.warm(q[:8])
            if S == 3:
                sd.warm(q[:8], tenant="a")
                sd.warm(q[8:16], tenant="b")
            sd.fit_tree(q)
            cache[S] = ([{k: np.array(v, copy=True)
                          for k, v in sh.dqf.to_arrays().items()}
                         for sh in sd.shards], dict(sd._owner))
        return cache[S]

    return x, q, get


def _fresh(world, *, tree=True, **over):
    """A fresh ShardedDQF over a built world's state."""
    arrays, owner = world
    sd = ShardedDQF.from_arrays(
        arrays, dataclasses.replace(DQFConfig(**CFG), **over),
        len(arrays), owner=owner, device="cpu")
    if not tree:
        sd.tree = None
        for sh in sd.shards:
            sh.dqf.tree = None
    return sd


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("num_shards", [2, 3, 4])
def test_stacked_matches_oracle(built, num_shards, tree, fused):
    """``tests/test_sharded.py:93-104``: stacked ≡ oracle bit for bit,
    with the shared tree and without it; recall as the reference's bar."""
    x, q, get = built
    sd = _fresh(get(num_shards), tree=tree, fused=fused)
    assert sd._stacked_ok and (sd.tree is not None) == tree
    res = _assert_parity(sd, q)
    assert recall_at_k(res.ids, ground_truth(x, q, 5)) > 0.85


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("num_shards", [2, 3])
def test_stacked_mxu_matches_oracle(built, num_shards, fused):
    """``hot_mode="mxu"``: each shard's own hot rows scored by the top-k
    (as its search scores them), the seed and full phase stacked; ≡ the
    oracle bit for bit."""
    x, q, get = built
    sd = _fresh(get(num_shards), hot_mode="mxu", fused=fused)
    res = _assert_parity(sd, q)
    assert recall_at_k(res.ids, ground_truth(x, q, 5)) > 0.85


@pytest.mark.parametrize("tenant", ["a", "b"])
def test_mixed_tenant_parity(built, tenant):
    """``tests/test_sharded.py:125-130``."""
    x, q, get = built
    _assert_parity(_fresh(get(3), fused=True), q, tenant=tenant)


@pytest.mark.parametrize("fused", [False, True])
def test_stacked_search_across_tombstones(built, fused):
    """Rows deleted in the shards (each shard's own ``DQF.delete``): the
    stacked liveness ``(S, cap+1)`` masks them in the seed and the full
    phase as each shard's 1-D liveness does in its own search."""
    x, q, get = built
    sd = _fresh(get(4), fused=fused)
    before = sd.search(q, record=False)
    dead = np.unique(before.ids[:, :2])
    for s, sh in enumerate(sd.shards):
        mine = [int(e) for e in dead if sd._owner[int(e)] == s]
        if mine:
            sh.dqf.delete(np.asarray(mine, np.int64))
    res = _assert_parity(sd, q)
    assert not set(res.ids.ravel().tolist()) & set(dead.tolist())
    assert (res.ids >= 0).all()


@pytest.mark.parametrize("fused", [False, True])
def test_lane_liveness_equals_per_block_search(built, fused):
    """``init_state`` and ``expand_step`` (and the hop) reading a
    ``LaneTable`` over stacked ``(T, n+1)`` liveness equal each block's
    own search over its 1-D liveness, lane for lane."""
    x, q, get = built
    sd = _fresh(get(2))
    stk = sd._sync_stacked()
    live = stk["live_pad"].clone()
    live[:, ::5] = False                               # tombstones
    B, S = q.shape[0], 2
    lane = torch.arange(S).repeat_interleave(B)
    qq = torch.as_tensor(q).repeat(S, 1)
    ents = torch.stack([torch.as_tensor(sh.dqf.full.entries[:4])
                        for sh in sd.shards])[lane]
    lt = lambda t: bs.LaneTable(t, lane)
    got = bs.beam_search(lt(stk["x_pad"]), lt(stk["adj_pad"]), ents, qq,
                         pool_size=16, k=5, max_hops=50,
                         live_pad=lt(live), fused=fused, fused_hops=4)
    for s in range(S):
        want = bs.beam_search(stk["x_pad"][s], stk["adj_pad"][s],
                              ents[s * B], torch.as_tensor(q),
                              pool_size=16, k=5, max_hops=50,
                              live_pad=live[s], fused=fused, fused_hops=4)
        rows = slice(s * B, (s + 1) * B)
        assert torch.equal(got.ids[rows], want.ids)
        assert torch.equal(got.dists[rows], want.dists)
        for f in want.stats._fields:
            assert torch.equal(getattr(got.stats, f)[rows],
                               getattr(want.stats, f))


def test_single_shard_build_equals_plain_dqf():
    """``tests/test_sharded.py:79-91`` on the port's own build: one shard
    keeps the identity order, so its build, warm and search equal a plain
    port DQF's bit for bit, ids as ext ids."""
    x, q = _data()
    cfg = DQFConfig(**CFG, fused=True)
    sd = ShardedDQF(cfg, 1, device="cpu").build(x)
    plain = DQF(cfg, device="cpu").build(x)
    sd.warm(q[:8])
    plain.warm(q[:8])
    np.testing.assert_array_equal(sd.shards[0].dqf.full.adj, plain.full.adj)
    a = sd.search(q, record=False)
    b = plain.search(q, record=False)
    np.testing.assert_array_equal(a.ids, plain.to_external(b.ids.numpy()))
    np.testing.assert_array_equal(a.dists, b.dists.numpy())
