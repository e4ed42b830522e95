"""Port of the sharded index's read path (``repro_torch.sharding``) against
the JAX package.

The state is carried across: one reference ``ShardedDQF`` a shard count,
built once for the module, its per-shard checkpoints, ``_owner`` and tree
loaded into the port (:func:`repro_torch.convert.sharded_from_arrays`).
On it the port's search equals the reference's (ids equal, dists within
rtol 1e-5, any divergent lane named), one shard equals a plain port
``DQF`` bit for bit, and the read-path cases of ``tests/test_sharded.py``
(merge, degraded merge, counters, scrape, memory, refusals) run on the
port.  The stacked search against the port's own oracle, on port-built
shards, is ``tests/test_torch_sharding_search.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.types import DQFConfig as JConfig
from repro.core.types import QuantConfig as JQuant
from repro.obs import MetricsRegistry as JRegistry
from repro.serving.sharded import merge_with_dropout as j_merge_with_dropout
from repro.sharding import ShardConfig as JShardConfig
from repro.sharding import ShardedDQF as JShardedDQF
from repro.sharding import merge_topk as j_merge_topk
from repro_torch.convert import sharded_from_arrays
from repro_torch.core import DQF, QuantConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.sharded import merge_with_dropout
from repro_torch.sharding import (ShardConfig, ShardedDQF, merge_topk,
                                  merge_topk_host)
from tests.test_torch_search import MAX_DIVERGENT, port_cfg
from tests._torch_threads import one_torch_thread  # noqa: F401

D = 16
CFG = dict(dim=D, k=5, hot_pool=16, full_pool=32, max_hops=100,
           n_query_trigger=10_000)
SHARDS = (1, 2, 3, 4)


def _data(n=600, nq=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    q = x[rng.choice(n, nq, replace=False)] \
        + 0.05 * rng.standard_normal((nq, D)).astype(np.float32)
    return x, q


def _shard_arrays(jsd, tmp):
    """Each reference shard's checkpoint arrays (its ``DQF.save``)."""
    out = []
    for s, sh in enumerate(jsd.shards):
        path = tmp / f"shard{s}.npz"
        sh.dqf.save(str(path))
        with np.load(path) as z:
            out.append({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One reference ``ShardedDQF`` a shard count in ``SHARDS`` (and an
    sq8 one at S = 2), built and warmed once, with its per-shard arrays.
    At S = 3 the tree is fitted and tenants "a" and "b" are warmed.  The
    reference state is searched only with ``record=False``."""
    x, q = _data()
    cache = {}

    def get(key):
        if key not in cache:
            S, quant = key if isinstance(key, tuple) else (key, None)
            over = {} if quant is None else {"quant": JQuant(mode=quant)}
            jsd = JShardedDQF(JConfig(**CFG, **over),
                              JShardConfig(num_shards=S)).build(x)
            jsd.warm(q[:8])
            if S == 3:
                jsd.warm(q[:8], tenant="a")
                jsd.warm(q[8:16], tenant="b")
                jsd.fit_tree(q)
            tmp = tmp_path_factory.mktemp(f"shards{S}{quant or ''}")
            cache[key] = (jsd, _shard_arrays(jsd, tmp))
        return cache[key]

    return x, q, get


def _twin(world, *, tree=True, **over):
    """A fresh port ShardedDQF over a reference world's state (CPU); the
    reference's tree passed as its ``tree_*`` arrays where it has one."""
    jsd, arrays = world
    cfg = port_cfg(jsd.cfg, **over)
    saved_tree = {k: v for k, v in arrays[0].items()
                  if k.startswith("tree_")} or None
    sd = sharded_from_arrays(arrays, dict(jsd._owner), saved_tree, cfg,
                             ShardConfig(num_shards=jsd.num_shards),
                             device="cpu")
    if not tree:
        sd.tree = None
        for sh in sd.shards:
            sh.dqf.tree = None
    return sd


def _assert_parity(sd, q, tenant=None):
    kw = {} if tenant is None else {"tenant": tenant}
    a = sd.search(q, record=False, **kw)
    b = sd.search_oracle(q, **kw)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    return a


def _divergent_lanes(ref, port):
    """Lanes whose ids differ from the reference's or whose dists leave
    rtol 1e-5; asserted within ``MAX_DIVERGENT`` and named."""
    rid, rd = np.asarray(ref.ids), np.asarray(ref.dists)
    bad = ~(rid == port.ids).all(axis=1)
    bad |= ~np.isclose(rd, port.dists, rtol=1e-5, atol=0.0).all(axis=1)
    lanes = np.flatnonzero(bad).tolist()
    assert len(lanes) <= MAX_DIVERGENT * rid.shape[0], \
        f"{len(lanes)}/{rid.shape[0]} lanes diverge from the reference: " \
        f"{lanes}"
    return lanes


# --------------------------------------------------------------- the merge
def _merge_case(name):
    rng = np.random.default_rng(3)
    if name == "random":                 # tests/test_sharded.py:55-67
        S, B, m, k = 5, 7, 6, 4
        dists = np.sort(rng.random((S, B, m)).astype(np.float32), axis=-1)
        gids = rng.integers(0, 1000, (S, B, m)).astype(np.int32)
        dists[0, :, -2:] = np.inf                   # per-shard padding
        gids[0, :, -2:] = -1
    elif name == "ties":                 # :70-77, every key ties
        dists = np.zeros((3, 2, 4), np.float32)
        gids = np.arange(24, dtype=np.int32).reshape(3, 2, 4)
        k = 6
    else:                                # S·m < k: padded to k
        dists = np.sort(rng.random((2, 3, 2)).astype(np.float32), axis=-1)
        gids = rng.integers(0, 50, (2, 3, 2)).astype(np.int32)
        k = 7
    return dists, gids, k


@pytest.mark.parametrize("name", ["random", "ties", "short"])
def test_merge_topk_matches_host_oracle_and_reference(name):
    dists, gids, k = _merge_case(name)
    ids_p, d_p = merge_topk(torch.as_tensor(dists), torch.as_tensor(gids), k)
    ids_h, d_h = merge_topk_host(list(gids), list(dists), k)
    ids_j, d_j = j_merge_topk(dists, gids, k)
    assert ids_p.shape == (dists.shape[1], k)
    m = ids_h.shape[1]          # the host merge does not pad past S·m
    np.testing.assert_array_equal(ids_p.numpy()[:, :m], ids_h)
    np.testing.assert_array_equal(d_p.numpy()[:, :m], d_h)
    assert (ids_p.numpy()[:, m:] == -1).all()
    assert np.isposinf(d_p.numpy()[:, m:]).all()
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("alive", [[True, False, True, False],
                                   [True, True, False, True], [False]])
def test_merge_with_dropout_matches_reference(alive):
    """``tests/test_sharded.py:203-221`` and ``tests/test_serving.py:
    46-70``: the same ids, dists, coverage and counters as the reference's
    merge; all shards lost raises."""
    rng = np.random.default_rng(13)
    S = len(alive)
    per_i = [rng.integers(0, 100, (4, 6)) for _ in range(S)]
    per_d = [np.sort(rng.random((4, 6)).astype(np.float32)) for _ in range(S)]
    reg, jreg = MetricsRegistry(), JRegistry()
    if not any(alive):
        for fn, r in ((merge_with_dropout, reg),
                      (j_merge_with_dropout, jreg)):
            with pytest.raises(RuntimeError):
                fn(per_i, per_d, alive, 3, registry=r)
        return
    ids, dists, cov = merge_with_dropout(per_i, per_d, alive, 3,
                                         registry=reg)
    jids, jdists, jcov = j_merge_with_dropout(per_i, per_d, alive, 3,
                                              registry=jreg)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(dists, jdists)
    assert cov == jcov == sum(alive) / S
    assert reg.scrape() == jreg.scrape()
    assert reg.exposition() == jreg.exposition()
    live = set(np.concatenate([per_i[s] for s in range(S)
                               if alive[s]]).ravel().tolist())
    assert set(ids.ravel().tolist()) <= live
    assert (np.diff(dists, axis=1) >= 0).all()


# ------------------------------------------------------------ search parity
@pytest.mark.parametrize("fused", [False, True])
def test_single_shard_bitwise_equals_plain_dqf(worlds, fused):
    """``tests/test_sharded.py:79-91`` on the port: one shard ≡ a plain
    port DQF over the same state, ids as ext ids."""
    x, q, get = worlds
    world = get(1)
    sd = _twin(world, fused=fused)
    plain = DQF.from_arrays(world[1][0], port_cfg(world[0].cfg, fused=fused),
                            device="cpu")
    a = sd.search(q, record=False)
    b = plain.search(q, record=False)
    np.testing.assert_array_equal(a.ids,
                                  plain.to_external(b.ids.numpy()))
    np.testing.assert_array_equal(a.dists, b.dists.numpy())


def test_single_shard_fit_tree_equals_plain_dqf(worlds):
    x, q, get = worlds
    world = get(1)
    sd = _twin(world)
    plain = DQF.from_arrays(world[1][0], port_cfg(world[0].cfg),
                            device="cpu")
    t_s, t_p = sd.fit_tree(q), plain.fit_tree(q)
    for f in t_p.arrays._fields:
        assert torch.equal(getattr(t_s.arrays, f), getattr(t_p.arrays, f))
    assert all(sh.dqf.tree is sd.tree for sh in sd.shards)
    np.testing.assert_array_equal(sd.search(q, record=False).dists,
                                  plain.search(q, record=False).dists.numpy())


def test_sq8_shards_take_the_sequential_path(worlds):
    """Quantized shards search one by one and merge on the host, as the
    reference's do: port ≡ reference (ids, dists within rtol 1e-5), and
    ``search`` ≡ ``search_oracle``."""
    x, q, get = worlds
    jsd, _ = world = get((2, "sq8"))
    sd = _twin(world, quant=QuantConfig(mode="sq8"), fused=True)
    assert not sd._stacked_ok and not jsd._stacked_ok
    mine = _assert_parity(sd, q)
    _divergent_lanes(jsd.search(q, record=False), mine)
    assert sd.scrape()["sharded_search_batches_total"] == 1.0


@pytest.mark.parametrize("num_shards", SHARDS)
def test_port_matches_reference_on_carried_state(worlds, num_shards):
    """The port's search on the reference's carried state against the
    reference's own ``ShardedDQF.search`` (stacked at S > 1), every
    tenant the world has: ids equal, dists within rtol 1e-5, divergent
    lanes named; fused and composed give the same bits."""
    x, q, get = worlds
    jsd, _ = world = get(num_shards)
    sd, composed = _twin(world, fused=True), _twin(world, fused=False)
    tenants = ["default"] + (["a", "b"] if num_shards == 3 else [])
    for t in tenants:
        mine = sd.search(q, record=False, tenant=t)
        _divergent_lanes(jsd.search(q, record=False, tenant=t), mine)
        again = composed.search(q, record=False, tenant=t)
        np.testing.assert_array_equal(mine.ids, again.ids)
        np.testing.assert_array_equal(mine.dists, again.dists)


def test_counters_fed_once_per_query(worlds):
    """``tests/test_sharded.py:145-155``: every shard's Alg-2 clock moves
    by the query count; each winner counts on its owning shard."""
    x, q, get = worlds
    sd = _twin(get(3), fused=True)
    base = [sh.dqf.tenants.default.counter.since_rebuild for sh in sd.shards]
    counts = [sh.dqf.tenants.default.counter.counts.copy()
              for sh in sd.shards]
    res = sd.search(q, record=True, auto_rebuild=False)
    for s, (sh, b) in enumerate(zip(sd.shards, base)):
        c = sh.dqf.tenants.default.counter
        assert c.since_rebuild == b + q.shape[0]
        won = [e for e in res.ids.ravel().tolist() if sd._owner[e] == s]
        assert c.counts.sum() - counts[s].sum() == len(won)


def test_degraded_counts_and_merge(worlds):
    """``tests/test_sharded.py:224-231``, and the result is
    ``merge_with_dropout`` over the live shards' own searches."""
    x, q, get = worlds
    sd = _twin(get(3), fused=True)
    ids, dists, cov = sd.search_degraded(q, [True, True, False])
    assert cov == pytest.approx(2 / 3)
    sc = sd.scrape()
    assert sc["shard_responses_total{shard=0}"] == 1.0
    assert sc["shard_dropout_total"] == 1.0
    per_i, per_d = [], []
    for sh in sd.shards[:2]:
        r = sh.dqf.search(q, record=False)
        per_i.append(sh.dqf.to_external(r.ids.numpy()))
        per_d.append(r.dists.numpy())
    want = merge_with_dropout(per_i, per_d, [True, True], sd.cfg.k)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dists, want[1])
    assert {sd._owner[e] for e in ids.ravel().tolist()} <= {0, 1}


def test_memory_report_per_shard_splits(worlds):
    """``tests/test_sharded.py:246-256``; the port's report equals the
    reference's on the same state."""
    x, q, get = worlds
    jsd, _ = world = get(3)
    mr = _twin(world).memory_report()
    assert len(mr["per_shard"]) == 3
    for entry in mr["per_shard"]:
        assert set(entry) == {"device", "host", "disk"}
    for tier in ("device", "host", "disk"):
        assert mr[tier]["total"] == sum(e[tier]["total"]
                                        for e in mr["per_shard"])
    assert mr["total"] > 0
    assert mr == jsd.memory_report()


def test_port_build_deals_as_reference(worlds):
    """The port's own build at S = 4: the reference's partition (owner
    map, per-shard rows and ext ids), then warm (targets by the merged
    baseline search) and search ≡ oracle on the port-built graphs."""
    x, q, get = worlds
    jsd, _ = get(4)
    sd = ShardedDQF(port_cfg(jsd.cfg, fused=True), 4, device="cpu").build(x)
    assert sd._owner == jsd._owner
    for mine, ref in zip(sd.shards, jsd.shards):
        np.testing.assert_array_equal(mine.dqf.store.ext_ids,
                                      ref.dqf.store.ext_ids)
        np.testing.assert_array_equal(mine.dqf.store.x, ref.dqf.store.x)
    sd.warm(q[:8])
    _assert_parity(sd, q)


# ---------------------------------------------------------- scrape, errors
def test_scrape_labels_per_shard_series(worlds):
    """``tests/test_sharded.py:234-243``."""
    x, q, get = worlds
    sd = _twin(get(2))
    sd.search(q, record=True)
    sc = sd.scrape()
    assert sc["sharded_search_queries_total"] == q.shape[0]
    assert sc["sharded_search_batches_total"] == 1.0
    assert sc["shard_count"] == 2.0
    assert sc["shard_rebalanced_rows_total"] == 0.0
    for s in range(2):
        assert any(k.endswith(f"shard={s}}}") for k in sc)
    assert "shard_count" in sd.exposition()


@pytest.mark.parametrize("case", ["too_few_rows", "ext_past_int32",
                                  "ext_shape", "mesh_without_cards",
                                  "before_build",
                                  "unknown_tenant"])
def test_refusals(worlds, case):
    x, q, get = worlds
    cfg = port_cfg(JConfig(**CFG))
    if case == "too_few_rows":
        with pytest.raises(ValueError, match="cannot fill"):
            ShardedDQF(cfg, 4, device="cpu").build(x[:7])
    elif case == "ext_past_int32":
        with pytest.raises(ValueError, match="int32"):
            ShardedDQF(cfg, 2, device="cpu").build(
                x[:8], ext_ids=np.arange(8) + 2 ** 31)
    elif case == "ext_shape":
        with pytest.raises(ValueError, match="one external id"):
            ShardedDQF(cfg, 2, device="cpu").build(x[:8],
                                                   ext_ids=np.arange(5))
    elif case == "mesh_without_cards":
        # no process group here: a world of one rank, fewer than 2 shards
        with pytest.raises(RuntimeError, match="use_mesh=True needs >= 2 "
                                               "ranks, have 1"):
            ShardedDQF(cfg, ShardConfig(num_shards=2, use_mesh=True),
                       device="cpu").build(x)
    elif case == "before_build":
        with pytest.raises(RuntimeError, match="build"):
            ShardedDQF(cfg, 2, device="cpu").search(q)
    else:
        with pytest.raises(KeyError):
            _twin(get(2)).search(q, record=False, tenant="nobody")


def test_config_validation_and_ids():
    with pytest.raises(ValueError):
        ShardConfig(num_shards=0)
    with pytest.raises(ValueError):
        ShardConfig(rebalance_imbalance=1.0)
    sd = ShardedDQF(port_cfg(JConfig(**CFG)), 3, device="cpu")
    assert sd.num_shards == 3 and sd.scfg == ShardConfig(num_shards=3)
    np.testing.assert_array_equal(sd.to_external(np.array([[4, -1, -7]])),
                                  [[4, -1, -1]])
