"""The port's ``ShardedEngine`` over shards placed one a rank, over real
gloo worlds of 2 and 4 ranks, against the one-process port engine.

A port ``ShardedDQF`` at S = 2 and 4 is built here from seeded rows (1,200
x 16, the rows of ``tests/test_distributed.py::
test_sharded_dqf_mesh_parity_8dev``), warmed, a second tenant "a" warmed,
the tree fitted, and saved shard by shard.  Each rank of a world of S
(``tests/_torch_dist.py::engine_world``) carries the saved shards into a
placed index (``use_mesh=True``) and into a one-process twin
(``use_mesh=False``) and serves both, case by case: fixed fused, fixed
composed, paged, each with two tenants; a chaos plan (shard 1 failing for
four ticks, shard 0 stalled twice, one quarantine) fixed and paged;
churn, fixed and paged (insert 4 rows between ticks, which grows every
shard's capacity mid-flight, and delete 10, with traffic pinned to five
of shard 0's rows as ``tests/test_sharded.py:158-181`` pins it, then the
auto-compaction with the rebalance); and a deadline that falls between
the ranks' clocks (rank r reads the clock ``0.003 r`` s ahead of rank
0).

Contracts: on every rank the placed engine's results (ids, dists bit for
bit, hops, status, degraded, shards responding), ticks, tenant counters,
owner map, compactions and quarantines equal the one-process engine's;
each rank ticks one shard's lanes; at most one collective a tick (the
drain's collectives, one broadcast a ``submit`` aside, are at most its
ticks and the first refill's broadcast).  The comparison with the
reference's placed engine is ``tests/test_torch_dist_index.py``.
"""

import numpy as np
import pytest

from repro_torch.core import DQFConfig
from repro_torch.sharding import ShardedDQF
from tests import _torch_dist as td
from tests._torch_threads import one_torch_thread  # noqa: F401

CFG = dict(dim=16, k=5, hot_pool=16, full_pool=16, max_hops=100,
           n_query_trigger=10_000)
CASES = ["fixed fused", "fixed composed", "paged", "chaos fixed",
         "chaos paged", "churn", "churn paged", "deadline"]
WORLDS = (2, 4)
DEADLINE_S = 0.010          # engine_world's deadline and clock steps
STEP_S = 0.004


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_engine")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1200, 16)).astype(np.float32)
    q = x[rng.choice(1200, 32, replace=False)] + \
        0.05 * rng.standard_normal((32, 16)).astype(np.float32)
    qa = x[rng.choice(1200, 16, replace=False)] + \
        0.05 * rng.standard_normal((16, 16)).astype(np.float32)
    new = rng.standard_normal((4, 16)).astype(np.float32)
    out = {}
    for S in WORLDS:
        sd = ShardedDQF(DQFConfig(**CFG), S, device="cpu").build(x)
        sd.warm(q[:8])
        sd.warm(qa[:8], tenant="a")
        sd.fit_tree(np.concatenate([q, qa]))
        st0 = sd.shards[0].dqf.store
        own0 = st0.ext_ids[:st0.n][st0.alive[:st0.n]]
        hot = x[own0[:48]] + 0.01 * rng.standard_normal(
            (48, 16)).astype(np.float32)
        live = np.asarray(sorted(sd._owner), np.int64)
        tree = {"q": q, "qa": qa, "hot_q": hot, "new_rows": new,
                "delete_ids": rng.choice(live, 10, replace=False),
                "donor_ext": own0[:5].astype(np.int64)}
        for s, sh in enumerate(sd.shards):
            tree[f"shard{s}"] = sh.dqf.to_arrays()
        tree["owner_ext"], tree["owner_shard"] = np.asarray(
            sorted(sd._owner.items()), np.int64).T
        td.save_tree(d / f"engine{S}.npz", tree)
        out[S] = str(d / f"engine{S}.npz")
    return out


@pytest.fixture(scope="module")
def worlds(saved, tmp_path_factory):
    return {S: td.run_world(td.engine_world, S,
                            tmp_path_factory.mktemp(f"e{S}"), saved[S], CFG,
                            timeout=400)
            for S in WORLDS}


def _same_results(a: list, b: list) -> None:
    assert len(a) == len(b)
    bad = [i for i, (x, y) in enumerate(zip(a, b))
           if not (np.array_equal(x["ids"], y["ids"])
                   and np.array_equal(x["dists"].view(np.int32),
                                      y["dists"].view(np.int32))
                   and all(x[k] == y[k] for k in
                           ("hops", "status", "degraded",
                            "shards_responding", "tenant")))]
    assert not bad, f"queries {bad[:10]} differ"


def _same_counters(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a[:-1], b[:-1]):
        assert x.keys() == y.keys()
        for name in x:
            np.testing.assert_array_equal(x[name][0], y[name][0])
            assert x[name][1] == y[name][1]
    assert a[-1] == b[-1]                     # the owner map


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("S", WORLDS)
def test_placed_engine_equals_one_process(worlds, S, case):
    first = worlds[S][0][case][True]
    for res in worlds[S]:
        placed, one = res[case][True], res[case][False]
        _same_results(placed["results"], one["results"])
        _same_results(placed["results"], first["results"])
        assert placed["ticks"] == one["ticks"] > 0
        _same_counters(placed["counters"], one["counters"])
        for key in ("compactions", "rebalanced", "quarantines"):
            assert placed[key] == one[key], key
        assert placed["rows"] == 1 and one["rows"] == S
        if placed["lanes"] is not None:
            assert placed["lanes"] * S <= one["lanes"] + S


@pytest.mark.parametrize("S", WORLDS)
def test_one_collective_a_tick(worlds, S):
    for res in worlds[S]:
        for case in CASES:
            placed, one = res[case][True], res[case][False]
            assert one["collectives"] == 0
            assert 0 < placed["collectives"] <= placed["ticks"] + 1, case


@pytest.mark.parametrize("S", WORLDS)
def test_chaos_and_churn_cases_bite(saved, worlds, S):
    """The chaos plan degrades results and quarantines shard 1; the churn
    case compacts, rebalances, and serves no deleted row to the queries
    submitted after the delete."""
    out = worlds[S][0]
    for case in ("chaos fixed", "chaos paged"):
        r = out[case][True]
        assert r["quarantines"] >= 1
        assert any(x["status"] == "degraded" for x in r["results"])
        assert any(x["status"] == "ok" for x in r["results"])
    dead = set(td.load_tree(saved[S])["delete_ids"].tolist())
    for case in ("churn", "churn paged"):
        churn = out[case][True]
        assert churn["compactions"] >= 1 and churn["rebalanced"] > 0
        assert all(x["status"] == "ok" for x in churn["results"])
        late = np.stack([x["ids"] for x in churn["results"][-32:]])
        assert not dead & set(late.ravel().tolist())


@pytest.mark.parametrize("S", WORLDS)
def test_deadline_between_rank_clocks(worlds, S):
    """At the second tick rank 0 reads 0.008 s, before the 0.010 s
    deadline, and the last rank reads past it: on its own clock it would
    expire lanes a tick early.  Every rank expires what the one-process
    engine on rank 0's clock expires."""
    last = worlds[S][-1]["offset"]
    assert 2 * STEP_S < DEADLINE_S <= 2 * STEP_S + last
    for res in worlds[S]:
        got = [x["status"] for x in res["deadline"][True]["results"]]
        assert got == [x["status"] for x in
                       res["deadline"][False]["results"]]
        assert "deadline" in got and "ok" in got
