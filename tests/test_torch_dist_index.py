"""The port's sharded indexes placed one shard a rank, over real gloo worlds
of 2 and 4 ranks, against the reference on 4 faked devices.

The reference (one subprocess, ``--xla_force_host_platform_device_count
=4``) builds ``ShardedDQF(use_mesh=True)`` at S = 2 and 4 over the 1,200
x 16 rows of ``tests/test_distributed.py::test_sharded_dqf_mesh_parity_8dev``,
warms it, saves each shard, searches, inserts 4 rows, deletes 10 and
searches again; and it searches the 2,000 x 16 rows of
``test_sharded_dqf_search_recall`` in 4 segments on a (1, 4) mesh and in
2 on a (2, 2) mesh (the model axis holds the segments).  The
ranks (``tests/_torch_dist.py``) carry the saved shards into a placed
port ``ShardedDQF`` (world = S) beside a one-card twin, and search the
reference's segment arrays through port meshes.

Contracts: placed ≡ one-card stacked ≡ ``search_oracle``, ids and dists
bit for bit, before and after the writes; ids equal to the reference's
and dists within rtol 1e-5 (XLA's and torch's float sums); recall above
0.85; every rank holds only its shard's table; the port's own build
placed ≡ its oracle.  After the writes the reference serves the 32
queries through its ``ShardedEngine`` over the placed index (wave 8, 4
hops a tick), as ``test_sharded_dqf_mesh_parity_8dev`` does; the port's
placed engine equals its one-card engine bit for bit and the reference's
ids, dists within rtol 1e-5, with the ticks equal and recall within 0.1
of the search's.  The segment
search over both meshes equals the one-card stacked search bit for bit
and the reference's ids, dists within rtol 1e-5, recall above 0.9; a
batch that does not divide the data axis is padded, a model axis unequal
to S refuses and each rank uploads only its segment.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core import ground_truth, recall_at_k
from tests import _torch_dist as td
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(dim=16, k=5, hot_pool=16, full_pool=16, max_hops=100,
           n_query_trigger=10_000)
SEG_CFG = dict(k=10, full_pool=32, max_hops=150)
SHAPES = [(1, 4), (2, 2)]

REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from repro.core import DQFConfig
    from repro.core.ssg import SSGParams
    from repro.serving.sharded import build_sharded_index, sharded_search
    from repro.sharding import ShardConfig, ShardedDQF, ShardedEngine
    d = sys.argv[1]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1200, 16)).astype(np.float32)
    q = x[rng.choice(1200, 32, replace=False)] + \\
        0.05 * rng.standard_normal((32, 16)).astype(np.float32)
    new = rng.standard_normal((4, 16)).astype(np.float32)
    dele = rng.choice(1200, 10, replace=False).astype(np.int64)
    cfg = DQFConfig(dim=16, k=5, hot_pool=16, full_pool=16, max_hops=100,
                    n_query_trigger=10_000)
    for S in (2, 4):
        sd = ShardedDQF(cfg, ShardConfig(num_shards=S,
                                         use_mesh=True)).build(x)
        sd.warm(q[:8])
        n_dev = len(sd._sync_stacked()["x_pad"].sharding.device_set)
        for s, sh in enumerate(sd.shards):
            sh.dqf.save(f"{d}/s{S}_shard{s}.npz")
        owner = np.asarray(sorted(sd._owner.items()), np.int64)
        a = sd.search(q, record=False)
        ins = sd.insert(new)
        sd.delete(dele)
        b = sd.search(q, record=False)
        eng = ShardedEngine(sd, wave_size=8, tick_hops=4)
        rids = eng.submit(q)
        res = eng.run_until_drained()["results"]
        np.savez(f"{d}/s{S}.npz", x=x, q=q, new_rows=new, delete_ids=dele,
                 before_ids=np.asarray(a.ids),
                 before_dists=np.asarray(a.dists),
                 after_ids=np.asarray(b.ids), after_dists=np.asarray(b.dists),
                 inserted=np.asarray(ins), devices=n_dev, owner=owner,
                 engine_ids=np.stack([res[r]["ids"] for r in rids]),
                 engine_dists=np.stack([res[r]["dists"] for r in rids]),
                 engine_ticks=eng.stats.ticks)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    q = x[rng.choice(2000, 64, replace=False)] + \\
        0.05 * rng.standard_normal((64, 16)).astype(np.float32)
    cfg = DQFConfig(k=10, full_pool=32, max_hops=150)
    for shape in ((1, 4), (2, 2)):
        idx = build_sharded_index(x, shape[1],
                                  SSGParams(knn_k=12, out_degree=12))
        mesh = jax.make_mesh(shape, ("data", "model"))
        ids, dists = sharded_search(idx, q, mesh, cfg=cfg)
        np.savez(f"{d}/segments{shape[0]}{shape[1]}.npz", x=x, q=q,
                 x_pad=idx.x_pad, adj_pad=idx.adj_pad, entries=idx.entries,
                 offsets=idx.offsets, n_total=idx.n_total, ids=ids,
                 dists=dists)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_index")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(d)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = {}
    for S in (2, 4):
        z = dict(np.load(d / f"s{S}.npz"))
        tree = {"x": z["x"], "q": z["q"], "new_rows": z["new_rows"],
                "delete_ids": z["delete_ids"]}
        for s in range(S):
            with np.load(d / f"s{S}_shard{s}.npz") as a:
                tree[f"shard{s}"] = {k: a[k] for k in a.files}
        tree["owner_ext"], tree["owner_shard"] = z["owner"].T
        td.save_tree(d / f"port{S}.npz", tree)
        ref[S] = z
    ref["segments"] = [(shape, str(d / f"segments{shape[0]}{shape[1]}.npz"))
                       for shape in SHAPES]
    return d, ref


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    d, ref = reference
    return {S: td.run_world(td.index_world, S,
                            tmp_path_factory.mktemp(f"w{S}"), str(d),
                            ref["segments"], CFG, SEG_CFG)
            for S in (2, 4)}


@pytest.mark.parametrize("S", [2, 4])
def test_placed_search_equals_stacked_and_oracle(worlds, S):
    for r, res in enumerate(worlds[S]):
        out = res["dqf"]
        assert out["rows"] == 1 and out["coordinate"] == {"shard": r}
        for tag in ("before", "after"):
            ids, dists = out[(tag, True)]
            for other in (False, "oracle"):
                np.testing.assert_array_equal(ids, out[(tag, other)][0])
                np.testing.assert_array_equal(dists, out[(tag, other)][1])
            np.testing.assert_array_equal(ids,
                                          worlds[S][0]["dqf"][(tag, True)][0])


@pytest.mark.parametrize("S", [2, 4])
def test_placed_search_equals_reference(reference, worlds, S):
    _, ref = reference
    z = ref[S]
    assert int(z["devices"]) == S          # the reference placed its tables
    out = worlds[S][0]["dqf"]
    np.testing.assert_array_equal(out["inserted"], z["inserted"])
    for tag in ("before", "after"):
        ids, dists = out[(tag, True)]
        np.testing.assert_array_equal(ids, z[f"{tag}_ids"])
        np.testing.assert_allclose(dists, z[f"{tag}_dists"], rtol=1e-5)
    gt = ground_truth(z["x"], z["q"], 5)
    assert recall_at_k(out[("before", True)][0], gt) > 0.85


@pytest.mark.parametrize("S", [2, 4])
def test_placed_own_build_equals_its_oracle(worlds, S):
    for res in worlds[S]:
        a_ids, a_d, b_ids, b_d = res["dqf"]["own"]
        np.testing.assert_array_equal(a_ids, b_ids)
        np.testing.assert_array_equal(a_d, b_d)


def test_engine_over_placed_shards_is_refused(reference, worlds):
    """The placed index's engine, refused until the engine ticked over
    ranks: now its parity with the one-card engine and the reference's
    placed engine."""
    _, ref = reference
    for S in (2, 4):
        z = ref[S]
        gt = ground_truth(z["x"], z["q"], 5)
        for res in worlds[S]:
            ids, dists, ticks, done = res["dqf"][("engine", True)]
            one = res["dqf"][("engine", False)]
            np.testing.assert_array_equal(ids, one[0])
            np.testing.assert_array_equal(dists.view(np.int32),
                                          one[1].view(np.int32))
            assert ticks == one[2] == int(z["engine_ticks"])
            assert done == 32
            np.testing.assert_array_equal(ids, z["engine_ids"])
            np.testing.assert_allclose(dists, z["engine_dists"], rtol=1e-5)
            assert recall_at_k(ids, gt) > recall_at_k(
                res["dqf"][("after", True)][0], gt) - 0.1


@pytest.mark.parametrize("shape", SHAPES)
def test_segment_search_over_a_mesh_equals_reference(reference, worlds,
                                                     shape):
    _, ref = reference
    z = np.load(dict(ref["segments"])[shape])
    S = shape[1]
    for r, res in enumerate(worlds[4]):
        ids, dists = res["seg"][shape]
        np.testing.assert_array_equal(ids, z["ids"])
        np.testing.assert_allclose(dists, z["dists"], rtol=1e-5)
        one_ids, one_d = res["seg"][(shape, "one card")]
        np.testing.assert_array_equal(ids, one_ids)
        np.testing.assert_array_equal(dists, one_d)
        odd_ids, odd_d = res["seg"][(shape, "odd")]
        np.testing.assert_array_equal(odd_ids, ids[:7])
        np.testing.assert_array_equal(odd_d, dists[:7])
        assert res["seg"][(shape, "keys")] == [f"cpu:segment{r % S}"]
        assert f"model axis of size {S}" in res["seg"][(shape, "model_axis")]
    assert recall_at_k(ids, ground_truth(z["x"], z["q"], 10)) > 0.9
