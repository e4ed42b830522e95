"""The port's frozen segment index (``repro_torch.serving.sharded``)
against the reference's ``repro.serving.sharded`` on the CPU.

The reference searches its 4 segments under ``shard_map`` on 4 virtual
CPU devices, so it runs in a subprocess with
``--xla_force_host_platform_device_count=4`` (as
``tests/test_distributed.py`` does) on the data of its own recall test:
2000 x 16 normal rows, ``SSGParams(knn_k=12, out_degree=12)``,
``DQFConfig(k=10, full_pool=32, max_hops=150)``.  The port builds the
same index arrays and its stacked one-card search returns the same ids,
dists within rtol 1e-5; divergent lanes are named.  The remainder
padding, the tiny-segment refusal, the cross-segment merge's tie order
against ``lax.top_k`` and a mesh without its process group are checked
on the port.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.core import DQFConfig
from repro_torch.core import beam_search as bs
from repro_torch.core.ssg import SSGParams
from repro_torch.serving.sharded import (ShardedIndex, _stacked_search,
                                         build_sharded_index, sharded_search)
from repro_torch.sharding.merge import merge_topk, merge_topk_host
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = SSGParams(knn_k=12, out_degree=12)
CFG = DQFConfig(k=10, full_pool=32, max_hops=150)
FIELDS = ("x_pad", "adj_pad", "entries", "offsets")

REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from repro.core import DQFConfig
    from repro.core.ssg import SSGParams
    from repro.serving.sharded import build_sharded_index, sharded_search
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    q = x[rng.choice(2000, 64, replace=False)] + \\
        0.05 * rng.standard_normal((64, 16)).astype(np.float32)
    idx = build_sharded_index(x, 4, SSGParams(knn_k=12, out_degree=12))
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    cfg = DQFConfig(k=10, full_pool=32, max_hops=150)
    ids, dists = sharded_search(idx, q, mesh, cfg=cfg)
    np.savez(sys.argv[1], x=x, q=q, x_pad=idx.x_pad, adj_pad=idx.adj_pad,
             entries=idx.entries, offsets=idx.offsets,
             n_total=idx.n_total, ids=ids, dists=dists)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("segments") / "reference.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_index(reference):
    return build_sharded_index(reference["x"], 4, PARAMS, device="cpu")


def reference_index(ref) -> ShardedIndex:
    return ShardedIndex(**{f: ref[f] for f in FIELDS},
                        n_total=int(ref["n_total"]))


def test_build_equals_reference(reference, port_index):
    for f in FIELDS:
        got, want = getattr(port_index, f), reference[f]
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert port_index.n_total == int(reference["n_total"]) == 2000
    assert port_index.num_shards == 4


@pytest.mark.parametrize("built_by", ["port", "reference"])
def test_search_equals_reference(reference, port_index, built_by):
    index = port_index if built_by == "port" else reference_index(reference)
    ids, dists = sharded_search(index, reference["q"], cfg=CFG,
                                device="cpu")
    assert ids.shape == dists.shape == (64, 10)
    assert ids.dtype == np.int32 and dists.dtype == np.float32
    lanes = np.flatnonzero((ids != reference["ids"]).any(axis=1))
    assert lanes.size == 0, f"divergent lanes {lanes.tolist()}"
    np.testing.assert_allclose(dists, reference["dists"], rtol=1e-5)


def test_fused_route_equals_composed(reference):
    """The card's route (the fused hop over the per-lane table base, here
    its plain version) gives the composed loop's bits."""
    tables = reference_index(reference).upload("cpu")
    q = torch.as_tensor(reference["q"])
    kw = dict(pool_size=CFG.full_pool, k=CFG.k, max_hops=CFG.max_hops)
    fi, fd = _stacked_search(tables, q, fused=True, **kw)
    ci, cd = _stacked_search(tables, q, fused=False, **kw)
    assert torch.equal(fi, ci) and torch.equal(fd, cd)


def test_stacked_equals_per_segment_oracle(reference):
    """The stacked pass ≡ one plain ``beam_search`` a segment merged on
    the host (the oracle of ``chip_smoke.py`` phase 16), bit for bit."""
    index = reference_index(reference)
    ids, dists = sharded_search(index, reference["q"], cfg=CFG,
                                device="cpu")
    q = torch.as_tensor(reference["q"])
    n_seg = index.offsets.shape[1]
    per_i, per_d = [], []
    for s in range(index.num_shards):
        res = bs.beam_search(torch.as_tensor(index.x_pad[s]),
                             torch.as_tensor(index.adj_pad[s]),
                             torch.as_tensor(index.entries[s]), q,
                             pool_size=CFG.full_pool, k=CFG.k,
                             max_hops=CFG.max_hops)
        local = res.ids.numpy()
        rows = index.offsets[s][np.minimum(local, n_seg - 1)]
        bad = (local >= n_seg) | (rows < 0)
        per_i.append(np.where(bad, -1, rows))
        per_d.append(np.where(bad, np.inf, res.dists.numpy()))
    want_i, want_d = merge_topk_host(per_i, per_d, CFG.k)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_array_equal(dists, want_d)


def test_remainder_padding_keeps_the_id_map_exact():
    """``tests/test_sharded.py::test_build_sharded_index_remainder`` on
    the port, and a search over the padded segments."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1003, 12)).astype(np.float32)
    idx = build_sharded_index(x, 4, SSGParams(knn_k=10, out_degree=10),
                              device="cpu")
    assert idx.x_pad.shape[1] == 252           # ceil(1003/4) + sentinel
    offs = idx.offsets
    real = offs[offs >= 0]
    assert np.array_equal(np.sort(real), np.arange(1003))
    assert (offs < 0).sum() == 4 * 251 - 1003
    ids, dists = sharded_search(idx, x[:16], cfg=CFG, device="cpu")
    assert np.array_equal(ids[:, 0], np.arange(16))
    assert np.all(ids >= 0) and np.all(np.isfinite(dists))


def test_rejects_tiny_segments():
    x = np.zeros((5, 4), np.float32)
    with pytest.raises(ValueError, match="< 2 rows"):
        build_sharded_index(x, 4, SSGParams(knn_k=2, out_degree=2),
                            device="cpu")


def _merge_case(kind):
    """(S, B, k) per-segment answers, each sorted: distances on a coarse
    grid so equal values recur within and across segments; with "inf"
    the tails are +inf padding slots (id -1)."""
    rng = np.random.default_rng(17)
    S, B, k = 4, 32, 10
    d = np.sort(rng.integers(0, 6, (S, B, k)).astype(np.float32) / 2, -1)
    g = rng.integers(0, 10_000, (S, B, k)).astype(np.int32)
    if kind == "inf":
        tail = rng.integers(0, k + 1, (S, B))
        pad = np.arange(k)[None, None, :] >= tail[..., None]
        d = np.where(pad, np.inf, d).astype(np.float32)
        g = np.where(pad, -1, g).astype(np.int32)
    return d, g, k


@pytest.mark.parametrize("kind", ["ties", "inf"])
def test_merge_topk_orders_ties_as_lax_top_k(kind):
    """The reference merges by ``lax.top_k(-all_d, k)`` over the
    segment-major gather; ``merge_topk`` (one ``pool_merge``) is a stable
    sort of the same concatenation.  Equal distances go to the earlier
    segment in both, +inf padding included."""
    d, g, k = _merge_case(kind)
    S, B, _ = d.shape
    all_d = d.transpose(1, 0, 2).reshape(B, S * k)
    all_i = g.transpose(1, 0, 2).reshape(B, S * k)
    neg, idx = jax.lax.top_k(-jnp.asarray(all_d), k)
    want_i = np.take_along_axis(all_i, np.asarray(idx), 1)
    got_i, got_d = merge_topk(torch.as_tensor(d), torch.as_tensor(g), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), -np.asarray(neg))
    assert (all_d[:, 1:] == all_d[:, :-1]).any()        # ties were there


class _Mesh:
    """A mesh as the reference's ``jax.make_mesh`` gives it: axis sizes
    under ``shape``."""

    def __init__(self, **shape):
        self.shape = shape


def test_mesh_over_cards_is_refused(reference):
    """A (1, 4) mesh without its process group (no world here) is
    refused; a mesh of one device searches on one card.  The mesh path
    over real worlds is ``tests/test_torch_dist_index.py``."""
    from repro_torch.launch.mesh import make_test_mesh

    index = reference_index(reference)
    with pytest.raises(RuntimeError, match="process group"):
        sharded_search(index, reference["q"], _Mesh(data=1, model=4),
                       cfg=CFG, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_test_mesh(1, 4)
    ids, _ = sharded_search(index, reference["q"], _Mesh(data=1, model=1),
                            cfg=CFG, device="cpu")
    np.testing.assert_array_equal(ids, reference["ids"])


def test_tables_upload_once_per_device(reference):
    index = reference_index(reference)
    first = index.upload("cpu")
    sharded_search(index, reference["q"], cfg=CFG, device="cpu")
    assert all(a is b for a, b in zip(index.upload("cpu"), first))
    assert list(index._tables) == ["cpu"]
    np.testing.assert_array_equal(first[1].numpy(), index.adj_pad)
