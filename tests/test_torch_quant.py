"""Port of the quantized Full Index (``repro_torch.quant``) against the JAX
package.

* Training and encoding are the reference's numpy: the same data and seed
  give byte-equal codes and codebooks, for sq8 and pq.
* ``pq_luts`` within rtol 1e-5 (the port sums each subspace in halving
  order).
* The plain fused hop in ``sq8`` and ``pq`` mode ≡ the reference's on the
  synthetic worlds, fed the same codes and LUTs: ids, flags, seen bitmap
  and counters equal, dists within rtol 1e-5.
* Quantized ``dynamic_search`` (rerank on and off, fused and composed) ≡
  the reference's on a reference DQF built with quantization and carried
  over by ``dqf_from_arrays``: ids, ``dist_count`` and
  ``terminated_early`` per lane, dists within rtol 1e-5, at most 1% of
  lanes diverging through a near-tie, listed.
* Within the port, fused ≡ composed bit for bit for sq8 and pq.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import quant as jquant
from repro.core import DQF as JDQF
from repro.core import DQFConfig as JConfig
from repro.core import QuantConfig as JQuant
from repro.core import ZipfWorkload
from repro.core import beam_search as jbs
from repro.core.dynamic_search import dynamic_search as j_dynamic
from repro.kernels import ref as jref
from repro_torch import quant as tquant
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import QuantConfig as TQuant
from repro_torch.core.dynamic_search import dynamic_search as t_dynamic
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.test_torch_cuda import make_tree, make_world, quant_table
from tests.test_torch_fused_hop import J, T, diverging_lanes, port_state
from tests.test_torch_search import assert_lanes_match, port_cfg
from tests._torch_threads import one_torch_thread  # noqa: F401

MODES = {"sq8": dict(mode="sq8"), "pq": dict(mode="pq")}


def port_quant_cfg(jcfg, **over):
    q = jcfg.quant
    return port_cfg(jcfg, quant=TQuant(
        mode=q.mode, pq_m=q.pq_m, pq_bits=q.pq_bits, pq_iters=q.pq_iters,
        rerank_k=q.rerank_k, seed=q.seed), **over)


@pytest.fixture(scope="module")
def jax_quant(small_data):
    """Reference DQFs with an sq8 and a pq Full Index, tree trained on the
    codes, saved and read back as ``np.load`` gives them."""
    import tempfile

    out = {}
    wl = ZipfWorkload(small_data, beta=1.2, sigma=0.05, seed=1)
    _, targets = wl.sample(4000, with_targets=True)
    fit_q = wl.sample(400)
    for name, kw in MODES.items():
        cfg = JConfig(knn_k=12, out_degree=12, index_ratio=0.03, k=10,
                      hot_pool=16, full_pool=32, eval_gap=40, max_hops=120,
                      n_query_trigger=100_000, quant=JQuant(**kw))
        dqf = JDQF(cfg).build(small_data)
        dqf.counter.record(targets)
        dqf.rebuild_hot()
        dqf.fit_tree(fit_q)
        with tempfile.TemporaryDirectory() as tmp:
            dqf.save(f"{tmp}/dqf.npz")
            with np.load(f"{tmp}/dqf.npz") as z:
                arrays = {k: z[k] for k in z.files}
        out[name] = (dqf, arrays)
    return out


@pytest.fixture(scope="module")
def queries(small_data):
    return ZipfWorkload(small_data, seed=5).sample(200)


# ------------------------------------------------------------- quantizers
@pytest.mark.parametrize("name", ["sq8", "pq"])
def test_codes_and_codebooks_byte_equal(small_data, name):
    want = jquant.build_quantizer(small_data, JQuant(**MODES[name]))
    got = tquant.build_quantizer(small_data, TQuant(**MODES[name]))
    assert got.mode == want.mode
    assert got.codes.dtype == want.codes.dtype
    np.testing.assert_array_equal(got.codes, want.codes)
    if name == "sq8":
        np.testing.assert_array_equal(got.sq.scale, want.sq.scale)
        np.testing.assert_array_equal(got.sq.zero, want.sq.zero)
    else:
        np.testing.assert_array_equal(got.pq.centroids, want.pq.centroids)
    assert got.nbytes() == want.nbytes()
    np.testing.assert_array_equal(got.decode(), want.decode())


def test_pq_training_over_many_chunks_byte_equal():
    """Above one assignment chunk (65536 rows) the port assigns chunks on
    threads and sums clusters with bincount; the bits stay the
    reference's, empty-cluster reseeds included."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((140_000, 8)).astype(np.float32)
    x[:70_000, :4] = 0.0                   # many duplicates, empty clusters
    want = jquant.train_pq(x, m=2, k=64, iters=3, seed=4)
    got = tquant.train_pq(x, m=2, k=64, iters=3, seed=4)
    np.testing.assert_array_equal(got.centroids, want.centroids)
    np.testing.assert_array_equal(tquant.pq_encode(x, got),
                                  jquant.pq_encode(x, want))


def test_pq_luts_match_reference(small_data):
    cb = tquant.train_pq(small_data, m=8, k=64, iters=5, seed=3)
    q = np.random.default_rng(2).standard_normal((17, 24)).astype(np.float32)
    want = jquant.pq_luts(jnp.asarray(q), jnp.asarray(cb.centroids))
    got = tquant.pq_luts(torch.as_tensor(q), torch.as_tensor(cb.centroids))
    assert got.shape == (17, 8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_quant_state_arrays_round_trip(small_data):
    for name in MODES:
        st = tquant.build_quantizer(small_data[:300], TQuant(**MODES[name]))
        back = tquant.QuantState.from_arrays(st.to_arrays())
        np.testing.assert_array_equal(back.codes, st.codes)
        table = back.device_table(capacity=310, device="cpu")
        assert table.n == 310 and table.codes.shape[0] == 311
        assert not table.codes[300:].any()


# ------------------------------------------------------------ plain hop
@pytest.mark.parametrize("mode", ["sq8", "pq"])
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("use_tree", [False, True])
@pytest.mark.parametrize("use_live", [False, True])
def test_quant_hop_matches_jax_reference(mode, B, use_tree, use_live):
    x_pad, adj_pad, live = make_world(seed=B)
    rng = np.random.default_rng(200 + B)
    q = rng.standard_normal((B, 18)).astype(np.float32)
    table = quant_table(x_pad, mode, T(q))
    spec = tops.table_spec(table)
    jspec = (mode,) + tuple(None if t is None else J(t.numpy())
                            for t in spec[1:])
    entries = np.arange(0, 220, 37).astype(np.int32)
    live_pad = live if use_live else None
    hs = jbs.to_hop_state(jbs.init_state(J(x_pad), J(q), J(entries), 16,
                                         J(live_pad)))
    tree = make_tree() if use_tree else None
    hf = rng.uniform(1, 6, B).astype(np.float32) if use_tree else None
    hr = rng.uniform(0.5, 1.5, B).astype(np.float32) if use_tree else None
    kw = dict(hops=15, max_hops=40, k=5, eval_gap=25, add_step=6,
              tree_depth=4)
    want = jref.fused_hop(hs, J(adj_pad), J(q), J(live_pad), *jspec,
                          None if tree is None else tuple(map(J, tree)),
                          J(hf), J(hr), **kw)
    got = tref.fused_hop(port_state(hs), T(adj_pad), T(q), T(live_pad),
                         *spec, None if tree is None else tuple(map(T, tree)),
                         T(hf), T(hr), **kw)
    assert diverging_lanes(want, got) == [], "lanes diverge from JAX"


@pytest.mark.parametrize("mode", ["sq8", "pq"])
def test_quant_scorers_are_the_hop_scorers(mode):
    """SQTable/PQView.gather_score are ref's scorers: composed ≡ fused."""
    x_pad, _, _ = make_world()
    q = T(np.random.default_rng(8).standard_normal((5, 18))
          .astype(np.float32))
    table = quant_table(x_pad, mode, q)
    cols = T(np.random.default_rng(9).integers(0, 221, (5, 7))
             .astype(np.int32))
    got = table.gather_score(q, cols)
    want = tref._gather_score(*tops.table_spec(table), q, cols)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------------------------------- dynamic search
@pytest.mark.parametrize("name", ["sq8", "pq"])
@pytest.mark.parametrize("rerank_k", [0, 64])
@pytest.mark.parametrize("fused", [False, True])
def test_quant_dynamic_search_matches_reference(jax_quant, queries, name,
                                                rerank_k, fused):
    dqf, arrays = jax_quant[name]
    port = dqf_from_arrays(arrays, port_quant_cfg(dqf.cfg), device="cpu")
    c = dqf.cfg
    kw = dict(k=c.k, hot_pool_size=c.hot_pool, full_pool_size=c.full_pool,
              eval_gap=c.eval_gap, add_step=c.add_step,
              tree_depth=c.tree_depth, max_hops=c.max_hops,
              rerank_k=rerank_k)
    hd = dqf.tenants.default.hot_tables(dqf.store)
    want, _, _ = j_dynamic(
        dqf._dev["x_pad"], dqf._dev["adj_pad"], hd["x_hot_pad"],
        hd["adj_hot_pad"], hd["hot_ids_pad"], hd["hot_entries"],
        dqf.tree.arrays, jnp.asarray(queries), qtable=dqf._quant_table(),
        live_pad=dqf._dev["live_pad"], **kw)
    th = port.hot_tables()
    got, _, _ = t_dynamic(
        port._dev["x_pad"], port._dev["adj_pad"], th["x_hot_pad"],
        th["adj_hot_pad"], th["hot_ids_pad"], th["hot_entries"],
        port.tree.arrays, torch.as_tensor(queries),
        qtable=port._quant_table(), live_pad=port._dev["live_pad"],
        fused=fused, fused_hops=4, **kw)
    assert_lanes_match(want, got)
    assert got.stats.terminated_early.any()


@pytest.mark.parametrize("name", ["sq8", "pq"])
def test_quant_fused_equals_composed_within_port(jax_quant, queries, name):
    dqf, arrays = jax_quant[name]
    a = dqf_from_arrays(arrays, port_quant_cfg(dqf.cfg, fused=False),
                        device="cpu")
    b = dqf_from_arrays(arrays, port_quant_cfg(dqf.cfg, fused=True,
                                               fused_hops=5), device="cpu")
    for fn in ("search", "search_dual_beam"):
        kw = dict(record=False) if fn == "search" else {}
        ra, rb = getattr(a, fn)(queries, **kw), getattr(b, fn)(queries, **kw)
        assert torch.equal(ra.ids, rb.ids)
        assert torch.equal(ra.dists.view(torch.int32),
                           rb.dists.view(torch.int32))
        for f in ra.stats._fields:
            assert torch.equal(getattr(ra.stats, f), getattr(rb.stats, f)), f


# ------------------------------------------------------------- checkpoint
@pytest.mark.parametrize("name", ["sq8", "pq"])
def test_quant_checkpoint_searches_like_reference(jax_quant, queries, name):
    """Reference DQF.save → np.load → dqf_from_arrays → DQF.search."""
    dqf, arrays = jax_quant[name]
    port = dqf_from_arrays(arrays, port_quant_cfg(dqf.cfg, fused=True),
                           device="cpu")
    assert port.quant.mode == name
    np.testing.assert_array_equal(port.quant.codes, dqf.quant.codes)
    assert port._rerank_k == dqf._rerank_k == 64
    assert_lanes_match(dqf.search(queries, record=False),
                       port.search(queries, record=False),
                       ("dist_count", "terminated_early"))
    assert_lanes_match(dqf.search_dual_beam(queries),
                       port.search_dual_beam(queries), ("dist_count",))


def test_quant_checkpoint_mode_is_checked(jax_quant):
    dqf, arrays = jax_quant["sq8"]
    with pytest.raises(ValueError, match="saved 'sq8'"):
        dqf_from_arrays(arrays, port_quant_cfg(
            dataclasses.replace(dqf.cfg, quant=JQuant(mode="pq"))),
            device="cpu")
    plain = {k: v for k, v in arrays.items() if not k.startswith("quant_")}
    with pytest.raises(ValueError, match="no quantizer"):
        dqf_from_arrays(plain, port_quant_cfg(dqf.cfg), device="cpu")
    port = dqf_from_arrays(arrays, port_cfg(dqf.cfg), device="cpu")
    assert port._quant_table() is None and port._rerank_k == 0
