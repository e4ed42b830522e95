"""The port's kNN-LM glue, cost model, launcher and examples on the CPU.

``RetrievalService`` over a reference-built DQF carried by
``dqf_from_arrays`` (tree included): ``lookup``'s tokens and ids equal to
the JAX service's, dists within rtol 1e-5, counters fed alike;
``KNNLMHead`` within 1e-6 of the reference's head;
``tests/test_serving.py::test_retrieval_service_knnlm`` on the port;
``core.complexity`` equal to the reference's on the cases of
``tests/test_complexity_workload.py``; ``launch.serve`` and the three
examples run small.
"""

import numpy as np
import pytest
import torch

from repro.core import DQFConfig as JConfig
from repro.core import ZipfWorkload
from repro.core import complexity as jcx
from repro.serving.retrieval import KNNLMHead as JHead
from repro.serving.retrieval import RetrievalService as JService
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import DQFConfig
from repro_torch.core import complexity as tcx
from repro_torch.serving.retrieval import KNNLMHead, RetrievalService
from tests.conftest import make_clustered
from tests.test_torch_search import port_cfg
from tests._torch_threads import one_torch_thread  # noqa: F401

CFG = dict(knn_k=12, out_degree=12, index_ratio=0.03, hot_pool=16,
           full_pool=32, max_hops=120)
VOCAB = 64


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A reference service (neutral warm-up, a fitted tree) over 600
    clustered rows, saved."""
    x = make_clustered(n=600, d=16, clusters=12, seed=3)
    rng = np.random.default_rng(1)
    payload = rng.integers(0, VOCAB, x.shape[0]).astype(np.int32)
    jsvc = JService.build(x, payload, JConfig(**CFG))
    wl = ZipfWorkload(x, seed=3)
    jsvc.dqf.fit_tree(wl.sample(200))
    path = tmp_path_factory.mktemp("knnlm") / "dqf.npz"
    jsvc.dqf.save(str(path))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    queries = np.concatenate([
        x[:8] + 0.01 * rng.standard_normal((8, 16)).astype(np.float32),
        wl.sample(56)])
    return jsvc, arrays, payload, queries


def port_service(world, **over) -> RetrievalService:
    jsvc, arrays, payload, _ = world
    dqf = dqf_from_arrays(arrays, port_cfg(jsvc.dqf.cfg, **over),
                          device="cpu")
    return RetrievalService(dqf=dqf, payload=torch.as_tensor(payload))


@pytest.mark.parametrize("fused", [False, True])
def test_lookup_matches_reference(world, fused):
    jsvc, arrays, payload, q = world
    svc = port_service(world, fused=fused)
    before = jsvc.dqf.counter.counts.copy()
    jtok, jd, jids = jsvc.lookup(q)
    tok, d, ids = svc.lookup(torch.as_tensor(q))
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5)
    assert tok.dtype == torch.int32 and bool((tok == svc.payload[
        ids.long()]).all())
    # both counters fed alike (the port's starts at the saved counts)
    np.testing.assert_array_equal(svc.dqf.counter.counts - arrays["counts"],
                                  jsvc.dqf.counter.counts - before)


def test_knnlm_head_matches_reference(world):
    jsvc, _, _, q = world
    svc = port_service(world, fused=True)
    logits = np.random.default_rng(2).standard_normal(
        (q.shape[0], VOCAB)).astype(np.float32) * 3.0
    want = JHead(service=jsvc, vocab_size=VOCAB, lam=0.4,
                 temperature=2.0)(logits, q)
    head = KNNLMHead(service=svc, vocab_size=VOCAB, lam=0.4,
                     temperature=2.0)
    got = head(torch.as_tensor(logits), torch.as_tensor(q))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # mix() alone is the head's interpolation of one lookup
    tok, d, _ = svc.lookup(q)
    np.testing.assert_allclose(head.mix(logits, tok, d).numpy(), want,
                               rtol=0, atol=1e-6)


def test_retrieval_service_knnlm(small_data):
    """``tests/test_serving.py::test_retrieval_service_knnlm`` on the port."""
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 64, small_data.shape[0]).astype(np.int32)
    svc = RetrievalService.build(small_data, payload, DQFConfig(**CFG),
                                 device="cpu")
    q = small_data[:8] + 0.01 * rng.standard_normal(
        (8, small_data.shape[1])).astype(np.float32)
    tokens, dists, ids = svc.lookup(q)
    assert tokens.shape == (8, 10)
    # querying a datastore point returns its own payload first
    assert bool((tokens[:, 0] == svc.payload[ids[:, 0].long()]).all())

    head = KNNLMHead(service=svc, vocab_size=64, lam=0.5)
    logits = rng.standard_normal((8, 64)).astype(np.float32)
    probs = head(logits, q)
    np.testing.assert_allclose(probs.sum(dim=1).numpy(), 1.0, rtol=1e-4)
    assert probs.shape == (8, 64)


def test_build_with_history_warms_the_hot_index(small_data):
    wl = ZipfWorkload(small_data, seed=4)
    svc = RetrievalService.build(
        small_data, np.arange(small_data.shape[0]), DQFConfig(**CFG),
        history=wl.sample(400), device="cpu")
    dqf = svc.dqf
    assert dqf.hot.size == dqf.hot_size and dqf.counter.counts.sum() > 0
    # the hot rows are the head of the counter the history fed
    assert set(dqf.hot.ids.tolist()) == set(dqf.counter.top(
        dqf.hot_size, alive=dqf.store.alive).tolist())
    tok, _, _ = svc.lookup(small_data[:64])
    assert float((tok[:, 0] == torch.arange(64)).float().mean()) >= 0.5


# ---------------------------------------------------------------- complexity
def test_miss_probability_equals_reference_and_decreases():
    irs = np.logspace(-5, 0, 50)
    p = tcx.miss_probability(irs, 1_000_000, 1.2)
    np.testing.assert_array_equal(p, jcx.miss_probability(
        irs, 1_000_000, 1.2))
    assert (np.diff(p) <= 1e-12).all()
    assert p[-1] == pytest.approx(0.0, abs=1e-9)


def test_closed_form_matches_numeric_optimum():
    n, beta = 1_000_000, 1.2
    closed = tcx.optimal_ir_closed_form(n, beta)
    numeric = tcx.optimal_ir_numeric(n, beta)
    assert (closed, numeric) == (jcx.optimal_ir_closed_form(n, beta),
                                 jcx.optimal_ir_numeric(n, beta))
    assert closed == pytest.approx(numeric, rel=0.25)
    assert 5e-5 < closed < 1e-3


@pytest.mark.parametrize("n,beta", [(10_000, 1.05), (200_000, 1.2),
                                    (1_000_000, 1.5), (10_000_000, 2.0)])
def test_optimum_is_a_minimum(n, beta):
    ir = tcx.optimal_ir_closed_form(n, beta)
    assert ir == jcx.optimal_ir_closed_form(n, beta)
    grid = np.asarray([ir / 3, ir, ir * 3])
    np.testing.assert_array_equal(tcx.search_cost(grid, n, beta),
                                  jcx.search_cost(grid, n, beta))
    if 1.0 / n < ir < 0.5:
        c0 = tcx.search_cost(ir, n, beta)
        assert tcx.search_cost(ir * 3, n, beta) >= c0 - 1e-6
        assert tcx.search_cost(ir / 3, n, beta) >= c0 - 1e-6


# ------------------------------------------------------ launcher, examples
def test_launch_serve_runs_small():
    from repro_torch.launch import serve

    recalls = serve.main(["--device", "cpu", "--n", "600", "--requests",
                          "48", "--wave", "16", "--drift"])
    assert sorted(recalls) == ["rebuilt", "stale", "steady"]
    assert recalls["steady"] > 0.5


def test_quickstart_runs_small():
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu", "--n", "600", "--queries",
                           "48"])
    assert out["recall_dqf"] > 0.5 and out["dist_dqf"] < out["dist_baseline"]


def test_drift_adaptation_runs_small():
    from repro_torch.examples import drift_adaptation

    out = drift_adaptation.main(["--device", "cpu", "--n", "600",
                                 "--queries", "48"])
    assert sorted(out) == ["fresh", "rebuilt", "stale"]


def test_serve_knnlm_runs_small():
    from repro_torch.examples import serve_knnlm

    gen, probs = serve_knnlm.main(["--device", "cpu", "--n-store", "600",
                                   "--steps", "4"])
    assert gen.shape == (4, 4) and probs.shape == (4, 1024)
    assert bool(torch.isfinite(probs).all())
