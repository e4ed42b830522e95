"""Port of the serving engines against the JAX package and against itself.

* Both port engines (``WaveEngine``, ``PagedWaveEngine``), composed and
  fused, against the JAX engines on one reference DQF carried across with
  ``convert.dqf_from_arrays``: per query ids and hops exactly equal, dists
  within rtol 1e-5 (the port sums squares in its own fixed order), equal
  tick counts; a diverging query is listed, never hidden.
* Within the port, the reference's own rules
  (``tests/test_paged_engine.py``): paged ≡ fixed bit for bit across
  none/sq8/pq and composed/fused, the mixed-tenant property, open loop ≡
  closed loop; and scrape keys equal to the JAX engines'.

The serving behaviours, deadlines, shedding, admission control and the
allocator are in ``tests/test_torch_serving_behaviour.py``, split from
this file along its sections.
"""

import copy
import dataclasses

import numpy as np
import pytest

from repro.core import DQF as JDQF
from repro.core import ZipfWorkload
from repro.serving.engine import WaveEngine as JWave
from repro.serving.paged_engine import PagedWaveEngine as JPaged
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import DQF, DQFConfig, QuantConfig
from repro_torch.serving.engine import WaveEngine
from repro_torch.serving.paged_engine import PagedWaveEngine
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.conftest import make_clustered
from tests.test_fused_hop import _fused_cfg as _jax_cfg
from tests.test_torch_search import port_cfg

ENGINES = {"fixed": (JWave, WaveEngine, "wave_size"),
           "paged": (JPaged, PagedWaveEngine, "capacity")}


@pytest.fixture(scope="module")
def world_x():
    return make_clustered(n=900, d=16, clusters=12, seed=31)


def _cfg(fused, **over):
    """tests/test_fused_hop.py::_fused_cfg, in the port."""
    base = dict(knn_k=10, out_degree=10, index_ratio=0.03, k=8,
                hot_pool=16, full_pool=32, max_hops=100, eval_gap=30,
                n_query_trigger=10 ** 6, fused=fused, fused_hops=4)
    base.update(over)
    return DQFConfig(**base)


def _built(cfg, x, seed=21):
    """tests/test_fused_hop.py::_built, in the port, on the CPU."""
    wl = ZipfWorkload(x, seed=seed)
    dqf = DQF(cfg, device="cpu").build(x)
    dqf.warm(wl.sample(600))
    dqf.fit_tree(wl.sample(256))
    return dqf


def diverging_queries(oa, ob, ra, rb, rtol=0.0):
    """Indices of queries whose ids, hops or dists differ (dists within
    ``rtol``; 0 = bit for bit)."""
    bad = []
    for i in range(len(ra)):
        a, b = oa["results"][ra[i]], ob["results"][rb[i]]
        same = (np.array_equal(a["ids"], b["ids"]) and a["hops"] == b["hops"]
                and (np.array_equal(a["dists"], b["dists"]) if rtol == 0
                     else np.allclose(a["dists"], b["dists"], rtol=rtol,
                                      atol=0)))
        if not same:
            bad.append(i)
    return bad


# ------------------------------------------------- against the JAX engines
@pytest.fixture(scope="module")
def jax_world(world_x, tmp_path_factory):
    """A reference DQF with a second tenant, and its saved arrays."""
    x = world_x
    wl = ZipfWorkload(x, seed=21)
    dqf = JDQF(_jax_cfg(False)).build(x)
    dqf.warm(wl.sample(600))
    q, tg = ZipfWorkload(x, seed=77).sample(600, with_targets=True)
    dqf.warm(q, tg, tenant="b")
    dqf.fit_tree(wl.sample(256))
    path = str(tmp_path_factory.mktemp("serving") / "dqf.npz")
    dqf.save(path)
    with np.load(path) as z:
        return dqf, {k: z[k] for k in z.files}, path


@pytest.mark.parametrize("kind", ["fixed", "paged"])
@pytest.mark.parametrize("fused", [False, True])
def test_engines_match_reference(world_x, jax_world, kind, fused):
    jdqf, arrays, _ = jax_world
    jdqf = copy.copy(jdqf)
    jdqf.cfg = dataclasses.replace(jdqf.cfg, fused=fused)
    port = dqf_from_arrays(arrays, port_cfg(jdqf.cfg), device="cpu")
    jcls, tcls, width = ENGINES[kind]
    extra = {"page_cols": 128} if kind == "paged" else {}
    ej = jcls(jdqf, **{width: 16}, tick_hops=6, prefetch=False, **extra)
    et = tcls(port, **{width: 16}, tick_hops=6, prefetch=False, **extra)
    assert et._fused is fused
    qa = ZipfWorkload(world_x, seed=6).sample(30)
    qb = ZipfWorkload(world_x, seed=78).sample(20)
    rj = ej.submit(qa) + ej.submit(qb, tenant="b")
    rt = et.submit(qa) + et.submit(qb, tenant="b")
    oj, ot = ej.run_until_drained(), et.run_until_drained()
    bad = diverging_queries(oj, ot, rj, rt, rtol=1e-5)
    assert bad == [], f"queries diverge from the reference: {bad}"
    assert et.stats.ticks == ej.stats.ticks
    assert [ot["results"][r]["tenant"] for r in rt] == \
        [oj["results"][r]["tenant"] for r in rj]


@pytest.mark.parametrize("kind", ["fixed", "paged"])
def test_scrape_keys_equal_reference(world_x, jax_world, kind):
    jdqf, arrays, path = jax_world
    q = ZipfWorkload(world_x, seed=9).sample(12)
    jcls, tcls, width = ENGINES[kind]
    ej = jcls(JDQF.load(path, jdqf.cfg), **{width: 8}, tick_hops=4,
              prefetch=False)
    et = tcls(dqf_from_arrays(arrays, port_cfg(jdqf.cfg), device="cpu"),
              **{width: 8}, tick_hops=4, prefetch=False)
    for _ in range(2):
        ej.submit(q)
        et.submit(q)
        ej.run_until_drained()
        et.run_until_drained()
        assert sorted(et.scrape()) == sorted(ej.scrape())


# ------------------------------------------------------ paged ≡ fixed, port
@pytest.mark.parametrize("quant_mode", ["none", "sq8", "pq"])
@pytest.mark.parametrize("fused", [False, True])
def test_paged_bitwise_equals_fixed_wave(world_x, quant_mode, fused):
    """Paged ≡ fixed per query, every table variant, composed and fused,
    with equal tick counts."""
    x = world_x
    qc = QuantConfig() if quant_mode == "none" else \
        QuantConfig(mode=quant_mode, pq_m=4, rerank_k=16)
    da = _built(_cfg(False, quant=qc), x)
    db = copy.copy(da)
    db.cfg = _cfg(fused, quant=qc)
    q = ZipfWorkload(x, seed=6).sample(40)
    ea = WaveEngine(da, wave_size=16, tick_hops=6, prefetch=False)
    eb = PagedWaveEngine(db, capacity=16, tick_hops=6, page_cols=128,
                         prefetch=False)
    assert eb._fused is fused
    ra, rb = ea.submit(q), eb.submit(q)
    oa, ob = ea.run_until_drained(), eb.run_until_drained()
    assert diverging_queries(oa, ob, ra, rb) == []
    assert ea.stats.ticks == eb.stats.ticks


def test_paged_parity_mixed_tenant_property(world_x):
    """A randomized mixed-tenant trace — interleaved submissions of three
    tenants across drain rounds — retires bit-identical results from both
    engines."""
    x = world_x
    tenants = [("t0", 101), ("t1", 202), ("t2", 303)]
    dqf = DQF(_cfg(False), device="cpu").build(x)
    for name, seed in tenants:
        q, tg = ZipfWorkload(x, seed=seed).sample(500, with_targets=True)
        dqf.warm(q, tg, tenant=name)
    dqf.fit_tree(ZipfWorkload(x, seed=7).sample(200), tenant="t0")
    db = copy.copy(dqf)
    db.cfg = _cfg(True)
    ea = WaveEngine(dqf, wave_size=8, tick_hops=5, prefetch=False)
    eb = PagedWaveEngine(db, capacity=8, tick_hops=5, page_cols=128,
                         prefetch=False)
    rng = np.random.default_rng(17)
    wls = {name: ZipfWorkload(x, seed=seed + 1) for name, seed in tenants}
    for _ in range(3):
        ra, rb = [], []
        for t in rng.permutation([name for name, _ in tenants]):
            q = wls[t].sample(int(rng.integers(3, 9)))
            ra += ea.submit(q, tenant=t)
            rb += eb.submit(q, tenant=t)
        oa, ob = ea.run_until_drained(), eb.run_until_drained()
        assert diverging_queries(oa, ob, ra, rb) == []


def test_open_loop_equals_closed_loop(world_x):
    """Queries admitted mid-stream (``step`` between bursts) retire with
    the closed-loop results, in both engines, with equal ticks."""
    x = world_x
    dqf = _built(_cfg(True), x)
    q = ZipfWorkload(x, seed=12).sample(48)
    closed = WaveEngine(dqf, wave_size=8, tick_hops=4, prefetch=False)
    rc = closed.submit(q)
    oc = closed.run_until_drained()
    outs = []
    for cls, width in ((WaveEngine, "wave_size"),
                       (PagedWaveEngine, "capacity")):
        eng = cls(dqf, **{width: 8}, tick_hops=4, prefetch=False)
        rids = []
        for burst in range(4):
            rids += eng.submit(q[burst * 12:(burst + 1) * 12])
            for _ in range(3):
                eng.step()
        out = eng.run_until_drained()
        assert diverging_queries(oc, out, rc, rids) == []
        outs.append(eng.stats.ticks)
    assert outs[0] == outs[1]
