"""Port of the disk tier (``repro_torch.tiering``) against the JAX package.

The reference's world (``tests/test_tiering.py``: N = 900, D = 16,
``block_rows = 16``): one JAX checkpoint, sq8 and (the same index with a
PQ quantizer) pq; both packages load it, the port through
``DQF.load(..., device="cpu")``.

* ``BlockFile``: the files byte-equal to the reference's.
* ``BlockCache`` on a seeded random trace (gathers through a snapshot
  table, maintain, prefetch, writes, pins, relayout, decay): map,
  slot → block, perm, reference bits, clock hand, tallies, counters and
  the resident arena rows equal the reference's after every step; the
  reference's unit tests of pins, invalidation, decay and hit rate.
* ``TieredTable`` in f32, sq8 and pq at ``cache_frac`` 1.0, 0.25 and 0.1,
  cold and warm: bit for bit with the port's resident table, within
  rtol 1e-5 of the JAX ``TieredTable``, hit masks and counters equal.
* ``search``, ``search_dual_beam`` and ``search_baseline``: tiered ≡
  resident bit for bit; against the JAX tiered twin (``search`` cold and
  warm at every size, the other two at 25%) ids equal and dists within
  rtol 1e-5 per lane (at most 1% of lanes diverging through a float32
  near-tie, listed), and the cache counters equal when no lane diverged.
* Relayout, the insert → delete → compact round trip, the sidecar read
  by both packages, ``memory_report`` equal to the reference's, tiered
  engines with prefetch ≡ resident engines, the engines' auto-compaction
  on a tiered store, ``table_spec``'s refusal.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import quant as jquant
from repro.core import DQF as JDQF
from repro.core import DQFConfig as JConfig
from repro.core import QuantConfig as JQuant
from repro.core import TierConfig as JTier
from repro.core import ZipfWorkload
from repro.core.workload import zipf_probs
from repro.tiering import BlockCache as JCache
from repro.tiering import BlockFile as JFile
from repro.tiering import TieredTable as JTable
from repro_torch.core import DQF, QuantConfig, TierConfig
from repro_torch.core import beam_search as bs
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.serving.engine import WaveEngine
from repro_torch.serving.paged_engine import PagedWaveEngine
from repro_torch.store import VectorStore
from repro_torch.tiering import BlockCache, BlockFile, TieredTable
from tests.conftest import make_clustered
from tests.test_torch_search import assert_lanes_match, port_cfg
from tests._torch_threads import one_torch_thread  # noqa: F401

N, D = 900, 16
FRACS = (1.0, 0.25, 0.1)
MODES = ("f32", "sq8", "pq")


def _jcfg(mode, **over):
    """tests/test_tiering.py::_cfg, in each mode."""
    quant = {"f32": JQuant(),
             "sq8": JQuant(mode="sq8", rerank_k=24),
             "pq": JQuant(mode="pq", pq_m=4, rerank_k=24)}[mode]
    base = dict(knn_k=10, out_degree=10, index_ratio=0.03, k=10,
                hot_pool=16, full_pool=32, max_hops=100,
                n_query_trigger=10 ** 6, quant=quant)
    base.update(over)
    return JConfig(**base)


def _tier_kw(tmp, frac, **over):
    kw = dict(mode="host", dir=str(tmp), block_rows=16, cache_frac=frac)
    kw.update(over)
    return kw


def _port(mode, **over):
    """The port's config of ``_jcfg(mode)`` (its quantizer mirrored)."""
    j = _jcfg(mode)
    q = QuantConfig(mode=j.quant.mode, pq_m=j.quant.pq_m,
                    rerank_k=j.quant.rerank_k)
    return port_cfg(j, quant=q, **over)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One reference build, saved as an sq8 checkpoint and (the same
    index with a PQ quantizer) a pq one; every twin loads from them."""
    x = make_clustered(n=N, d=D, clusters=12, seed=11)
    dqf = JDQF(_jcfg("sq8")).build(x)
    wl = ZipfWorkload(x, beta=2.0, sigma=0.05, seed=12)
    _, t = wl.sample(3000, with_targets=True)
    dqf.counter.record(t)
    dqf.rebuild_hot()
    tmp = tmp_path_factory.mktemp("ckpt")
    sq8 = str(tmp / "dqf.npz")
    dqf.save(sq8)
    with np.load(sq8) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("quant_")}
    pq = jquant.build_quantizer(x, JQuant(mode="pq", pq_m=4))
    arrays.update(pq.to_arrays())
    pq_path = str(tmp / "dqf_pq.npz")
    np.savez(pq_path, **arrays)
    paths = {"f32": sq8, "sq8": sq8, "pq": pq_path}
    return {"x": x, "wl": wl, "paths": paths, "tmp": tmp_path_factory,
            "resident": {}}


def twins(world, mode, frac, name, **tier_over):
    """(JAX tiered, port tiered, port resident) DQFs of one checkpoint."""
    path = world["paths"][mode]
    tmp = world["tmp"]
    jd = JDQF.load(path, _jcfg(mode, tier=JTier(**_tier_kw(
        tmp.mktemp(f"j{name}"), frac, **tier_over))))
    td = DQF.load(path, _port(mode, tier=TierConfig(**_tier_kw(
        tmp.mktemp(f"t{name}"), frac, **tier_over))), device="cpu")
    if mode not in world["resident"]:
        world["resident"][mode] = DQF.load(path, _port(mode), device="cpu")
    return jd, td, world["resident"][mode]


def same_bits(a, b) -> bool:
    return torch.equal(a.ids, b.ids) and torch.equal(
        a.dists.view(torch.int32), b.dists.view(torch.int32))


def counters_equal(jc, tc):
    assert tc.counters == jc.counters
    np.testing.assert_array_equal(tc._map, jc._map)


# --------------------------------------------------------------- block file
@pytest.mark.parametrize("dtype,width", [(np.float32, 5), (np.int8, 16),
                                         (np.uint8, 4)])
def test_blockfile_bytes_equal_reference(tmp_path, dtype, width):
    rng = np.random.default_rng(width)
    files = [cls(str(tmp_path / f"{cls.__module__}.bin"), 100, width, dtype,
                 16) for cls in (JFile, BlockFile)]
    data = rng.integers(-100, 100, (100, width)).astype(dtype)
    for bf in files:
        bf.rows[:100] = data
        bf.resize(256)
        bf.rows[100:150] = data[:50]
        bf.flush()
    jb, tb = files
    assert (tb.capacity, tb.n_blocks, tb.block_rows, tb.log2_block) == \
        (jb.capacity, jb.n_blocks, jb.block_rows, jb.log2_block)
    assert tb.disk_nbytes() == jb.disk_nbytes()
    with open(jb.path, "rb") as a, open(tb.path, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(tb.read_block(6), jb.read_block(6))
    np.testing.assert_array_equal(tb.read_rows([3, 140, 0]),
                                  jb.read_rows([3, 140, 0]))
    assert tb.block_of(37) == jb.block_of(37)


# ------------------------------------------------------------- block cache
def _cache_state_equal(jc, tc):
    for name in ("_map", "_slot_bid", "_perm", "_ref", "_miss_tally",
                 "_hit_tally", "_row_tally"):
        a, b = getattr(jc, name), getattr(tc, name)
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert (tc._hand, tc._pinned, tc.counters) == \
        (jc._hand, jc._pinned, jc.counters)
    live = np.flatnonzero(tc._slot_bid >= 0)
    np.testing.assert_array_equal(tc.arena_dev()[live].numpy(),
                                  np.asarray(jc.arena_dev())[live])


def _wait_staged(cache, issued):
    deadline = time.monotonic() + 10
    while len(cache._staged) < issued or cache._want:
        assert time.monotonic() < deadline, "prefetch worker stalled"
        time.sleep(0.001)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cache_random_trace_equals_reference(tmp_path, seed):
    cap, w, br = 256, 4, 8                  # 32 blocks
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((cap, w)).astype(np.float32)
    files, caches = [], []
    for cls, bcls in ((JFile, JCache), (BlockFile, BlockCache)):
        bf = cls(str(tmp_path / f"{cls.__module__}.f32"), cap, w,
                 np.float32, br)
        bf.rows[:cap] = data
        files.append(bf)
        caches.append(bcls(bf, slots=5, prefetch=True, track_rows=True,
                           tally_decay_every=3))
    jc, tc = caches
    q = rng.standard_normal((3, w)).astype(np.float32)
    for _ in range(40):
        op = int(rng.integers(0, 7))
        if op == 0:                     # a gather through snapshot tables
            cols = rng.integers(0, cap + 1, (3, 7)).astype(np.int32)
            jt = JTable.from_cache(jc, mode="f32", n=cap)
            tt = TieredTable.from_cache(tc, mode="f32", n=cap)
            jg, jf, jh = jt._gather_split(jnp.asarray(cols))
            tg, tf, th = tt._gather_split(torch.from_numpy(cols))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            qt = torch.from_numpy(q)
            got = torch.where(th, tt._score(tg, qt), tt._score(tf, qt))
            want = jnp.where(jh, jt._score(jg, jnp.asarray(q)),
                             jt._score(jf, jnp.asarray(q)))
            rows = torch.from_numpy(np.array(files[1].rows[
                np.minimum(cols, cap - 1)]))
            exact = ref.sq_l2(rows, qt[:, None, :])
            real = cols < cap
            assert torch.equal(got[real], exact[real])
            np.testing.assert_allclose(got.numpy()[real],
                                       np.asarray(want)[real], rtol=1e-5)
        elif op == 1:
            max_admit = None if rng.random() < 0.5 else 2
            assert tc.maintain(max_admit) == jc.maintain(max_admit)
        elif op == 2:                   # a write-through + invalidation
            lo = int(rng.integers(0, cap - 8))
            new = rng.standard_normal((8, w)).astype(np.float32)
            for bf, c in zip(files, caches):
                bf.rows[lo:lo + 8] = new
                c.note_write_rows(lo, lo + 8)
        elif op == 3:
            pins = rng.choice(32, size=int(rng.integers(0, 4)),
                              replace=False)
            jc.pin_blocks(pins)
            tc.pin_blocks(pins)
        elif op == 4:
            assert tc.relayout(cap) == jc.relayout(cap)
        elif op == 5:
            jc.decay_tallies()
            tc.decay_tallies()
        else:                           # prefetch, then apply
            bids = rng.integers(0, 32, 6)
            issued = [c.prefetch_async(bids) for c in caches]
            assert issued[0] == issued[1]
            for c in caches:
                _wait_staged(c, issued[0])
            assert tc.apply_prefetch() == jc.apply_prefetch()
        _cache_state_equal(jc, tc)
    for c in caches:
        c.close()


@pytest.mark.parametrize("seed", range(4))
def test_admission_victim_picks_the_reference_slot(tmp_path, seed):
    """The port's one-argmin victim choice against the reference's
    per-slot loop on random full caches: pins, this pass's admissions,
    tied tallies."""
    rng = np.random.default_rng(seed)
    caches = [cls(fcls(str(tmp_path / f"{fcls.__module__}.f32"), 512, 2,
                       np.float32, 8), slots=24)
              for cls, fcls in ((JCache, JFile), (BlockCache, BlockFile))]
    for _ in range(50):
        bids = rng.choice(64, size=24, replace=False)
        tally = rng.integers(0, 4, 64)
        pinned = set(rng.choice(bids, size=int(rng.integers(0, 24)),
                                replace=False).tolist())
        fresh = set(rng.choice(bids, size=int(rng.integers(0, 6)),
                               replace=False).tolist())
        for c in caches:
            c._slot_bid[:] = bids
            c._hit_tally[:] = tally
            c.pin_blocks(pinned)
        held = np.isin(bids, list(pinned | fresh))
        score = int(rng.integers(0, 5))
        assert caches[1]._admission_victim(score, held) == \
            caches[0]._admission_victim(score, fresh)


def test_note_write_drops_resident_block(tmp_path):
    cap, w, br = 64, 4, 8
    bf = BlockFile(str(tmp_path / "t.f32"), cap, w, np.float32, br)
    rng = np.random.default_rng(0)
    bf.rows[:cap] = rng.standard_normal((cap, w)).astype(np.float32)
    cache = BlockCache(bf, slots=2)
    cache._miss_tally[0] = 5
    assert cache.maintain() == 1 and cache.resident(0)
    bf.rows[3] = 7.0                        # write-through lands in file
    cache.note_write_rows(3, 4)
    assert not cache.resident(0)
    assert cache.counters["invalidations"] == 1
    # a fresh snapshot reads the block back with the new bytes
    t = TieredTable.from_cache(cache, mode="f32", n=cap)
    d2 = t.gather_score(torch.zeros((1, w)), torch.tensor([[3]]))
    assert float(d2[0, 0]) == pytest.approx(float(np.sum(bf.rows[3] ** 2)))


def test_eviction_respects_pins(tmp_path):
    cap, w, br = 64, 4, 8                   # 8 blocks
    bf = BlockFile(str(tmp_path / "t.f32"), cap, w, np.float32, br)
    bf.rows[:cap] = np.arange(cap * w, dtype=np.float32).reshape(cap, w)
    cache = BlockCache(bf, slots=2)
    cache._miss_tally[[0, 1]] = [10, 9]
    assert cache.maintain() == 2
    assert cache.resident(0) and cache.resident(1)
    cache.pin_blocks([0, 1])                # as if in-flight lanes read them
    cache._miss_tally[2] = 100
    assert cache.maintain() == 0            # nothing evictable
    assert cache.resident(0) and cache.resident(1) and not cache.resident(2)
    cache.pin_blocks([0])
    cache._miss_tally[2] = 100
    assert cache.maintain() == 1
    assert cache.resident(0) and cache.resident(2) and not cache.resident(1)
    np.testing.assert_array_equal(cache.arena_dev()[cache._map[2]].numpy(),
                                  bf.read_block(2))


def test_hit_rate_monotone_in_cache_size(tmp_path):
    cap, w, br = 256, 4, 8                  # 32 blocks
    bf = BlockFile(str(tmp_path / "t.f32"), cap, w, np.float32, br)
    rng = np.random.default_rng(1)
    bf.rows[:cap] = rng.standard_normal((cap, w)).astype(np.float32)
    probs = zipf_probs(cap, 1.5)
    perm = rng.permutation(cap)
    batches = [perm[rng.choice(cap, size=(4, 16), p=probs)]
               for _ in range(12)]
    rates = []
    for slots in (2, 8, 32):
        cache = BlockCache(bf, slots)
        for i, cols in enumerate(batches):
            cache.maintain()
            if i == len(batches) // 2:      # measure steady state only
                cache.reset_counters()
            TieredTable.from_cache(cache, mode="f32", n=cap).gather_score(
                torch.zeros((4, w)), torch.from_numpy(cols))
        rates.append(cache.hit_rate())
    assert rates[-1] > 0.95                 # full-size cache: all resident
    for small, big in zip(rates, rates[1:]):
        assert big >= small - 0.05


@pytest.mark.parametrize("every", [0, 1])
def test_tally_decay(tmp_path, every):
    """Decayed tallies let relayout follow a workload shift (and leave a
    pinned block resident); without decay the counts stay all-time."""
    cap, w, br = 256, 4, 8
    bf = BlockFile(str(tmp_path / "t.f32"), cap, w, np.float32, br)
    bf.rows[:cap] = np.arange(cap * w, dtype=np.float32).reshape(cap, w)
    cache = BlockCache(bf, slots=4, track_rows=True,
                       tally_decay_every=every)
    old_head, new_head = np.arange(0, 16), np.arange(100, 116)
    hit = np.zeros(16, bool)
    cache.host_fetch(old_head[None].repeat(8, 0), hit[None].repeat(8, 0))
    before = cache._row_tally.copy()
    cache.pin_blocks([0])
    for _ in range(6):                      # 6 decay passes: 8 → 0
        cache.maintain()
    assert cache.resident(0)
    if not every:
        np.testing.assert_array_equal(cache._row_tally, before)
        return
    cache.host_fetch(new_head[None].repeat(2, 0), hit[None].repeat(2, 0))
    assert cache.relayout(cap)
    assert np.isin(cache._order[:br], new_head).all()


def test_store_threads_tier_knobs(tmp_path):
    x = np.random.default_rng(0).standard_normal((100, 8)).astype(np.float32)
    st = VectorStore(x, tier=TierConfig(mode="host", dir=str(tmp_path),
                                        block_rows=16, tally_decay_every=7,
                                        fetch_retries=2))
    assert st.tiered and st.tier_dir == str(tmp_path)
    for c in st.tier_caches():
        assert (c._tally_decay_every, c.fetch_retries) == (7, 2)
        assert c.device.type == "cpu"
    assert not VectorStore(x, tier=TierConfig()).tiered


# ---------------------------------------------------------- tiered table
def _tables(dqf, q):
    """The full phase's score table and the exact row table, bound."""
    qt = dqf._quant_table()
    table = dqf._row_table() if qt is None else qt
    return bs.as_view(table, q)


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("mode", MODES)
def test_tiered_table_matches_resident_and_reference(world, mode, frac):
    jd, td, rd = twins(world, mode, frac, f"tab{mode}{frac}")
    for d in (jd, td, rd):
        d._sync_device()
    rng = np.random.default_rng(7)
    q = world["wl"].sample(8)
    qt = torch.from_numpy(q)
    jc, tc = jd.store.full_phase_cache(), td.store.full_phase_cache()
    for rep in ("cold", "warm"):
        cols = rng.integers(0, N + 1, (8, 12)).astype(np.int32)
        lb, nb, slots = tc.bf.log2_block, tc.bf.n_blocks, tc.slots
        hit = tc._map[np.minimum(tc._perm[cols] >> lb, nb)] <= slots
        jhit = jc._map[np.minimum(jc._perm[cols] >> lb, nb)] <= slots
        np.testing.assert_array_equal(hit, jhit, err_msg=rep)
        c_t = torch.from_numpy(cols)
        got = _tables(td, qt).gather_score(qt, c_t)
        want = bs.score_rows(_tables(rd, qt), qt, c_t)
        real = cols < N
        assert torch.equal(got[real], want[real]), rep
        jt = _tables(jd, jnp.asarray(q))
        jgot = np.asarray(jt.gather_score(jnp.asarray(q), jnp.asarray(cols)))
        np.testing.assert_allclose(got.numpy()[real], jgot[real], rtol=1e-5,
                                   err_msg=rep)
        counters_equal(jc, tc)
        jd.store.tier_begin()               # admit what the gather missed
        td.store.tier_begin()
        counters_equal(jc, tc)


def test_table_spec_refuses_tiered(world):
    _, td, _ = twins(world, "sq8", 0.25, "spec")
    with pytest.raises(TypeError, match="composed path"):
        kops.table_spec(td._quant_table())
    with pytest.raises(TypeError, match="composed path"):
        kops.table_spec(td._row_table())
    td.cfg = dataclasses.replace(td.cfg, fused=True)
    assert not td._fused                    # the gate: composed path
    q = world["wl"].sample(16)
    assert same_bits(td.search(q, record=False),
                     world["resident"]["sq8"].search(q, record=False))


# ----------------------------------------------------------------- search
def _check(jres, tres, rres, jc, tc, what):
    assert same_bits(tres, rres), f"{what}: tiered != resident"
    lanes = assert_lanes_match(jres, tres, fields=())
    if not lanes:
        counters_equal(jc, tc)
    return lanes


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("mode", MODES)
def test_search_paths_match_resident_and_reference(world, mode, frac):
    jd, td, rd = twins(world, mode, frac, f"s{mode}{frac}")
    jc, tc = jd.store.full_phase_cache(), td.store.full_phase_cache()
    wl = world["wl"]
    for rep in ("cold", "warm"):
        q = wl.sample(48)
        _check(jd.search(q, record=False), td.search(q, record=False),
               rd.search(q, record=False), jc, tc, f"search, {rep}")
    q = wl.sample(32)
    dual, base = td.search_dual_beam(q), td.search_baseline(q)
    assert same_bits(dual, rd.search_dual_beam(q)), "search_dual_beam"
    assert same_bits(base, rd.search_baseline(q)), "search_baseline"
    if frac == 0.25:                        # the JAX twin at one size
        jdual = jd.search_dual_beam(q)
        lanes = assert_lanes_match(jdual, dual, fields=())
        jbase = jd.search_baseline(q)
        if not lanes:
            counters_equal(jc, tc)
        if not assert_lanes_match(jbase, base, fields=()):
            counters_equal(jd.store._row_cache, td.store._row_cache)


def test_relayout_preserves_results(world):
    jd, td, rd = twins(world, "sq8", 0.1, "relayout")
    q = world["wl"].sample(64)
    before = td.search(q, record=False)
    jd.search(q, record=False)
    assert td.relayout_tier() and jd.relayout_tier()
    counters_equal(jd.store.full_phase_cache(), td.store.full_phase_cache())
    np.testing.assert_array_equal(td.store.full_phase_cache()._perm,
                                  jd.store.full_phase_cache()._perm)
    after = td.search(q, record=False)
    assert same_bits(before, after)
    assert same_bits(after, rd.search(q, record=False))
    assert not rd.relayout_tier()


# ------------------------------------------- mutation lifecycle + persistence
def test_mutation_roundtrip_no_stale_epoch(world):
    """Insert (past capacity: the files resize, the caches re-key), delete
    and compact on a tiered twin of each package and a resident port
    twin: tiered ≡ resident after every step, the JAX twin's external
    ids and remap equal, its searches within the lane tolerance."""
    jd, td, _ = twins(world, "sq8", 0.25, "mut")
    rd = DQF.load(world["paths"]["sq8"], _port("sq8"), device="cpu")
    rng = np.random.default_rng(8)
    wl = world["wl"]
    q = wl.sample(32)
    td.search(q, record=False)              # warm blocks that go stale
    jd.search(q, record=False)
    new = rng.standard_normal((200, D)).astype(np.float32)
    ext = [d.insert(new) for d in (jd, td, rd)]
    np.testing.assert_array_equal(ext[1], ext[0])
    np.testing.assert_array_equal(ext[2], ext[0])
    assert td.store.capacity == jd.store.capacity > N
    assert td.store.full_phase_cache().bf.n_blocks == \
        jd.store.full_phase_cache().bf.n_blocks
    steps = [("insert", None), ("delete", ext[0][:30]), ("compact", None)]
    for name, arg in steps:
        if name == "delete":
            live = td.store.live_ids()
            victims = np.concatenate([arg, td.store.to_external(
                rng.choice(live[:N], size=8, replace=False))])
            for d in (jd, td, rd):
                d.delete(victims)
        elif name == "compact":
            res = [d.compact() for d in (jd, td, rd)]
            np.testing.assert_array_equal(res[1]["remap"], res[0]["remap"])
            np.testing.assert_array_equal(res[2]["remap"], res[0]["remap"])
        q = wl.sample(32)
        _check(jd.search(q, record=False), td.search(q, record=False),
               rd.search(q, record=False), jd.store.full_phase_cache(),
               td.store.full_phase_cache(), f"after {name}")
        np.testing.assert_array_equal(td.store.ext_ids, jd.store.ext_ids)
    keep = ext[1][30:]
    np.testing.assert_array_equal(td.store.x[td.store.to_internal(keep)],
                                  new[30:])
    assert td.relayout_tier()               # row tracking survived growth
    q = wl.sample(32)
    assert same_bits(td.search(q, record=False), rd.search(q, record=False))


def test_sidecar_loads_in_both_packages(world):
    _, td, _ = twins(world, "sq8", 0.25, "side")
    td.insert(np.random.default_rng(3).standard_normal((5, D))
              .astype(np.float32))
    tmp = world["tmp"].mktemp("side_ckpt")
    path = str(tmp / "t.npz")
    td.save(path)
    side = path + ".tier"
    assert os.path.isdir(side)
    rows = np.memmap(os.path.join(side, "rows.f32"), dtype=np.float32,
                     mode="r").reshape(-1, D)
    np.testing.assert_array_equal(rows[: td.store.n], td.store.x)
    q = world["wl"].sample(32)
    before = td.search(q, record=False)
    back = DQF.load(path, _port("sq8", tier=TierConfig(mode="host",
                                                       block_rows=16)),
                    device="cpu")
    assert back.store.tier_dir == side
    assert same_bits(back.search(q, record=False), before)
    back.save(path)                         # the live tier is the sidecar
    assert same_bits(DQF.load(path, _port("sq8"), device="cpu").search(
        q, record=False), before)
    jback = JDQF.load(path, _jcfg("sq8", tier=JTier(mode="host",
                                                    block_rows=16)))
    assert_lanes_match(jback.search(q, record=False), before, fields=())
    jpath = str(tmp / "j.npz")
    jback.save(jpath)
    assert os.path.isdir(jpath + ".tier")
    again = DQF.load(jpath, _port("sq8", tier=TierConfig(mode="host",
                                                         block_rows=16)),
                     device="cpu")
    assert same_bits(again.search(q, record=False), before)


@pytest.mark.parametrize("mode", ["f32", "sq8"])
def test_memory_report_equals_reference(world, mode):
    jd, td, rd = twins(world, mode, 0.1, f"mem{mode}")
    jm, tm = jd.memory_report(), td.memory_report()
    assert sorted(tm) == sorted(jm)
    for key in tm:
        assert tm[key] == jm[key], key
    rm = rd.memory_report()
    assert tm["disk"]["total"] > 0 and rm["disk"]["total"] == 0
    assert rm["host"]["rows"] > 0 and tm["host"]["rows"] == 0
    assert tm["device"]["rows"] * 4 <= rm["device"]["rows"]
    assert td.index_nbytes() == tm


# ---------------------------------------------------------------- engines
def test_engine_auto_compacts_a_tiered_store(world):
    """The engines' drain-and-compact trigger on a tiered store
    (``tests/test_tiering.py::test_engine_drains_and_compacts_on_trigger``
    on a tier): the compaction rewrites the block files, every written
    block leaves the caches, and every request is answered."""
    _, td, _ = twins(world, "sq8", 0.25, "autocompact")
    td.search(world["wl"].sample(32), record=False)  # blocks resident
    rng = np.random.default_rng(5)
    live = td.store.live_ids()
    td.delete(td.store.to_external(
        rng.choice(live, size=int(0.4 * live.size), replace=False)))
    assert td.store.should_compact()
    cache = td.store.full_phase_cache()
    inval, n_before = cache.counters["invalidations"], td.store.n
    eng = WaveEngine(td, wave_size=8, tick_hops=4)
    rids = eng.submit(world["wl"].sample(24))
    out = eng.run_until_drained()
    assert eng.stats.compactions == 1
    assert td.store.n == td.store.live_count < n_before
    assert cache.counters["invalidations"] > inval
    for rid in rids:
        assert (out["results"][rid]["ids"] >= 0).all()
    for c in td.store.tier_caches():        # no block serves stale bytes
        slots = np.flatnonzero(c._slot_bid >= 0)
        for s in slots:
            np.testing.assert_array_equal(
                c.arena_dev()[s].numpy(), c._load_block(c._slot_bid[s]))


@pytest.mark.parametrize("mode", ["f32", "sq8"])
def test_tiered_engines_with_prefetch_equal_resident(world, mode):
    _, td, rd = twins(world, mode, 0.25, f"eng{mode}")
    q = world["wl"].sample(24)
    out = {}
    for name, d in (("tiered", td), ("resident", rd)):
        for cls, width in ((WaveEngine, "wave_size"),
                           (PagedWaveEngine, "capacity")):
            eng = cls(d, tick_hops=4, **{width: 8})
            rids = eng.submit(q)
            res = eng.run_until_drained()["results"]
            out[name, cls.__name__] = [res[r] for r in rids]
    cache = td.store.full_phase_cache()
    assert cache.counters["prefetch_issued"] > 0
    want = out["resident", "WaveEngine"]
    for key, got in out.items():
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b["ids"], a["ids"], err_msg=key)
            np.testing.assert_array_equal(b["dists"], a["dists"],
                                          err_msg=key)
            assert (b["hops"], b["status"]) == (a["hops"], "ok"), key
