"""The port's scan and merge entry points against the JAX package.

Five plain versions in ``repro_torch.kernels.ref`` — the contracts of the
CUDA kernels ``pairwise_l2.cu`` (F32 and SQ8 modes), ``pq_adc.cu``,
``pool_merge.cu`` and ``gather_distances.cu`` — held against
``repro.kernels.ref``'s function of the same name and against the Pallas
kernel in ``interpret=True``, on inputs made from a seed with numpy:

* ``pairwise_l2`` and ``sq8_pairwise_l2``: |Δ| ≤ 1e-5 · (|q|² + |x|²).
  Both sides compute the expansion (|q|² + |x|²) − 2 q·x, whose rounding
  error scales with the two norms and not with the distance; the port sums
  over d in index order, XLA in its own.
* ``pq_adc`` and ``gather_distances``: rtol 1e-5 (the port sums in
  ``ref.halving_sum`` order, JAX with ``jnp.sum``; the Pallas ``pq_adc``
  is a one-hot matmul).
* ``pool_merge``: ids and dists exactly equal to ``ref.pool_merge``,
  equal keys, +inf and ``INF_DIST`` slots included, and bit for bit on
  the pools of ``merge_case`` (NaN of either sign and with a payload,
  -0.0 beside +0.0, sorted and shuffled); against ``pool_merge_pallas``
  only on tie-free data, since its network is unstable.

The arithmetic of ``pairwise_l2.cu``'s F32 mode (3xTF32 on the tensor
cores: TF32 high parts and remainders, three products in float32), emulated
in plain torch, stays within ``expansion_tol`` of ``ref.pairwise_l2`` on
the card's synthetic grid and with a common offset of length 100 (severe
cancellation); a single TF32 product, the control, leaves it on the same
grid.  The same for the int8 scan over the decoded rows against
``ref.sq8_pairwise_l2``, its rows int8-encoded in the offset case: the SQ8
mode's own arithmetic (the scaled query split in two TF32 parts, the codes
exact, two products plus q·zero) meets the tolerance, one TF32 product
over the decoded rows leaves it.  ``pq_adc.cu``'s lanes layout for up to 8
subspaces (the transposed LUT stage, the two half-warps' addresses and
subspace orders) emulated in plain torch equals ``ref.pq_adc`` bit for
bit, its two half-warps in opposite banks at every step.  The designs of
``pool_merge.cu`` (ordered integer keys, the sortedness test, the rank
placement and the (key, position) network) and of
``gather_distances.cu`` (lanes, registers and folds, then the 8-row
butterfly) emulated in plain torch equal ``ref.pool_merge`` and
``ref.gather_distances`` bit for bit; a mutated rank count (candidates
<= a pool key in place of <) is the control that must fail.

Then the slice as a whole: the reference ``built_dqf`` carried over with
``convert.dqf_from_arrays``, ``ops.pairwise_l2`` / ``sq8_pairwise_l2`` /
``pq_adc`` over the port's store and codes against the JAX ref over the
JAX rows and codes, and the exact top-10 of the port's scan at recall@10
1.0 against ``core/recall.py::ground_truth``, up to ties at the 10th place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import quant as jquant
from repro.core import QuantConfig as JQuant
from repro.kernels import ref as jref
from repro.kernels.distance import pairwise_l2_pallas
from repro.kernels.gather_distance import gather_distances_pallas
from repro.kernels.pq_adc import pq_adc_pallas
from repro.kernels.sq_distance import sq8_pairwise_l2_pallas
from repro.kernels.topk_merge import pool_merge_pallas
from repro_torch import quant as tquant
from repro_torch.convert import dqf_from_arrays
from repro_torch.core import QuantConfig as TQuant
from repro_torch.core.recall import ground_truth, recall_at_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.test_torch_cuda import (MERGE_KINDS, SCAN_D, SCAN_MERGE,
                                   duplicated_rows, expansion_tol,
                                   merge_case, offset_case, same_bits,
                                   scan_cases, sq8_offset_case,
                                   tf32_pairwise_l2, tf32_rna,
                                   tf32_sq8_fold_pairwise_l2, tol_rows)
from tests.test_torch_search import port_cfg, queries, saved  # noqa: F401
from tests._torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor


def assert_expansion_close(got, want, q, x):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff <= expansion_tol(q, x)).all(), float(diff.max())


def sq8_world(B, N, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d)).astype(np.float32) * 2.0
    cb = jquant.train_sq(x)
    codes = jquant.sq_encode(x, cb)
    codes[0, 0], codes[-1, -1] = -127, 127
    q = rng.standard_normal((B, d)).astype(np.float32)
    return q, codes, cb.scale, cb.zero


# ------------------------------------------------------------ pairwise_l2
@pytest.mark.parametrize("B,N,d", [(1, 1, 8), (17, 33, 24), (64, 128, 128),
                                   (30, 70, 100), (7, 5000, 18)])
def test_pairwise_l2_matches_jax_ref(B, N, d):
    rng = np.random.default_rng(B * N + d)
    x = duplicated_rows(N, d, N)
    q = rng.standard_normal((B, d)).astype(np.float32)
    q[0] = x[0]                                   # cancellation to ~0
    got = tops.pairwise_l2(T(q), T(x))
    assert got.shape == (B, N) and got.dtype == torch.float32
    assert_expansion_close(got.numpy(), jref.pairwise_l2(q, x), q, x)


@pytest.mark.parametrize("B,N,d,bq,bn", [(1, 1, 8, 8, 8), (17, 33, 24, 8, 16),
                                         (64, 128, 128, 32, 64)])
def test_pairwise_l2_matches_pallas_interpret(B, N, d, bq, bn):
    rng = np.random.default_rng(B + N)
    q = rng.standard_normal((B, d)).astype(np.float32)
    x = rng.standard_normal((N, d)).astype(np.float32)
    want = pairwise_l2_pallas(q, x, bq=bq, bn=bn, interpret=True)
    assert_expansion_close(tref.pairwise_l2(T(q), T(x)).numpy(), want, q, x)


def test_tf32_rna_rounds_to_ten_fraction_bits():
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(tf32_rna(a), want)
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(1000)
                        .astype(np.float32))
    hi = tf32_rna(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - hi).abs() <= hi.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("d", SCAN_D)
def test_tf32x3_arithmetic_meets_scan_contract(d):
    """The 3xTF32 arithmetic stays within ``expansion_tol`` of
    ``ref.pairwise_l2`` on the card's synthetic grid at width d."""
    n = 0
    for tag, (q, x) in scan_cases("pairwise_l2", "cpu"):
        if q.shape[1] != d:
            continue
        got = tf32_pairwise_l2(q, x)
        assert_expansion_close(got.numpy(), tref.pairwise_l2(q, x).numpy(),
                               q.numpy(), x.numpy())
        n += 1
    assert n == 12


@pytest.mark.parametrize("B,N,d", [(130, 5000, 128), (7, 129, 18),
                                   (64, 1000, 100)])
def test_tf32x3_arithmetic_meets_scan_contract_with_offset(B, N, d):
    """The same with rows and queries 100 · u off the origin, the card
    test's severe-cancellation case."""
    q, x = offset_case(B, N, d, B + N)
    got = tf32_pairwise_l2(T(q), T(x))
    assert_expansion_close(got.numpy(), tref.pairwise_l2(T(q), T(x)).numpy(),
                           q, x)


@pytest.mark.parametrize("d", SCAN_D)
def test_one_tf32_product_breaks_scan_contract(d):
    """The control: a single TF32 product (hi·hi, no split) leaves
    ``expansion_tol`` on the same grid, so the tolerance tells the 3xTF32
    arithmetic from the lower precision."""
    worst = 0.0
    for tag, (q, x) in scan_cases("pairwise_l2", "cpu"):
        if q.shape[1] != d:
            continue
        diff = (tf32_pairwise_l2(q, x, split=False).double()
                - tref.pairwise_l2(q, x).double()).abs()
        worst = max(worst, float((diff / expansion_tol(q, x)).max()))
    assert worst > 1.0, worst


# -------------------------------------------------------- sq8_pairwise_l2
@pytest.mark.parametrize("B,N,d", [(1, 1, 8), (17, 33, 24), (64, 129, 128),
                                   (5, 300, 100)])
def test_sq8_pairwise_l2_matches_jax_ref(B, N, d):
    q, codes, scale, zero = sq8_world(B, N, d, N + d)
    got = tops.sq8_pairwise_l2(T(q), T(codes), T(scale), T(zero))
    want = jref.sq8_pairwise_l2(jnp.asarray(q), jnp.asarray(codes),
                                jnp.asarray(scale), jnp.asarray(zero))
    x = codes.astype(np.float32) * scale + zero
    assert_expansion_close(got.numpy(), want, q, x)
    # the decode is the plain version's two roundings, then the float32 scan
    assert torch.equal(got, tref.pairwise_l2(T(q), T(x)))


@pytest.mark.parametrize("B,N,d,bq,bn", [(1, 1, 8, 8, 8), (17, 33, 24, 8, 16),
                                         (64, 128, 128, 32, 64)])
def test_sq8_pairwise_l2_matches_pallas_interpret(B, N, d, bq, bn):
    q, codes, scale, zero = sq8_world(B, N, d, B + N)
    want = sq8_pairwise_l2_pallas(jnp.asarray(q), jnp.asarray(codes),
                                  jnp.asarray(scale), jnp.asarray(zero),
                                  bq=bq, bn=bn, interpret=True)
    got = tref.sq8_pairwise_l2(T(q), T(codes), T(scale), T(zero))
    assert_expansion_close(got.numpy(), want, q,
                           codes.astype(np.float32) * scale + zero)


def sq8_control_ratio(args) -> float:
    """Largest |one-TF32-product emulation over the decoded rows −
    ref.sq8_pairwise_l2| / ``expansion_tol``."""
    q, x = tol_rows("sq8_pairwise_l2", args)
    diff = (tf32_pairwise_l2(q, x, split=False).double()
            - tref.sq8_pairwise_l2(*args).double()).abs()
    return float((diff / expansion_tol(q, x)).max())


@pytest.mark.parametrize("d", SCAN_D)
def test_sq8_fold_arithmetic_meets_scan_contract(d):
    """The kernel's own SQ8 arithmetic (the scaled query in two TF32 parts,
    the codes exact, two products plus q·zero) stays within
    ``expansion_tol`` of ``ref.sq8_pairwise_l2`` on the grid at width d
    and in the offset cases of that width."""
    cases = [args for tag, args in scan_cases("sq8_pairwise_l2", "cpu")
             if args[0].shape[1] == d]
    cases += [tuple(T(a) for a in sq8_offset_case(B, N, d, B + N))
              for B, N, dd in ((130, 5000, 128), (7, 129, 18),
                               (64, 1000, 100)) if dd == d]
    for args in cases:
        q, x = tol_rows("sq8_pairwise_l2", args)
        assert_expansion_close(tf32_sq8_fold_pairwise_l2(*args).numpy(),
                               tref.sq8_pairwise_l2(*args).numpy(),
                               q.numpy(), x.numpy())
    assert len(cases) == 13


@pytest.mark.parametrize("d", SCAN_D)
def test_one_tf32_product_breaks_sq8_scan_contract(d):
    """The control: one TF32 product over the decoded rows leaves
    ``expansion_tol`` on the same grid at width d."""
    worst = max(sq8_control_ratio(args)
                for tag, args in scan_cases("sq8_pairwise_l2", "cpu")
                if args[0].shape[1] == d)
    assert worst > 1.0, worst


@pytest.mark.parametrize("B,N,d", [(130, 5000, 128), (7, 129, 18),
                                   (64, 1000, 100)])
def test_one_tf32_product_breaks_sq8_scan_contract_with_offset(B, N, d):
    """The control leaves the tolerance in each offset case too."""
    args = tuple(T(a) for a in sq8_offset_case(B, N, d, B + N))
    assert sq8_control_ratio(args) > 1.0


# ----------------------------------------------------------------- pq_adc
def pq_world(B, N, M, K, seed):
    rng = np.random.default_rng(seed)
    luts = rng.uniform(0, 8, (B, M, K)).astype(np.float32)
    codes = rng.integers(0, K, (N, M)).astype(np.uint8)
    codes[0, 0], codes[-1, -1] = K - 1, 0
    return luts, codes


@pytest.mark.parametrize("B,N,M,K", [(5, 40, 4, 16), (17, 70, 6, 32),
                                     (32, 128, 8, 256), (3, 5000, 8, 64),
                                     (1, 1, 4, 64),
                                     (4, 60, 128, 256)])   # M past 64
def test_pq_adc_matches_jax_ref(B, N, M, K):
    luts, codes = pq_world(B, N, M, K, N * M)
    got = tops.pq_adc(T(luts), T(codes))
    assert got.shape == (B, N) and got.dtype == torch.float32
    want = jref.pq_adc(jnp.asarray(luts), jnp.asarray(codes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("B,N,M,K,bq,bn", [(5, 40, 4, 16, 8, 8),
                                           (17, 70, 6, 32, 8, 32),
                                           (32, 128, 8, 256, 16, 64)])
def test_pq_adc_matches_pallas_interpret(B, N, M, K, bq, bn):
    luts, codes = pq_world(B, N, M, K, B + K)
    want = pq_adc_pallas(jnp.asarray(luts), jnp.asarray(codes), bq=bq, bn=bn,
                         interpret=True)
    np.testing.assert_allclose(tref.pq_adc(T(luts), T(codes)).numpy(),
                               np.asarray(want), rtol=1e-5)


def test_pq_adc_is_the_search_scorer_in_chunks(monkeypatch):
    """Row i of the scan equals ``ref.pq_score`` of row i bit for bit, in
    any chunking of the rows."""
    luts, codes = (T(a) for a in pq_world(6, 257, 6, 32, 3))
    whole = tref.pq_adc(luts, codes)
    cols = torch.arange(257, dtype=torch.int32).expand(6, -1)
    assert torch.equal(whole, tref.pq_score(codes, luts, cols))
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 6 * 6 * 5)   # 5-row chunks
    assert torch.equal(tref.pq_adc(luts, codes), whole)



def pq_lanes(luts, codes):
    """``pq_adc.cu``'s ``pq_adc_lanes`` (M <= 8) in plain torch: for each
    group of 16 queries the LUTs staged as the kernel stages them (word i
    holds query i & 15, centroid (i >> 5) % K of subspace
    2 ((i >> 5) // K) + ((i >> 4) & 1), zeros past M), every row read by
    its half-warp (rows 4..7 of every 8 by half-warp 1, which reads
    subspace s ^ 1 at step s) at the kernel's word address, the values
    then halved in pairs in the order read.  Returns the (B, N) sums and
    the banks (word address mod 32) of each half-warp at each step."""
    B, M, K = luts.shape
    N = codes.shape[0]
    MP = tref.next_pow2(M)
    c = torch.zeros(N, MP, dtype=torch.long)
    c[:, :M] = codes.long()
    h = (torch.arange(N) >> 2) & 1 if MP >= 2 else torch.zeros(N, dtype=int)
    lane = torch.arange(16)[None, :] + 16 * h[:, None]          # (N, 16)
    i = torch.arange((MP + 1) // 2 * K * 32)
    qq, pair, k = i & 15, (i >> 5) // K, (i >> 5) % K
    m = 2 * pair + ((i >> 4) & 1)
    out, banks = torch.empty(B, N), []
    for b0 in range(0, B, 16):
        ok = (qq < min(16, B - b0)) & (m < M)
        lut = torch.zeros(i.shape)
        lut[ok] = luts[b0 + qq[ok], m[ok], k[ok]]
        v = []
        for s in range(MP):
            code = c.gather(1, (s ^ h)[:, None])                  # (N, 1)
            word = lane ^ 16 if s & 1 else lane                   # at_odd
            addr = (s >> 1) * K * 32 + code * 32 + word
            v.append(lut[addr])
            banks.append((addr % 32, h))
        v = torch.stack(v, -1)                                   # (N, 16, MP)
        w = MP // 2
        while w >= 1:
            v = v[..., :w] + v[..., w:2 * w]
            w //= 2
        out[b0:b0 + 16] = v[:, :B - b0, 0].T
    return out, banks


@pytest.mark.parametrize("B,N,M,K", [(20, 37, 1, 16), (16, 40, 2, 256),
                                     (33, 64, 3, 64), (7, 29, 4, 256),
                                     (17, 50, 5, 7), (1, 70, 6, 64),
                                     (20, 45, 7, 32), (35, 80, 8, 256)])
def test_pq_lanes_layout_is_ref_pq_adc(B, N, M, K):
    """The lanes layout's staging, addresses and half-warp subspace orders
    give ``ref.pq_adc``'s bits (LUT values over six decades, so the order
    of the adds shows), and past one subspace its two half-warps read
    disjoint banks at every step: one wavefront a warp load."""
    luts, codes = pq_world(B, N, M, K, B * M + K)
    luts *= 10.0 ** np.random.default_rng(M).uniform(-3, 3, luts.shape)
    luts, codes = T(luts.astype(np.float32)), T(codes)
    got, banks = pq_lanes(luts, codes)
    want = tref.pq_adc(luts, codes)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for bank, h in banks:
        assert all(len(set(row)) == 16 for row in bank.tolist())
        b0, b1 = (set(bank[h == j].flatten().tolist()) for j in (0, 1))
        assert len(b0) == 16 and (M == 1 or (len(b1) == 16 and not b0 & b1))


# ------------------------------------------------------------- pool_merge
@pytest.mark.parametrize("case", range(9))
def test_pool_merge_matches_jax_ref_with_ties(case):
    """Exact ids and dists, equal keys kept in input order, input +inf and
    ``INF_DIST`` slots ahead of nothing but each other."""
    tag, args = list(scan_cases("pool_merge", "cpu", seed=case))[case]
    pd, pi, cd, ci = (a.numpy() for a in args)
    assert any((row[:, None] == row[None, :]).sum() > row.size
               for row in np.concatenate([pd, cd], 1)), "no ties"
    gd, gi = tops.pool_merge(*args)
    wd, wi = jref.pool_merge(pd, pi, cd, ci)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), err_msg=tag)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd), err_msg=tag)
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32


@pytest.mark.parametrize("B,L,C,bb", [(3, 8, 8, 2), (9, 16, 24, 4),
                                      (1, 32, 16, 1), (16, 64, 32, 8),
                                      (5, 10, 7, 1)])
def test_pool_merge_matches_pallas_interpret_without_ties(B, L, C, bb):
    rng = np.random.default_rng(B * L + C)
    pd = np.sort(rng.standard_normal((B, L)).astype(np.float32), 1)
    pi = rng.integers(0, 9999, (B, L)).astype(np.int32)
    cd = rng.standard_normal((B, C)).astype(np.float32)
    ci = rng.integers(0, 9999, (B, C)).astype(np.int32)
    wd, wi = pool_merge_pallas(pd, pi, cd, ci, bb=bb, interpret=True)
    gd, gi = tref.pool_merge(T(pd), T(pi), T(cd), T(ci))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


INT_MAX = 0x7FFFFFFF
RANK_MERGE = tuple((L, C) for L, C in SCAN_MERGE if L <= 64 and C <= 32)


def merge_world(kind, L, C, B=7):
    """:func:`merge_case` as tensors, seeded by the case."""
    rng = np.random.default_rng(1000 * MERGE_KINDS.index(kind) + L + C)
    return tuple(T(a) for a in merge_case(kind, B, L, C, rng))


@pytest.mark.parametrize("kind", MERGE_KINDS)
@pytest.mark.parametrize("L,C", SCAN_MERGE)
def test_pool_merge_matches_jax_ref_nan_and_zeros(kind, L, C):
    """``ref.pool_merge`` is the JAX ref's stable sort for every key:
    -0.0 ties +0.0 and NaN of any sign or payload sorts last, each in input
    order, with its own bits, in sorted and in shuffled pools."""
    args = merge_world(kind, L, C)
    wd, wi = jref.pool_merge(*(jnp.asarray(a.numpy()) for a in args))
    gd, gi = tref.pool_merge(*args)
    assert same_bits((gd, gi), (T(np.array(wd)), T(np.array(wi))))
    if kind != "sorted":
        pd, _, cd, _ = args
        assert int(torch.isnan(pd).sum(1)[0] + torch.isnan(cd).sum(1)[0]) \
            <= C or bool(torch.isnan(gd[0]).any()), "no NaN kept"
        assert bool((gd.view(torch.int32) == -2**31).any()), "no -0.0"


def ordered_key(d: torch.Tensor) -> torch.Tensor:
    """``bitonic.cuh::ordered_key`` in plain torch: float32 to an int32 of
    the same order, the magnitude bits signed by the sign bit (so -0.0 and
    +0.0 are 0), every NaN INT_MAX (above +inf)."""
    u = d.view(torch.int32)
    mag = u & INT_MAX
    k = torch.where(u < 0, -mag, mag)
    return torch.where(mag > 0x7F800000, torch.full_like(k, INT_MAX), k)


def bitonic_kv(key, pos):
    """The (key, position) network of ``bitonic.cuh`` (``warp_sort_kv``,
    ``bitonic_sort_stable_segments``: the same stages) over rows of a
    power-of-two width: each stage keeps, at index i, the smaller or the
    larger of (i, i ^ j) by (key, position)."""
    S = key.shape[1]
    i = torch.arange(S)
    kk = 2
    while kk <= S:
        j = kk >> 1
        while j:
            p = i ^ j
            ok, op = key[:, p], pos[:, p]
            other_less = (ok < key) | ((ok == key) & (op < pos))
            take_min = ((i & kk) == 0) == (i < p)
            take = torch.where(take_min, other_less, ~other_less)
            key, pos = torch.where(take, ok, key), torch.where(take, op, pos)
            j >>= 1
        kk <<= 1
    return key, pos


def pool_merge_design(pd, pi, cd, ci, *, pool_count_at_most=False):
    """``pool_merge.cu`` in plain torch, row by row: the sortedness test
    over ordered keys, then for a sorted pool with L <= 64, C <= 32 the
    rank placement (pool entry i to i + #(candidate keys < its key), a
    candidate to its rank among the candidates by (key, position) plus the
    pool keys <= its key, found by the kernel's 7-step binary search),
    else the network over S = next_pow2(L + C) >= 32 entries padded with
    (INT_MAX, position).  Slots nothing writes stay NaN / -1.
    ``pool_count_at_most`` counts candidates <= a pool key: a mutation the
    test must catch."""
    B, L = pd.shape
    C = cd.shape[1]
    od = torch.full((B, L), float("nan"))
    oi = torch.full((B, L), -1, dtype=torch.int32)
    d = torch.cat([pd, cd], 1)
    ids = torch.cat([pi, ci], 1)
    for b in range(B):
        pk, ck = ordered_key(pd[b]), ordered_key(cd[b])
        if L <= 64 and C <= 32 and bool((pk[:-1] <= pk[1:]).all()):
            less = ck[None, :] <= pk[:, None] if pool_count_at_most else (
                ck[None, :] < pk[:, None])
            slot_p = torch.arange(L) + less.sum(1)
            j = torch.arange(C)
            before = ((ck[None, :] < ck[:, None])
                      | ((ck[None, :] == ck[:, None])
                         & (j[None, :] < j[:, None]))).sum(1)
            at_most = torch.zeros(C, dtype=torch.long)
            step = 64
            while step:
                at = at_most + step - 1
                key_at = pk[at.clamp(max=L - 1)]
                at_most += step * ((at < L) & (key_at <= ck))
                step >>= 1
            src = torch.cat([torch.arange(L), L + j])
            slot = torch.cat([slot_p, before + at_most])
            keep = slot < L
            od[b, slot[keep]] = d[b, src[keep]]
            oi[b, slot[keep]] = ids[b, src[keep]]
        else:
            S = max(32, tref.next_pow2(L + C))
            key = torch.full((1, S), INT_MAX, dtype=torch.int32)
            key[0, :L + C] = torch.cat([pk, ck])
            _, pos = bitonic_kv(key, torch.arange(S)[None, :])
            od[b], oi[b] = d[b, pos[0, :L]], ids[b, pos[0, :L]]
    return od, oi


def test_ordered_key_is_the_sort_order():
    """Sorting by ``ordered_key`` (stable) is ``torch.sort``'s stable order
    over floats across the whole line: NaNs, infinities, signed zeros,
    subnormals."""
    v = torch.tensor([1.0, float("nan"), -0.0, 0.0, float("inf"), -1e-45,
                      1e-45, -float("inf"), -3.0e38, 3.0e38, -2.5, 2.5])
    v = torch.cat([v, (-torch.tensor([float("nan")])), v.flip(0)])
    want = torch.sort(v, stable=True).indices
    got = torch.sort(ordered_key(v), stable=True).indices
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", MERGE_KINDS)
@pytest.mark.parametrize("L,C", SCAN_MERGE)
def test_pool_merge_design_is_ref_pool_merge(kind, L, C):
    """The kernel's design (ordered keys, sortedness ballot, rank merge,
    register and block networks) gives ``ref.pool_merge``'s bits: ids,
    dists, NaN payloads and signed zeros."""
    args = merge_world(kind, L, C)
    assert same_bits(pool_merge_design(*args), tref.pool_merge(*args))


@pytest.mark.parametrize("L,C", RANK_MERGE)
def test_pool_merge_design_mutation_is_caught(L, C):
    """The control: counting candidates <= a pool key (in place of <)
    breaks the equality on the same grid, where candidates tie pool
    keys."""
    args = merge_world("sorted", L, C)
    assert not same_bits(pool_merge_design(*args, pool_count_at_most=True),
                         tref.pool_merge(*args))


# ------------------------------------------------------- gather_distances
def gather_world(B, R, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x_pad = np.concatenate([x, np.full((1, d), 1e9, np.float32)])
    q = rng.standard_normal((B, d)).astype(np.float32)
    nbrs = rng.integers(0, n, (B, R)).astype(np.int32)
    nbrs[:, 0] = n                                 # the sentinel row
    nbrs[:, 2] = nbrs[:, 1]                        # an id twice
    return q, x_pad, nbrs


@pytest.mark.parametrize("B,R,n,d", [(4, 8, 40, 8), (9, 16, 100, 24),
                                     (2, 32, 64, 128), (7, 10, 300, 100),
                                     (3, 8, 40, 1536)])    # past 1024
def test_gather_distances_matches_jax_ref_and_pallas(B, R, n, d):
    q, x_pad, nbrs = gather_world(B, R, n, d, B * R + d)
    got = tops.gather_distances(T(q), T(x_pad), T(nbrs)).numpy()
    want = jref.gather_distances(jnp.asarray(q), jnp.asarray(x_pad),
                                 jnp.asarray(nbrs))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    kernel = gather_distances_pallas(jnp.asarray(q), jnp.asarray(x_pad),
                                     jnp.asarray(nbrs), interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=1e-5)
    assert np.isfinite(got).all() and (got[:, 0] > 1e18).all()
    np.testing.assert_array_equal(got[:, 1], got[:, 2])


def test_gather_distances_is_the_hop_f32_score():
    q, x_pad, nbrs = (T(a) for a in gather_world(5, 12, 50, 18, 4))
    assert torch.equal(tref.gather_distances(q, x_pad, nbrs),
                       tref._gather_score("f32", x_pad, None, None, q, nbrs))


def gather_design(q, x_pad, nbrs):
    """``gather_distances.cu`` in plain torch: component c = l + 32 j +
    1024 t of a row sits in lane l, register j, fold t; the folds halve
    first (``halving_fold``), then the registers, then each group of 8
    rows (the last padded with rows it discards) goes through
    ``butterfly8_sum``'s exchanges, lane by lane; lane 4 g holds row g."""
    B, d = q.shape
    R = nbrs.shape[1]
    W = max(32, tref.next_pow2(d))
    fold, M = max(1, W // 1024), min(32, W // 32)
    G = -(-R // 8) * 8
    rows = torch.zeros(B, G, W)
    rows[:, :R, :d] = x_pad[nbrs.long()]
    qq = torch.zeros(B, 1, W)
    qq[:, 0, :d] = q
    diff = rows - qq
    v = (diff * diff).reshape(B, G, fold, M, 32)
    for axis in (2, 3):                     # folds, then registers
        while v.shape[axis] > 1:
            h = v.shape[axis] // 2
            v = v.narrow(axis, 0, h) + v.narrow(axis, h, h)
    x = v.reshape(B, G // 8, 8, 32)         # x[g] of every lane
    lane = torch.arange(32)
    shfl = lambda a, m: a[..., lane ^ m]
    b4, b3, b2 = (lane & 16) != 0, (lane & 8) != 0, (lane & 4) != 0
    y = [torch.where(b4, x[:, :, g + 4], x[:, :, g])
         + shfl(torch.where(b4, x[:, :, g], x[:, :, g + 4]), 16)
         for g in range(4)]
    z = [torch.where(b3, y[g + 2], y[g])
         + shfl(torch.where(b3, y[g], y[g + 2]), 8) for g in range(2)]
    w = torch.where(b2, z[1], z[0]) + shfl(torch.where(b2, z[0], z[1]), 4)
    w = w + shfl(w, 2)
    w = w + shfl(w, 1)                       # (B, G / 8, 32)
    return w[..., ::4].reshape(B, G)[:, :R]


@pytest.mark.parametrize("d", SCAN_D + (1536,))
@pytest.mark.parametrize("R", [7, 32, 33])
def test_gather_design_is_ref_gather_distances(d, R):
    """The kernel's layout and butterfly pair the components as
    ``ref.halving_sum`` does: its bits, with values over six decades so
    the order of the adds shows, the sentinel row and R not a multiple of
    8 included."""
    q, x_pad, nbrs = gather_world(5, R, 90, d, R * d)
    scale = 10.0 ** np.random.default_rng(d).uniform(-3, 3, d)
    q, x_pad = (T((a * scale).astype(np.float32)) for a in (q, x_pad))
    x_pad[-1] = 1e9
    want = tref.gather_distances(q, x_pad, T(nbrs))
    assert same_bits(gather_design(q, x_pad, T(nbrs)), want)


# --------------------------------------------- the slice on a carried DQF
def assert_top10_exact(scan, x, q, gt):
    """The exact top-10 of ``scan`` has recall@10 1.0 against ``gt``, up
    to ties at the 10th place: a miss must lie, in float64, within the
    expansion's rounding of the 10th-place distance."""
    pred = torch.sort(scan, dim=1, stable=True).indices[:, :10].numpy()
    recall = recall_at_k(pred, gt)
    if recall < 1.0:
        d64 = ((np.asarray(q, np.float64)[:, None, :]
                - np.asarray(x, np.float64)[None]) ** 2).sum(-1)
        tol = expansion_tol(q, x)
        for b in range(len(q)):
            tenth = np.sort(d64[b])[9]
            for i in np.setxor1d(pred[b], gt[b]):
                assert abs(d64[b, i] - tenth) <= tol[b, i], (b, i)
    return recall


@pytest.mark.parametrize("mode", ["f32", "sq8", "pq"])
def test_scan_over_carried_dqf_matches_reference(built_dqf, saved, queries,
                                                  mode):
    dqf, _ = built_dqf
    x = np.asarray(dqf.x, np.float32)
    n = x.shape[0]
    arrays = dict(saved)
    over = {}
    if mode != "f32":
        over["quant"] = TQuant(mode=mode)
        arrays.update(tquant.build_quantizer(x, over["quant"]).to_arrays())
    port = dqf_from_arrays(arrays, port_cfg(dqf.cfg, **over), device="cpu")
    qt = T(queries)
    if mode == "f32":
        rows = port._dev["x_pad"][:n]
        got = tops.pairwise_l2(qt, rows)
        assert_expansion_close(got.numpy(),
                               jref.pairwise_l2(queries, dqf._dev["x_pad"][:n]),
                               queries, x)
        recall = assert_top10_exact(got, x, queries,
                                    ground_truth(rows.numpy(), queries, 10))
        assert recall >= 0.999
        return
    state = jquant.build_quantizer(x, JQuant(mode=mode))
    table = port._quant_table()
    if mode == "sq8":
        codes = table.codes[:n]
        got = tops.sq8_pairwise_l2(qt, codes, table.scale, table.zero)
        want = jref.sq8_pairwise_l2(jnp.asarray(queries),
                                    jnp.asarray(state.codes),
                                    jnp.asarray(state.sq.scale),
                                    jnp.asarray(state.sq.zero))
        np.testing.assert_array_equal(codes.numpy(), state.codes)
        assert_expansion_close(got.numpy(), want, queries, state.decode())
    else:
        view = table.with_queries(qt)
        codes = view.codes[:n]
        got = tops.pq_adc(view.luts, codes)
        luts = jquant.pq_luts(jnp.asarray(queries),
                              jnp.asarray(state.pq.centroids))
        want = jref.pq_adc(luts, jnp.asarray(state.codes))
        np.testing.assert_array_equal(codes.numpy(), state.codes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert got.shape == (len(queries), n) and bool(torch.isfinite(got).all())
