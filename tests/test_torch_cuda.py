"""The port's CUDA kernels against their plain versions: bit for bit, and
the two scans on the tensor cores' TF32 loop (``pairwise_l2`` over
float32 rows, ``sq8_pairwise_l2`` over the decoded int8 rows) within
``expansion_tol``.

The fused wave-hop in its f32, sq8 and pq score modes, dense and paged,
the brute-force top-k scorer of the mxu hot phase, and the scan and merge
entry points (``pairwise_l2``, ``sq8_pairwise_l2``, ``pq_adc``,
``pool_merge``, ``gather_distances``) over the grid of ``scan_cases``.

Imports nothing of JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test here skips (the kernels have no CPU
mode).  The synthetic worlds are shared with ``tests/test_torch_fused_hop.py``,
``tests/test_torch_quant.py`` and ``tests/test_torch_paged_hop.py``;
``duplicated_rows``, ``topk_rows``, ``paged_case``, the hop grid
(``hop_cases``), the scan grid
(``scan_cases``, ``merge_case``, ``scan_kernel``, ``same_bits``) and the
scan's tolerance
(``expansion_tol``, ``expansion_ratio``, ``tol_rows``, ``offset_case``,
``sq8_offset_case``) and its arithmetic emulated in plain torch
(``tf32_rna``, ``tf32_pairwise_l2``, ``tf32_sq8_fold_pairwise_l2``) with
``chip_smoke.py`` and ``tests/test_torch_scan.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import beam_search as tbs
from repro_torch.kernels import ref as tref


def make_world(n=220, d=18, R=10, seed=0, dead_every=13,
               sentinel_rows=(3, 50)):
    """tests/test_fused_hop.py's world plus explicit duplicate-id rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x_pad = np.concatenate([x, np.full((1, d), 1e9, np.float32)])
    adj = rng.integers(0, n, (n, R)).astype(np.int32)
    adj[::7, 1] = adj[::7, 0]                   # an id twice in one row
    for r in sentinel_rows:
        adj[r] = n
    adj[adj % 11 == 0] = n
    adj_pad = np.concatenate([adj, np.full((1, R), n, np.int32)])
    live = np.ones(n + 1, bool)
    if dead_every:
        live[::dead_every] = False
    live[n] = False
    return x_pad, adj_pad, live


def make_tree(seed=1, T=15):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 6, T).astype(np.int32),
            (rng.standard_normal(T) * 40 + 80).astype(np.float32),
            np.minimum(np.arange(T) * 2 + 1, T - 1).astype(np.int32),
            np.minimum(np.arange(T) * 2 + 2, T - 1).astype(np.int32),
            rng.uniform(0, 1, T).astype(np.float32))


def quant_table(x_pad, mode, queries, *, m=6, k=64):
    """A padded score table over the world's rows, trained by the port's
    own quantizers (``x_pad`` numpy, the table on ``queries``' device)."""
    from repro_torch.core import QuantConfig
    from repro_torch.quant import PQTable, build_quantizer

    qcfg = QuantConfig(mode=mode, pq_m=m, pq_bits=k.bit_length() - 1,
                       pq_iters=4)
    table = build_quantizer(x_pad[:-1], qcfg).device_table(
        device=queries.device)
    if isinstance(table, PQTable):
        return table.with_queries(queries)
    return table


def duplicated_rows(N, d, seed):
    """Rows with exact duplicates, so equal distances occur."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d)).astype(np.float32)
    if N > 3:
        x[N // 2:N // 2 + N // 4] = x[:N // 4]
    return x


def inert_lanes(hs, lanes, n):
    """``hs`` with ``lanes`` set to one identical inactive state (empty
    pool of sentinels ``n``, zero counters): the engines' padding lanes."""
    ids, dists = hs.ids.clone(), hs.dists.clone()
    ids[lanes] = n
    dists[lanes] = tref.INF_DIST
    out = {"ids": ids, "dists": dists}
    for f in ("expanded", "active", "terminated"):
        t = getattr(hs, f).clone()
        t[lanes] = False
        out[f] = t
    for f in ("dist_count", "update_count", "hops", "evals_done"):
        t = getattr(hs, f).clone()
        t[lanes] = 0
        out[f] = t
    stop = hs.stop_at.clone()
    stop[lanes] = tref.INT_MAX
    out["stop_at"] = stop
    return hs._replace(**out)


def paged_case(hs, page_cols, n_pad, rng, spare_pages=7):
    """A paged twin of a dense ``HopState`` whose last ``n_pad`` lanes are
    padding: inert, and all aliasing one scratch row of pages.

    The page table is a shuffled draw from a pool larger than needed;
    unreferenced pages, the scratch pages and the columns past ``n`` of
    every lane's last page hold random bytes.  Returns ``(hs_paged, pt)``
    on ``hs``'s device.
    """
    B, n1 = hs.seen.shape
    real = B - n_pad
    hs = inert_lanes(hs, slice(real, B), n1 - 1)
    ppl = -(-n1 // page_cols)
    n_pages = (real + 1) * ppl + spare_pages
    perm = rng.permutation(n_pages).astype(np.int32)
    pt = np.empty((B, ppl), np.int32)
    pt[:real] = perm[:real * ppl].reshape(real, ppl)
    pt[real:] = perm[real * ppl:(real + 1) * ppl]        # scratch row
    dev = hs.ids.device
    pool = torch.as_tensor(rng.random((n_pages, page_cols)) < 0.5,
                           device=dev)
    pt_t = torch.as_tensor(pt, device=dev)
    rows = pool[pt_t[:real].long()].reshape(real, ppl * page_cols)
    rows[:, :n1] = hs.seen[:real]
    pool[pt_t[:real].long()] = rows.reshape(real, ppl, page_cols)
    return hs._replace(seen=pool), pt_t


# ------------------------------------------------------------- hop worlds
# (tag, n, d, R, L, B, tenants, shuffled pools, pq M, pq bits): what the
# redesigned hop's paths turn on: the full network for an unsorted pool
# and for R > 32 (R not a multiple of 32, L + R not a power of two), the
# rank merge at L <= 32 and 32 < L <= 64, folded registers and a chunked
# stage at d = 1536, the per-lane table base, a pq LUT of 128 KB read from
# device memory (M = 128, K = 256), and rows over 64 KB read in place
# (f32 and sq8 at d = 65600).
HOP_WORLDS = (
    ("unsorted pools, R=37, L+R=61", 300, 18, 37, 24, 64, 1, True, 6, 6),
    ("R=70, L+R=80", 300, 24, 70, 10, 9, 1, False, 6, 6),
    ("d=1536", 400, 1536, 12, 16, 33, 1, True, 128, 6),
    ("per-lane base, 3 tenants, L=40", 300, 18, 10, 40, 40, 3, True, 6, 6),
    ("R=600", 120, 8, 600, 8, 5, 1, False, 4, 6),
    ("pq M=128 K=256, LUT in device memory", 300, 128, 16, 24, 20, 1, True,
     128, 8),
    ("d=65600, rows read in place", 64, 65600, 8, 8, 4, 1, False, 8, 6))


def _stacked_world(n, d, R, T, seed):
    """``make_world``'s recipe for T tenants, stacked (T, n+1, ·)."""
    worlds = [make_world(n=n, d=d, R=R, seed=seed + t) for t in range(T)]
    return tuple(np.stack([w[i] for w in worlds]) for i in range(3))


def _shuffle_pools(hs, lanes, rng):
    """``hs`` with the pools of ``lanes`` permuted: not sorted any more."""
    out = {f: getattr(hs, f).clone() for f in ("ids", "dists", "expanded")}
    for b in lanes:
        perm = torch.as_tensor(rng.permutation(hs.ids.shape[1]),
                               device=hs.ids.device)
        for t in out.values():
            t[b] = t[b][perm]
    return hs._replace(**out)


def hop_cases(dev, seed=0, worlds=None):
    """The redesigned hop's synthetic grid: ``(tag, mode, paged, args,
    kw)``, ``args`` the state, then ``pt`` when paged, then the rest,
    every tensor on ``dev``; ``ref.fused_hop(_paged)`` and the CUDA
    wrapper take the same call.  Each of ``HOP_WORLDS`` in f32, sq8 and
    pq, dense and paged (page_cols 64), with tree and liveness both off,
    then both on; dead rows, sentinel rows and duplicate ids in a row.
    ``worlds`` picks indices of ``HOP_WORLDS`` (all by default)."""
    from repro_torch.core import QuantConfig
    from repro_torch.kernels import ops
    from repro_torch.quant import PQTable, build_quantizer

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    for wi, (tag, n, d, R, L, B, T, shuffled, m, bits) in \
            enumerate(HOP_WORLDS):
        if worlds is not None and wi not in worlds:
            continue
        x_st, adj_st, live_st = _stacked_world(n, d, R, T, 50 + wi)
        q = t(rng.standard_normal((B, d)).astype(np.float32))
        entries = t(np.arange(0, n, n // 6)[:6].astype(np.int32))
        tid = t(rng.integers(0, T, B))
        lane_base = (tid * (n + 1)).to(torch.int32) if T > 1 else None
        x_dev = t(x_st) if T > 1 else t(x_st[0])
        adj = t(adj_st) if T > 1 else t(adj_st[0])
        live = t(live_st) if T > 1 else t(live_st[0])
        x_view = tbs.LaneTable(x_dev, tid) if T > 1 else x_dev
        hs0 = tbs.to_hop_state(tbs.init_state(x_view, q, entries, L))
        if shuffled:
            hs0 = _shuffle_pools(hs0, range(0, B, 2), rng)
        real = x_st[:, :n].reshape(T * n, d)
        specs = {"f32": ("f32", x_dev, None, None)}
        for mode in ("sq8", "pq"):
            qcfg = QuantConfig(mode=mode, pq_m=m, pq_bits=bits, pq_iters=2)
            table = build_quantizer(real, qcfg).device_table(device=dev)
            if isinstance(table, PQTable):
                table = table.with_queries(q)
            mode_, codes, t1, t2 = ops.table_spec(table)
            # each tenant's n code rows, then the sentinel's
            codes = torch.cat([torch.cat([codes[i * n:(i + 1) * n],
                                          codes[-1:]])[None]
                               for i in range(T)])
            specs[mode] = (mode_, codes if T > 1 else codes[0], t1, t2)
        tree = tuple(t(a) for a in make_tree())
        hf = t(rng.uniform(1, 6, B).astype(np.float32))
        hr = t(rng.uniform(0.5, 1.5, B).astype(np.float32))
        kw = dict(hops=12, max_hops=40, k=5, eval_gap=25, add_step=6,
                  tree_depth=4, lane_base=lane_base)
        for mode, spec in specs.items():
            for use_tree in (False, True):
                for paged in (False, True):
                    hs = hs0._replace(seen=hs0.seen.clone())
                    lead = (hs,)
                    kwp = kw
                    if paged:
                        lead = paged_case(hs, 64, max(1, B // 8), rng)
                        kwp = dict(kw, page_cols=64)
                    args = (adj, q, live if use_tree else None, *spec,
                            *((tree, hf, hr) if use_tree else
                              (None, None, None)))
                    yield (f"{tag} {mode} {'paged' if paged else 'dense'} "
                           f"tree={use_tree}", mode, paged, lead + args, kwp)


# ------------------------------------------------- scan and merge kernels
SCAN_KERNELS = ("pairwise_l2", "sq8_pairwise_l2", "pq_adc", "pool_merge",
                "gather_distances")
SCAN_B = (1, 7, 130)
SCAN_N = (1, 63, 129, 5000)
SCAN_D = (18, 100, 128)
# (M, K): pq_adc.cu's lanes layout (M = 4, 6, 8), its staged kernel past 8
# subspaces (M = 16, 32, 64) and that kernel's folded sum past 64 (M = 128)
SCAN_PQ = ((4, 64), (4, 256), (6, 64), (8, 64), (8, 256), (32, 64),
           (64, 16), (16, 256), (128, 256))
SCAN_PQ_B = SCAN_B + (16, 33)     # a whole and a ragged group of 16 queries
SCAN_PQ_N = SCAN_N + (5003,)      # a ragged run of 8 rows a lane
# (L, C): the rank merge (L <= 64, C <= 32: one and two pool entries a
# lane), then the warp's register network (S = next_pow2(L + C) <= 256),
# the block's network in shared memory, and in a global scratch past 227 KB
SCAN_MERGE = ((8, 8), (64, 32), (10, 7), (33, 20), (64, 33), (200, 48),
              (300, 200), (20000, 5))
# pools sorted; sorted with NaN, -0.0 and +0.0 keys; then not sorted
MERGE_KINDS = ("sorted", "nan", "unsorted")
# R not a multiple of 8 on either side of one and of four groups of 8
SCAN_GATHER_R = (7, 33)
_SCAN_MODULES = {"pairwise_l2": "distance", "sq8_pairwise_l2": "sq_distance",
                 "pq_adc": "pq_adc", "pool_merge": "topk_merge",
                 "gather_distances": "gather_distance"}


def scan_kernel(name):
    """(CUDA launch wrapper, plain version) of a scan or merge kernel."""
    mod = importlib.import_module(f"repro_torch.kernels.{_SCAN_MODULES[name]}")
    return getattr(mod, f"{name}_cuda"), getattr(tref, name)


def scan_cases(name, dev, seed=0):
    """The synthetic grid of one scan or merge kernel: ``(tag, args)``
    pairs, the arguments on ``dev``.

    Rows with exact duplicates and a query equal to row 0 (ties, a zero
    distance, cancellation); sq8 codes that reach -127 and 127; pq codes
    that reach 0 and K - 1 (a whole row of each), B past and below a
    group of 16 queries, N not a multiple of 8, and M = 128 past the
    register tile; pools and candidates of :func:`merge_case`, each
    (L, C) of ``SCAN_MERGE`` in every kind of ``MERGE_KINDS``; neighbour
    rows with the sentinel id and a duplicated id, R not a multiple of 8,
    and d = 1536 past 1024.
    """
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    f32 = lambda a: np.asarray(a, np.float32)
    if name in ("pairwise_l2", "sq8_pairwise_l2"):
        for d in SCAN_D:
            scale = f32(rng.uniform(0.005, 0.05, d))
            zero = f32(rng.standard_normal(d) * 0.3)
            for N in SCAN_N:
                x = duplicated_rows(N, d, N + d)
                codes = rng.integers(-127, 128, (N, d)).astype(np.int8)
                codes[0, 0], codes[-1, -1] = -127, 127
                rows = (t(x),) if name == "pairwise_l2" else (
                    t(codes), t(scale), t(zero))
                for B in SCAN_B:
                    q = f32(rng.standard_normal((B, d)))
                    if name == "pairwise_l2":
                        q[0] = x[0]
                    yield f"B={B} N={N} d={d}", (t(q), *rows)
    elif name == "pq_adc":
        for M, K in SCAN_PQ:
            for N in SCAN_PQ_N:
                codes = rng.integers(0, K, (N, M)).astype(np.uint8)
                codes[0, 0], codes[-1, -1] = K - 1, 0
                if N > 3:
                    codes[1], codes[2] = K - 1, 0
                for B in SCAN_PQ_B:
                    luts = f32(rng.uniform(0, 8, (B, M, K)))
                    yield f"B={B} N={N} M={M} K={K}", (t(luts), t(codes))
    elif name == "pool_merge":
        for kind in MERGE_KINDS:
            for L, C in SCAN_MERGE:
                for B in SCAN_B:
                    yield (f"{kind} B={B} L={L} C={C}",
                           tuple(map(t, merge_case(kind, B, L, C, rng))))
    elif name == "gather_distances":
        n = 300
        for d in SCAN_D + (1536,):
            x = rng.standard_normal((n, d)).astype(np.float32)
            x_pad = np.concatenate([x, np.full((1, d), 1e9, np.float32)])
            for R in (32 if d == 128 else 10,) + SCAN_GATHER_R:
                for B in SCAN_B:
                    q = f32(rng.standard_normal((B, d)))
                    nbrs = rng.integers(0, n + 1, (B, R)).astype(np.int32)
                    nbrs[:, 0] = n                       # the sentinel row
                    nbrs[:, 2] = nbrs[:, 1]              # an id twice
                    yield f"B={B} R={R} d={d}", (t(q), t(x_pad), t(nbrs))
    else:
        raise ValueError(f"no scan kernel {name!r}")


def _float_bits(bits):
    return np.array(bits, np.uint32).view(np.float32)


def merge_case(kind, B, L, C, rng):
    """(pool dists, pool ids, cand dists, cand ids) as numpy arrays: keys
    0..5, so equal keys abound; the pool sorted with +inf in its last two
    slots and ``INF_DIST`` in the last row's second half, a candidate
    +inf, and one equal to its row's pool head.  ``"nan"`` adds -0.0
    beside +0.0 in both, and NaN keys (positive, negative and with a
    payload) in the pool's second half and in every third candidate, the
    pool still sorted in the plain version's order (NaN last), so that
    where NaNs outnumber the candidates some are kept; ``"unsorted"`` is
    ``"nan"`` with each pool row shuffled."""
    f32 = lambda a: np.asarray(a, np.float32)
    pd = np.sort(f32(rng.integers(0, 6, (B, L))), axis=1)
    pd[:, -2:] = np.inf                                  # empty slots
    pd[-1, L // 2:] = tref.INF_DIST                      # the search's empty
    cd = f32(rng.integers(0, 6, (B, C)))
    cd[:, 0] = np.inf
    cd[:, -1] = pd[:, 0]                                 # ties the pool head
    pi = rng.integers(0, 1000, (B, L)).astype(np.int32)
    ci = rng.integers(0, 1000, (B, C)).astype(np.int32)
    if kind in ("nan", "unsorted"):
        nans = _float_bits([0x7FC00000, 0xFFC00000, 0x7F800123])
        pd[pd == 0] *= np.where(rng.random((pd == 0).sum()) < 0.5, -1, 1)
        pd[:, L // 2:] = nans[(np.arange(B)[:, None] + np.arange(L - L // 2))
                              % 3]
        cd[cd == 0] = -0.0
        cd[::2, C // 3] = 0.0
        cd[:, 1:C - 1:3] = nans[np.arange(B) % 3][:, None]
    if kind == "unsorted":
        pd = np.take_along_axis(pd, rng.permuted(
            np.tile(np.arange(L), (B, 1)), axis=1), 1)
    elif kind not in ("sorted", "nan"):
        raise ValueError(f"no merge case kind {kind!r}")
    return pd, pi, cd, ci


def expansion_tol(q, x):
    """(B, N) bound 1e-5 · (|q|² + |x|²) on the rounding of the expansion
    (|q|² + |x|²) − 2 q·x, in float64: the contract of the float32 scan
    against its plain version and of the port against the JAX package.
    Numpy arrays, or tensors (computed on their own device)."""
    if isinstance(q, torch.Tensor):
        q64, x64 = q.double(), x.double()
    else:
        q64, x64 = np.asarray(q, np.float64), np.asarray(x, np.float64)
    return 1e-5 * ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :])


def expansion_ratio(got, want, q, x) -> float:
    """Largest |got − want| / (|q|² + |x|²): within the contract at
    ≤ 1e-5.  Tensors on one device."""
    diff = (got.double() - want.double()).abs()
    if diff.numel() == 0:
        return 0.0
    ratio = torch.where(diff == 0, 0.0, diff / expansion_tol(q, x))
    return float(ratio.max()) * 1e-5


def sq8_decode(codes, scale, zero):
    """int8 rows decoded as ``code * scale + zero``, two roundings, as
    ``ref.sq8_pairwise_l2`` decodes them."""
    return codes.to(torch.float32) * scale + zero


def tol_rows(name, args):
    """(queries, rows) against which a scan kernel's tolerance is counted:
    the float32 rows, or the decoded int8 rows; None for the kernels held
    bit for bit."""
    if name == "pairwise_l2":
        return args
    if name == "sq8_pairwise_l2":
        return args[0], sq8_decode(*args[1:])
    return None


def offset_case(B, N, d, seed, offset=100.0):
    """Rows and queries sharing a large common offset ``offset · u`` along
    a fixed unit vector u, with a query equal to row 0: |q|² and |x|² are
    about offset², the distances O(d), so the expansion cancels hard."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(d)
    u = (offset * u / np.linalg.norm(u)).astype(np.float32)
    x = rng.standard_normal((N, d)).astype(np.float32) + u
    q = rng.standard_normal((B, d)).astype(np.float32) + u
    q[0] = x[0]
    return q, x


def sq8_offset_case(B, N, d, seed, offset=100.0):
    """:func:`offset_case` with its rows int8-encoded per dimension (zero at
    the midpoint of the column's range, scale its width / 254): queries,
    codes, scale and zero as numpy arrays."""
    q, x = offset_case(B, N, d, seed, offset)
    lo, hi = x.min(0), x.max(0)
    zero = ((hi + lo) / 2).astype(np.float32)
    scale = np.maximum((hi - lo) / 254, 1e-6).astype(np.float32)
    codes = np.clip(np.rint((x - zero) / scale), -127, 127).astype(np.int8)
    return q, codes, scale, zero


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 fraction bits) to nearest, ties away
    from zero: ``cvt.rna.tf32.f32`` by bit masking."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_pairwise_l2(q: torch.Tensor, x: torch.Tensor,
                     split: bool = True) -> torch.Tensor:
    """The arithmetic of ``pairwise_l2.cu``'s F32 mode in plain torch: each
    operand split a = hi + lo (hi = tf32(a), lo = tf32(a − hi)), the dot
    product as lo·hi + hi·lo + hi·hi in float32 with a_lo·b_lo dropped,
    and the norms and the epilogue of ``ref.pairwise_l2``.  A product of
    two TF32 values is exact in float32, so only the sums round.
    ``split=False`` keeps hi·hi alone, one TF32 product: the lower
    precision the scan's tolerance must reject."""
    qh, xh = tf32_rna(q), tf32_rna(x)
    dot = qh @ xh.T
    if split:
        ql, xl = tf32_rna(q - qh), tf32_rna(x - xh)
        dot = (ql @ xh.T + qh @ xl.T) + dot
    q_sq, x_sq = tref._seq_dot(q, q), tref._seq_dot(x, x)
    return (q_sq[:, None] + x_sq[None, :]) - 2.0 * dot


def tf32_sq8_fold_pairwise_l2(q, codes, scale, zero) -> torch.Tensor:
    """The kernel's own SQ8 arithmetic in plain torch: the query scaled by
    ``scale`` (one rounding) and split a = hi + lo as in
    :func:`tf32_pairwise_l2`, the codes exact in TF32, the dot product as
    lo·code + hi·code in float32 plus the sequential ``q·zero``, and the
    norms and the epilogue of ``ref.sq8_pairwise_l2``."""
    a = q * scale
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    c = codes.to(torch.float32)
    dot = (al @ c.T + ah @ c.T) + tref._seq_dot(q, zero.expand_as(q))[:, None]
    x = sq8_decode(codes, scale, zero)
    q_sq, x_sq = tref._seq_dot(q, q), tref._seq_dot(x, x)
    return (q_sq[:, None] + x_sq[None, :]) - 2.0 * dot


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (float32 compared as int32; tuples
    element by element), compared on the tensors' own device."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(same_bits, a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("use_tree", [False, True])
@pytest.mark.parametrize("use_live", [False, True])
def test_cuda_kernel_bit_identical(cuda_device, B, use_tree, use_live):
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    dev = cuda_device
    x_pad, adj_pad, live = (torch.as_tensor(a, device=dev)
                            for a in make_world(seed=B))
    live_pad = live if use_live else None
    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.standard_normal((B, 18)).astype(np.float32),
                        device=dev)
    entries = torch.arange(0, 220, 37, dtype=torch.int32, device=dev)
    st = tbs.init_state(x_pad, q, entries, 16, live_pad)
    tree = hf = hr = None
    if use_tree:
        tree = tuple(torch.as_tensor(a, device=dev) for a in make_tree())
        hf = torch.as_tensor(rng.uniform(1, 6, B).astype(np.float32),
                             device=dev)
        hr = torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32),
                             device=dev)
    kw = dict(hops=15, max_hops=40, k=5, eval_gap=25, add_step=6,
              tree_depth=4)
    fresh = lambda: tbs.to_hop_state(st._replace(seen=st.seen.clone()))
    want = tref.fused_hop(fresh(), adj_pad, q, live_pad, "f32", x_pad, None,
                          None, tree, hf, hr, **kw)
    before = fused_hop_cuda.launches
    got = fused_hop_cuda(fresh(), adj_pad, q, live_pad, "f32", x_pad, None,
                         None, tree, hf, hr, **kw)
    torch.cuda.synchronize()
    assert fused_hop_cuda.launches == before + 1
    for f in tref.HopState._fields:
        a, b = getattr(want, f).cpu(), getattr(got, f).cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


@pytest.mark.cuda
def test_cuda_dispatch_and_refusals(cuda_device):
    from repro_torch.kernels import ops

    dev = cuda_device
    x_pad, adj_pad, live = (torch.as_tensor(a, device=dev)
                            for a in make_world())
    q = torch.zeros((4, 18), device=dev)
    st = tbs.init_state(x_pad, q, torch.arange(0, 220, 53, device=dev), 8,
                        live)
    hs = tbs.to_hop_state(st)
    out = ops.fused_hop(hs, adj_pad, q, live, x_pad, hops=2, max_hops=8)
    assert out.ids.device.type == "cuda"
    with pytest.raises(ValueError, match="cpu|device"):
        ops.fused_hop(hs, adj_pad.cpu(), q, live, x_pad, hops=2, max_hops=8)
    with pytest.raises(TypeError):
        ops.fused_hop(hs._replace(dists=hs.dists.double()), adj_pad, q, live,
                      x_pad, hops=2, max_hops=8)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sq8", "pq"])
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("use_tree", [False, True])
@pytest.mark.parametrize("use_live", [False, True])
def test_cuda_quant_hop_bit_identical(cuda_device, mode, B, use_tree,
                                      use_live):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    dev = cuda_device
    world = make_world(seed=B)
    x_pad, adj_pad, live = (torch.as_tensor(a, device=dev) for a in world)
    live_pad = live if use_live else None
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.standard_normal((B, 18)).astype(np.float32),
                        device=dev)
    table = quant_table(world[0], mode, q)
    entries = torch.arange(0, 220, 37, dtype=torch.int32, device=dev)
    st = tbs.init_state(x_pad, q, entries, 16, live_pad)
    tree = hf = hr = None
    if use_tree:
        tree = tuple(torch.as_tensor(a, device=dev) for a in make_tree())
        hf = torch.as_tensor(rng.uniform(1, 6, B).astype(np.float32),
                             device=dev)
        hr = torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32),
                             device=dev)
    kw = dict(hops=15, max_hops=40, k=5, eval_gap=25, add_step=6,
              tree_depth=4)
    fresh = lambda: tbs.to_hop_state(st._replace(seen=st.seen.clone()))
    spec = ops.table_spec(table)
    assert spec[0] == mode
    want = tref.fused_hop(fresh(), adj_pad, q, live_pad, *spec, tree, hf,
                          hr, **kw)
    before = fused_hop_cuda.launches
    got = fused_hop_cuda(fresh(), adj_pad, q, live_pad, *spec, tree, hf, hr,
                         **kw)
    torch.cuda.synchronize()
    assert fused_hop_cuda.launches == before + 1
    for f in tref.HopState._fields:
        a, b = getattr(want, f).cpu(), getattr(got, f).cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def topk_rows(N, d, seed, equal=False):
    """Rows for the top-k: duplicated rows (ties), or N equal rows (every
    key ties, so the ids must come out 0..k-1)."""
    if equal:
        row = np.random.default_rng(seed).standard_normal(d)
        return np.repeat(row[None].astype(np.float32), N, axis=0)
    return duplicated_rows(N, d, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,k,d,equal", [
    (1, 1, 1, 18, False), (5, 31, 10, 18, False), (64, 5003, 32, 128, False),
    (70, 7, 12, 24, False), (1000, 5000, 64, 128, False),
    (1024, 5000, 32, 128, False),     # the mxu hot phase's shape
    (1024, 100, 64, 128, False),      # a row range holds fewer than k rows
    (64, 5000, 32, 128, True),        # all rows equal
    (33, 700, 16, 17, False),         # odd d: 4-byte copies
    (1024, 5000, 100, 24, False),     # k > 64: merges of up to 256 entries
    (1024, 5000, 300, 18, False),     # k > 192: merges of up to 512
    (256, 5000, 448, 24, False),      # the largest threshold merge
    (256, 5000, 449, 24, False),      # past it: whole ranges sorted
    (256, 5000, 1024, 24, False),
    (64, 5000, 4096, 24, False),
    (64, 5000, 5000, 18, False),      # k = N
    (64, 3000, 3500, 18, False),      # k > N
    (64, 5000, 449, 32, True)])       # all rows equal past 448
def test_cuda_topk_bit_identical(cuda_device, B, N, k, d, equal):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk_l2 import fused_topk_l2_cuda

    dev = cuda_device
    rng = np.random.default_rng(B + N)
    x = torch.as_tensor(topk_rows(N, d, N, equal), device=dev)
    q = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32),
                        device=dev)
    q[0] = x[0]                                  # a zero-distance tie
    want_d, want_i = tref.fused_topk_l2(q, x, k=k)
    before = fused_topk_l2_cuda.launches
    got_d, got_i = ops.fused_topk_l2(q, x, k=k)
    torch.cuda.synchronize()
    assert fused_topk_l2_cuda.launches == before + 1
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    if k > N:
        assert bool((got_i[:, N:] == N).all())
    if equal:
        first = torch.arange(k, dtype=torch.int32, device=dev)
        assert torch.equal(got_i, first.expand(B, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("max_hops", [0, 5, 512])
def test_cuda_fused_beam_loop_equals_composed_loop(cuda_device, max_hops):
    """``fused_beam_loop`` on the card (one launch) ≡ ``beam_loop``, every
    field bit-identical, ``max_hops`` = 0 included."""
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    t = lambda a: torch.as_tensor(a, device=cuda_device)
    x_pad, adj_pad, live = map(t, make_world())
    q = t(np.random.default_rng(4).standard_normal((64, 18))
          .astype(np.float32))
    state = tbs.init_state(x_pad, q, t(np.arange(0, 220, 31)
                                       .astype(np.int32)), 16, live)
    fresh = lambda: state._replace(seen=state.seen.clone())
    want = tbs.beam_loop(x_pad, adj_pad, q, fresh(), max_hops, live)
    before = fused_hop_cuda.launches
    got = tbs.fused_beam_loop(x_pad, adj_pad, q, fresh(), max_hops, live)
    assert fused_hop_cuda.launches == before + 1
    assert same_bits(tuple(tbs.to_hop_state(want)),
                     tuple(tbs.to_hop_state(got)))


@pytest.mark.cuda
@pytest.mark.parametrize("world", range(len(HOP_WORLDS)))
def test_cuda_hop_worlds_bit_identical(cuda_device, world):
    """The redesigned hop on ``hop_cases``: every mode, dense and paged,
    every ``HopState`` field and the whole page pool bit-identical to the
    plain version, one launch a case."""
    from repro_torch.kernels.fused_hop import (fused_hop_cuda,
                                               fused_hop_paged_cuda)

    n_cases = 0
    for tag, _, paged, args, kw in hop_cases(cuda_device, worlds=(world,)):
        fresh = lambda: (args[0]._replace(seen=args[0].seen.clone()),) \
            + args[1:]
        plain, cuda_fn = ((tref.fused_hop_paged, fused_hop_paged_cuda)
                          if paged else (tref.fused_hop, fused_hop_cuda))
        want = plain(*fresh(), **kw)
        before = cuda_fn.launches
        got = cuda_fn(*fresh(), **kw)
        torch.cuda.synchronize()
        assert cuda_fn.launches == before + 1, tag
        bad = [f for f in tref.HopState._fields
               if not same_bits(getattr(want, f), getattr(got, f))]
        assert not bad, f"{tag}: {bad}"
        n_cases += 1
    assert n_cases == 12


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "sq8", "pq"])
@pytest.mark.parametrize("page_cols", [64, 256])
@pytest.mark.parametrize("use_tree", [False, True])
@pytest.mark.parametrize("use_live", [False, True])
def test_cuda_paged_hop_bit_identical(cuda_device, mode, page_cols, use_tree,
                                      use_live):
    """The paged mode ≡ ``ref.fused_hop_paged`` on every HopState field
    and on the whole pool (unreferenced pages and tails included), with
    padding lanes aliasing one scratch row."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_hop import fused_hop_paged_cuda

    dev = cuda_device
    B, n_pad = 67, 3
    world = make_world(seed=page_cols)
    x_pad, adj_pad, live = (torch.as_tensor(a, device=dev) for a in world)
    live_pad = live if use_live else None
    rng = np.random.default_rng(13)
    q = torch.as_tensor(rng.standard_normal((B, 18)).astype(np.float32),
                        device=dev)
    table = x_pad if mode == "f32" else quant_table(world[0], mode, q)
    spec = ops.table_spec(table)
    entries = torch.arange(0, 220, 37, dtype=torch.int32, device=dev)
    hs, pt = paged_case(tbs.to_hop_state(tbs.init_state(
        x_pad, q, entries, 16, live_pad)), page_cols, n_pad, rng)
    tree = hf = hr = None
    if use_tree:
        tree = tuple(torch.as_tensor(a, device=dev) for a in make_tree())
        hf = torch.as_tensor(rng.uniform(1, 6, B).astype(np.float32),
                             device=dev)
        hr = torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32),
                             device=dev)
    kw = dict(page_cols=page_cols, hops=15, max_hops=40, k=5, eval_gap=25,
              add_step=6, tree_depth=4)
    fresh = lambda: hs._replace(seen=hs.seen.clone())
    want = tref.fused_hop_paged(fresh(), pt, adj_pad, q, live_pad, *spec,
                                tree, hf, hr, **kw)
    before = fused_hop_paged_cuda.launches
    got = fused_hop_paged_cuda(fresh(), pt, adj_pad, q, live_pad, *spec,
                               tree, hf, hr, **kw)
    torch.cuda.synchronize()
    assert fused_hop_paged_cuda.launches == before + 1
    for f in tref.HopState._fields:
        a, b = getattr(want, f).cpu(), getattr(got, f).cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCAN_KERNELS)
def test_cuda_scan_kernel_bit_identical(cuda_device, name):
    """``ops.<name>`` on CUDA tensors launches the kernel once per call and
    meets its contract over the whole synthetic grid: ``pairwise_l2`` and
    ``sq8_pairwise_l2`` (TF32 on the tensor cores) within
    :func:`expansion_tol` of the plain version, over the float32 or the
    decoded rows, the other three bit for bit."""
    from repro_torch.kernels import ops

    cuda_fn, plain = scan_kernel(name)
    n_cases = 0
    for tag, args in scan_cases(name, cuda_device):
        want = plain(*args)
        before = cuda_fn.launches
        got = getattr(ops, name)(*args)
        torch.cuda.synchronize()
        assert cuda_fn.launches == before + 1, tag
        rows = tol_rows(name, args)
        if rows is not None:
            assert got.shape == want.shape, tag
            assert expansion_ratio(got, want, *rows) <= 1e-5, tag
        else:
            assert same_bits(want, got), f"{name} {tag}"
        n_cases += 1
    assert n_cases >= 9


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MERGE_KINDS)
def test_cuda_plain_pool_merge_equals_cpu(cuda_device, kind):
    """The plain ``pool_merge`` on CUDA tensors gives the bits it gives on
    the CPU for every :func:`merge_case` of ``kind`` (NaN of either sign,
    ±0.0, shuffled pools), where the CPU's equal the JAX reference's
    (``tests/test_torch_scan.py``): so the kernel, held to the plain
    version on the card, is held to JAX."""
    rng = np.random.default_rng(1)
    for L, C in SCAN_MERGE:
        for B in SCAN_B:
            args = merge_case(kind, B, L, C, rng)
            cpu = tref.pool_merge(*map(torch.as_tensor, args))
            card = tref.pool_merge(*(torch.as_tensor(a, device=cuda_device)
                                     for a in args))
            assert same_bits(cpu, tuple(t.cpu() for t in card)), (
                f"{kind} B={B} L={L} C={C}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d", [(130, 5000, 128), (7, 129, 18),
                                   (64, 1000, 100)])
def test_cuda_pairwise_l2_offset_within_tolerance(cuda_device, B, N, d):
    """Severe cancellation: rows and queries share a common offset of
    length 100, and the 3xTF32 scan stays within :func:`expansion_tol`."""
    from repro_torch.kernels import ops

    q, x = (torch.as_tensor(a, device=cuda_device)
            for a in offset_case(B, N, d, B + N))
    got = ops.pairwise_l2(q, x)
    want = tref.pairwise_l2(q, x)
    torch.cuda.synchronize()
    assert expansion_ratio(got, want, q, x) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,d", [(130, 5000, 128), (7, 129, 18),
                                   (64, 1000, 100)])
def test_cuda_sq8_pairwise_l2_offset_within_tolerance(cuda_device, B, N, d):
    """The int8 scan with its rows 100 · u off the origin stays within
    :func:`expansion_tol` over the decoded rows, and the control, one TF32
    product over the same rows, leaves it."""
    from repro_torch.kernels import ops

    q, codes, scale, zero = (torch.as_tensor(a, device=cuda_device)
                             for a in sq8_offset_case(B, N, d, B + N))
    got = ops.sq8_pairwise_l2(q, codes, scale, zero)
    want = tref.sq8_pairwise_l2(q, codes, scale, zero)
    x = sq8_decode(codes, scale, zero)
    control = tf32_pairwise_l2(q, x, split=False)
    torch.cuda.synchronize()
    assert expansion_ratio(got, want, q, x) <= 1e-5
    assert expansion_ratio(control, want, q, x) > 1e-5


@pytest.mark.cuda
def test_cuda_sq8_one_tf32_product_leaves_tolerance(cuda_device):
    """The control on the card over the synthetic grid: one TF32 product
    over the decoded rows leaves :func:`expansion_tol`, which the kernel
    meets on the same cases, so the tolerance tells the two apart."""
    from repro_torch.kernels import ops

    worst_kernel, worst_control = 0.0, 0.0
    for tag, args in scan_cases("sq8_pairwise_l2", cuda_device):
        want = tref.sq8_pairwise_l2(*args)
        rows = tol_rows("sq8_pairwise_l2", args)
        worst_kernel = max(worst_kernel, expansion_ratio(
            ops.sq8_pairwise_l2(*args), want, *rows))
        worst_control = max(worst_control, expansion_ratio(
            tf32_pairwise_l2(*rows, split=False), want, *rows))
    assert worst_kernel <= 1e-5 < worst_control, (worst_kernel, worst_control)
