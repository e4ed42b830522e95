"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. card: torch/CUDA versions, the card's name and power limit, TF32 off;
2. build: every CUDA source of ``src/repro_torch/kernels/csrc`` with nvcc;
3. the fused wave-hop kernel against its plain version on synthetic
   worlds (sentinel rows, scattered sentinel slots, dead rows, duplicate
   ids in a row; B in {1, 64, 1000}; tree and liveness on and off; a wave
   that runs dry): every HopState field must be bit-identical;
4. the main path at one million rows x 128: DQF build → warm → fit_tree
   → 4 searches of 1024 queries, fused kernel on, with build, warm and
   fit times, per-batch search time and QPS, recall@10, mean dist_count,
   early-termination share, peak memory, and the kernel's launches in
   the 4 searches (counted from 0 just before them; must be > 0);
5. the same 1024 queries through the composed path (fused=False): ids,
   dists and counters must be bit-identical to the fused run;
6. kernel timing at the main path's shapes beside its plain version and
   its bound, printed as one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  There is no CPU path:
without a CUDA device the script exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside tensor cores
N = 1_000_000                    # rows of the main path's index


def log(*a):
    print(*a, flush=True)


def make_clustered(n, d, clusters, seed, spread=1.5):
    """The recipe of tests/conftest.py::make_clustered."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * spread
    asg = rng.integers(0, clusters, n)
    x = centers[asg] + rng.standard_normal((n, d)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def clone_state(hs):
    return type(hs)(*(t.clone() for t in hs))


# ------------------------------------------------------------------ phase 3
def synthetic_world(n, d, R, seed, dead_every, sentinel_rows, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x_pad = np.concatenate([x, np.full((1, d), 1e9, np.float32)])
    adj = rng.integers(0, n, (n, R)).astype(np.int32)
    adj[::7, 1] = adj[::7, 0]                   # duplicate ids in one row
    for r in sentinel_rows:
        adj[r] = n                              # all-sentinel adjacency row
    adj[adj % 11 == 0] = n                      # scattered sentinel slots
    adj_pad = np.concatenate([adj, np.full((1, R), n, np.int32)])
    live = np.ones(n + 1, bool)
    if dead_every:
        live[::dead_every] = False
    live[n] = False
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(x_pad), t(adj_pad), t(live)


def synthetic_tree(seed, T, dev, scale):
    rng = np.random.default_rng(seed)
    arr = [rng.integers(-1, 6, T).astype(np.int32),
           (rng.standard_normal(T) * 0.5 * scale + scale).astype(np.float32),
           np.minimum(np.arange(T) * 2 + 1, T - 1).astype(np.int32),
           np.minimum(np.arange(T) * 2 + 2, T - 1).astype(np.int32),
           rng.uniform(0, 1, T).astype(np.float32)]
    return tuple(torch.as_tensor(a, device=dev) for a in arr)


def phase_synthetic(dev):
    from repro_torch.core import beam_search as bs
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    rng = np.random.default_rng(7)
    cases = []
    small = dict(n=220, d=18, R=10, L=16, dead_every=13,
                 sentinel_rows=(3, 50), kw=dict(
                     hops=15, max_hops=40, k=5, eval_gap=25, add_step=6,
                     tree_depth=4), scale=80.0)
    large = dict(n=50_000, d=128, R=32, L=64, dead_every=13,
                 sentinel_rows=(3, 50), kw=dict(
                     hops=24, max_hops=64, k=10, eval_gap=50, add_step=0,
                     tree_depth=6), scale=200.0)
    for world in (small, large):
        for B in (1, 64, 1000):
            for use_tree in (False, True):
                for use_live in (False, True):
                    cases.append((world, B, use_tree, use_live))
    dry = dict(n=40, d=18, R=4, L=8, dead_every=0, sentinel_rows=(1,),
               kw=dict(hops=64, max_hops=512), scale=80.0)
    cases.append((dry, 3, False, False))
    max_err = 0.0
    for i, (w, B, use_tree, use_live) in enumerate(cases):
        x_pad, adj_pad, live = synthetic_world(
            w["n"], w["d"], w["R"], i, w["dead_every"], w["sentinel_rows"],
            dev)
        q = torch.as_tensor(rng.standard_normal((B, w["d"]))
                            .astype(np.float32), device=dev)
        entries = torch.arange(0, w["n"], max(1, w["n"] // 6),
                               dtype=torch.int32, device=dev)[:6]
        live_pad = live if use_live else None
        hs = bs.to_hop_state(bs.init_state(x_pad, q, entries, w["L"],
                                           live_pad))
        tree = hf = hr = None
        if use_tree:
            tree = synthetic_tree(i, 31, dev, w["scale"])
            hf = torch.as_tensor(rng.uniform(1, 6, B).astype(np.float32),
                                 device=dev)
            hr = torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32),
                                 device=dev)
        want = ref.fused_hop(clone_state(hs), adj_pad, q, live_pad, "f32",
                             x_pad, tree, hf, hr, **w["kw"])
        got = fused_hop_cuda(clone_state(hs), adj_pad, q, live_pad, x_pad,
                             tree, hf, hr, **w["kw"])
        torch.cuda.synchronize()
        bad = [f for f in ref.HopState._fields
               if not bits_equal(getattr(want, f), getattr(got, f))]
        max_err = max(max_err, float((want.dists - got.dists).abs().max()))
        tag = (f"n={w['n']} d={w['d']} R={w['R']} L={w['L']} B={B} "
               f"tree={use_tree} live={use_live}")
        if bad:
            raise SystemExit(f"synthetic world {tag}: fields differ: {bad}")
        log(f"  synthetic {tag}: bit-identical "
            f"(active left {int(got.active.sum())}, "
            f"terminated {int(got.terminated.sum())})")
        if w is dry and bool(got.active.any()):
            raise SystemExit("dry wave: lanes still active after 64 hops")
    return len(cases), max_err


# ------------------------------------------------------------ phases 4 + 5
def phase_main(dev, n, seed):
    from repro_torch.core import DQF, DQFConfig, ZipfWorkload
    from repro_torch.core.recall import ground_truth, recall_at_k
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    x = make_clustered(n, 128, clusters=1024, seed=seed)
    cfg = DQFConfig(knn_k=32, out_degree=32, index_ratio=0.005, k=10,
                    hot_pool=32, full_pool=64, eval_gap=50, max_hops=512,
                    fused=True, fused_hops=8, hot_mode="graph")
    wl = ZipfWorkload(x, seed=seed)
    warm_q, fit_q = wl.sample(4096), wl.sample(2048)
    batches = [wl.sample(1024) for _ in range(4)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dqf = DQF(cfg, device=dev).build(x)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    fused_hop_cuda.launches = 0
    t0 = time.perf_counter()
    dqf.warm(warm_q)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm_launches = fused_hop_cuda.launches
    t0 = time.perf_counter()
    dqf.fit_tree(fit_q)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    log(f"  build {t_build:.3f} s  warm {t_warm:.3f} s "
        f"({warm_launches} fused_hop launches in its baseline search)  "
        f"fit_tree {t_fit:.3f} s  (hot index {dqf.hot.size} rows, "
        f"tree {dqf.tree.arrays.value.numel()} nodes)")
    results, times = [], []
    fused_hop_cuda.launches = 0
    for i, q in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        res = dqf.search(q)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = start.elapsed_time(end)
        times.append(ms)
        results.append(res)
        log(f"  search batch {i}: {ms:.3f} ms (CUDA events), wall "
            f"{wall * 1e3:.3f} ms, {1024 / (ms / 1e3):.1f} QPS")
    launches = fused_hop_cuda.launches
    peak = torch.cuda.max_memory_allocated()

    ids = torch.cat([r.ids for r in results]).cpu().numpy()
    dists = torch.cat([r.dists for r in results])
    dc = torch.cat([r.stats.dist_count for r in results]).float()
    term = torch.cat([r.stats.terminated_early for r in results]).float()
    if ids.shape != (4096, 10) or not bool(torch.isfinite(dists).all()):
        raise SystemExit("search output malformed (shape or non-finite)")
    if ids.min() < 0 or ids.max() >= n:
        raise SystemExit("search returned ids outside the index")
    gt = ground_truth(x, np.concatenate(batches), 10, device=dev)
    recall = recall_at_k(ids, gt)
    qps = 4 * 1024 / (sum(times) / 1e3)
    log(f"  recall@10 {recall:.4f}  mean QPS {qps:.1f}  mean dist_count "
        f"{float(dc.mean()):.2f}  terminated early {float(term.mean()):.4f}")
    log(f"  fused_hop launches in the 4 searches: {launches}  peak device "
        f"memory {peak / 2**30:.3f} GiB")
    if launches <= 0:
        raise SystemExit("the 4 searches never launched the fused_hop kernel")
    if recall < 0.5:
        raise SystemExit(f"recall@10 {recall:.4f} is below 0.5")

    # --- phase 5: composed path on the same queries, bit for bit ---
    log("phase 5: fused vs composed search on batch 0")
    fused_res = dqf.search(batches[0], record=False)
    composed = copy.copy(dqf)
    composed.cfg = dataclasses.replace(cfg, fused=False)
    comp_res = composed.search(batches[0], record=False)
    pairs = [("ids", fused_res.ids, comp_res.ids),
             ("dists", fused_res.dists, comp_res.dists)]
    for f in ("dist_count", "hops", "terminated_early", "update_count"):
        pairs.append((f, getattr(fused_res.stats, f),
                      getattr(comp_res.stats, f)))
    bad = [name for name, a, b in pairs if not bits_equal(a, b)]
    if bad:
        raise SystemExit(f"fused and composed searches differ in {bad}")
    log("  fused and composed: ids, dists, dist_count, hops, "
        "terminated_early, update_count bit-identical")
    gt0 = gt[:1024]
    for name, res in (("dqf", fused_res),
                      ("dual index, no tree",
                       dqf.search_dual_beam(batches[0])),
                      ("beam search, full graph",
                       dqf.search_baseline(batches[0]))):
        log(f"  batch 0, {name}: recall@10 "
            f"{recall_at_k(res.ids.cpu().numpy(), gt0):.4f}, mean "
            f"dist_count {float(res.stats.dist_count.float().mean()):.2f}")
    return dqf, batches[0], launches, dict(
        recall=recall, qps=qps, build_s=t_build, warm_s=t_warm,
        fit_s=t_fit, search_ms=times)


# ------------------------------------------------------------------ phase 6
def _event_ms(fn, reps, before=None):
    """Mean device ms of ``fn`` over ``reps`` calls, CUDA events around
    each call; ``before`` runs untimed ahead of each."""
    total = 0.0
    out = None
    for _ in range(reps):
        if before is not None:
            before()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps, out


def phase_timing(dqf, q, launches):
    from repro_torch.core import beam_search as bs
    from repro_torch.core.dynamic_search import _seed_full_state, hot_phase
    from repro_torch.core.features import hot_features
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import fused_hop_cuda

    c = dqf.cfg
    hd = dqf.hot_tables()
    qt = dqf._queries(q)
    x_pad, adj_pad, live = (dqf._dev["x_pad"], dqf._dev["adj_pad"],
                            dqf._dev["live_pad"])
    tree = dqf.tree.arrays
    saved = fused_hop_cuda.launches

    # one search batch, phase by phase (CUDA events)
    hot_ms, (hot_pool, _) = _event_ms(lambda: hot_phase(
        hd["x_hot_pad"], hd["adj_hot_pad"], hd["hot_entries"], qt,
        pool_size=c.hot_pool, max_hops=c.max_hops), 1)
    hot = hot_features(hot_pool, c.k)
    seed = lambda: _seed_full_state(hot_pool, hd["hot_ids_pad"],
                                    x_pad.shape[0] - 1, c.full_pool, live)
    seed_ms, state = _event_ms(seed, 1)
    full_ms, _ = _event_ms(lambda: bs.fused_beam_loop(
        x_pad, adj_pad, qt, state, c.max_hops, live,
        fused_hops=c.fused_hops, tree=tree, hot=hot, k=c.k,
        eval_gap=c.eval_gap, add_step=c.add_step,
        tree_depth=c.tree_depth), 1)
    log(f"  one batch of {qt.shape[0]}: hot phase {hot_ms:.3f} ms, seed "
        f"{seed_ms:.3f} ms, fused full phase {full_ms:.3f} ms "
        f"({fused_hop_cuda.launches - saved} launches)")

    hs0 = bs.to_hop_state(seed())
    seen0 = hs0.seen.clone()
    hf, hr = hot.first.contiguous(), hot.first_div_kth.contiguous()
    kw = dict(hops=c.fused_hops, max_hops=c.max_hops, k=c.k,
              eval_gap=c.eval_gap, add_step=c.add_step,
              tree_depth=c.tree_depth)
    reset = lambda: hs0.seen.copy_(seen0)
    for _ in range(3):                                       # warm up
        reset()
        fused_hop_cuda(hs0, adj_pad, qt, live, x_pad, tree, hf, hr, **kw)
    ms, got = _event_ms(lambda: fused_hop_cuda(hs0, adj_pad, qt, live, x_pad,
                                               tree, hf, hr, **kw), 20, reset)
    fused_hop_cuda.launches = saved
    seen_kernel = hs0.seen.clone()
    reset()
    ref.fused_hop(hs0, adj_pad, qt, live, "f32", x_pad, tree, hf, hr, **kw)
    plain_ms, want = _event_ms(lambda: ref.fused_hop(
        hs0, adj_pad, qt, live, "f32", x_pad, tree, hf, hr, **kw), 5, reset)
    bad = [f for f in ref.HopState._fields if f != "seen"
           and not bits_equal(getattr(want, f), getattr(got, f))]
    if not torch.equal(hs0.seen, seen_kernel):
        bad.append("seen")
    del seen_kernel
    if bad:
        raise SystemExit(f"timed launch differs from plain version: {bad}")
    err = float((want.dists - got.dists).abs().max())

    B, L = hs0.ids.shape
    R, d = adj_pad.shape[1], x_pad.shape[1]
    rows = int((got.dist_count - hs0.dist_count).sum())
    hops = int((got.hops - hs0.hops).sum())
    state = B * L * (4 + 4 + 1) * 2 + B * 7 * 4 * 2 + B * d * 4 + B * 8
    moved = rows * d * 4 + hops * R * (4 + 1 + 1 + 1) + state
    flops = rows * d * 3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"  fused_hop at B={B} L={L} R={R} d={d} hops={c.fused_hops}: "
        f"{ms:.4f} ms/launch, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({moved} bytes, {rows} rows scored), "
        f"{bound_ms / ms:.4f} of bound")
    return {"name": "fused_hop", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_hop.cu",
            "replaces": "src/repro/kernels/fused_hop.py:313",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "bound_share": bound_ms / ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    log("phase 1: card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" ({smi})")
    log("  allow_tf32: matmul False, cudnn False")

    log("phase 2: build")
    secs = _build.build_all()
    log(f"  nvcc build {secs:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 3: fused_hop kernel vs plain version, synthetic worlds")
    n_cases, syn_err = phase_synthetic(dev)
    log(f"  {n_cases} worlds bit-identical")

    log(f"phase 4: main path n={N} d=128")
    dqf, q0, launches, _ = phase_main(dev, N, args.seed)

    log("phase 6: kernel timing at the main path's shapes")
    entry = phase_timing(dqf, q0, launches)
    entry["max_abs_err"] = max(entry["max_abs_err"], syn_err)
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
