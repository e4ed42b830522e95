"""Quickstart: build a DQF index, fit the termination tree, search.

Reproduces the paper's core claim at laptop scale: under a Zipf workload
the dual-index + decision-tree search answers with ~the same recall as the
NSSG baseline at a fraction of the distance computations.

Run on the card (the default) or on the CPU::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (DQF, DQFConfig, ZipfWorkload, ground_truth,
                              recall_at_k)


def make_data(n, d, clusters=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 1.5
    return centers[rng.integers(0, clusters, n)] \
        + rng.standard_normal((n, d)).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=6000,
                    help="rows; the tree's history is n/5 queries")
    ap.add_argument("--queries", type=int, default=512)
    args = ap.parse_args(argv)
    n, d = args.n, 32
    x = make_data(n, d)

    cfg = DQFConfig(knn_k=24, out_degree=24, index_ratio=0.005, k=10,
                    hot_pool=32, full_pool=64, eval_gap=50, max_hops=400)
    dqf = DQF(cfg, device=args.device)
    print(f"== building DQF over n={n}, d={d} on {dqf.device} ==")
    t0 = time.time()
    dqf.build(x)
    print(f"full NSSG built in {time.time() - t0:.1f}s")

    # Zipf(1.2) history stream → counters → hot index (Algorithm 2)
    wl = ZipfWorkload(x, beta=1.2, sigma=0.05, seed=1)
    _, targets = wl.sample(20_000, with_targets=True)
    dqf.counter.record(targets)
    hot = dqf.rebuild_hot()
    print(f"hot index: {hot.size} nodes, built in {hot.build_seconds:.3f}s "
          f"({dqf.timings.full_build / hot.build_seconds:.0f}x faster than "
          f"the full build)")

    print("== fitting the termination decision tree ==")
    tree = dqf.fit_tree(wl.sample(n // 5))
    for name, share in zip(
            ("hotIdx_1st", "hotIdx_1st/kth", "fullIdx_1st", "fullIdx_1st/kth",
             "dist_count", "update_count"), tree.feature_importance):
        print(f"   {name:18s} {share:5.1%}")

    queries = wl.sample(args.queries)
    gt = ground_truth(x, queries, cfg.k)
    r_base = dqf.search_baseline(queries)
    r_dqf = dqf.search(queries, record=False)
    dc_base = float(r_base.stats.dist_count.float().mean())
    dc_dqf = float(r_dqf.stats.dist_count.float().mean())
    rec_base = recall_at_k(r_base.ids.cpu().numpy(), gt)
    rec_dqf = recall_at_k(r_dqf.ids.cpu().numpy(), gt)
    early = float(r_dqf.stats.terminated_early.float().mean())
    print(f"== results ({len(queries)} Zipf queries) ==")
    print(f"  NSSG baseline : recall@10={rec_base:.3f} "
          f"dist_comps={dc_base:.0f}")
    print(f"  DQF (tree)    : recall@10={rec_dqf:.3f} "
          f"dist_comps={dc_dqf:.0f}  "
          f"({dc_base / dc_dqf:.2f}x fewer distance computations)")
    print(f"  early-terminated lanes: {early:.1%}")
    return dict(recall_baseline=rec_base, recall_dqf=rec_dqf,
                dist_baseline=dc_base, dist_dqf=dc_dqf, early=early)


if __name__ == "__main__":
    main()
