"""Query-distribution drift: rebuild ONLY the hot index (paper claim #3).

Simulates a trend change (full re-ranking of popularity), shows the stale
hot index losing its advantage, then restores it with a sub-second hot
rebuild; the full NSSG is never touched (PANNS would rebuild everything).

Run on the card (the default) or on the CPU::

    PYTHONPATH=src python -m repro_torch.examples.drift_adaptation
    PYTHONPATH=src python -m repro_torch.examples.drift_adaptation --device cpu
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core import (DQF, DQFConfig, ZipfWorkload, ground_truth,
                              recall_at_k)
from repro_torch.examples.quickstart import make_data


def measure(dqf, wl, label, n_queries):
    q = wl.sample(n_queries)
    gt = ground_truth(dqf.x, q, dqf.cfg.k)
    res = dqf.search(q, record=False)
    dc = float(res.stats.dist_count.float().mean())
    early = float(res.stats.terminated_early.float().mean())
    print(f"  {label:28s} "
          f"recall={recall_at_k(res.ids.cpu().numpy(), gt):.3f} "
          f"dist_comps={dc:6.0f} early_term={early:.1%}")
    return dc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=6000,
                    help="rows; the tree's history is n/5 queries")
    ap.add_argument("--queries", type=int, default=384)
    args = ap.parse_args(argv)
    x = make_data(args.n, 32)

    dqf = DQF(DQFConfig(knn_k=24, out_degree=24, index_ratio=0.005,
                        hot_pool=32, full_pool=64, max_hops=400),
              device=args.device).build(x)
    wl = ZipfWorkload(x, beta=1.2, sigma=0.05, seed=1)
    _, t = wl.sample(20_000, with_targets=True)
    dqf.counter.record(t)
    dqf.rebuild_hot()
    dqf.fit_tree(wl.sample(args.n // 5))

    print(f"== before drift ({dqf.device}) ==")
    dc0 = measure(dqf, wl, "fresh hot index", args.queries)

    print("== trend change: popularity fully re-ranked ==")
    wl.drift(1.0)
    dc_stale = measure(dqf, wl, "stale hot index", args.queries)

    print("== adapt: hot-only rebuild from new counters ==")
    dqf.counter.counts[:] = 0
    _, t2 = wl.sample(20_000, with_targets=True)
    dqf.counter.record(t2)
    t0 = time.time()
    dqf.rebuild_hot()
    rebuild = time.time() - t0
    print(f"  hot rebuild took {rebuild:.3f}s "
          f"(full build was {dqf.timings.full_build:.1f}s — "
          f"{dqf.timings.full_build / rebuild:.0f}x)")
    dc1 = measure(dqf, wl, "rebuilt hot index", args.queries)
    print(f"\nwork overhead while stale: {dc_stale / dc0 - 1:+.1%}; "
          f"after rebuild: {dc1 / dc0 - 1:+.1%}")
    return dict(fresh=dc0, stale=dc_stale, rebuilt=dc1)


if __name__ == "__main__":
    main()
