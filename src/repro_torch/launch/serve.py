"""Serving launcher: DQF vector search behind the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --n 6000 --requests 512
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 1500

Builds (or loads via --index) a DQF index on the card (``--device``
picks another device), fits the termination tree from a historical
stream, then serves a Zipf request stream through the port's
``WaveEngine``, printing QPS / p99 / recall.  ``--drift`` injects a
popularity drift mid-stream and adapts with a hot-only rebuild (the
paper's claim 3, end to end).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=6000,
                    help="rows; the tree's history is n/6 queries")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--wave", type=int, default=64)
    ap.add_argument("--index", default="", help="load a saved .npz index")
    ap.add_argument("--save-index", default="")
    ap.add_argument("--drift", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.core import (DQF, DQFConfig, ZipfWorkload,
                                  ground_truth, recall_at_k)
    from repro_torch.serving.engine import WaveEngine

    cfg = DQFConfig(knn_k=24, out_degree=24, index_ratio=0.005, k=10,
                    hot_pool=32, full_pool=64, max_hops=400)
    if args.index:
        dqf = DQF.load(args.index, cfg, device=args.device)
        x = dqf.x
        print(f"[serve] loaded index over n={x.shape[0]} on {dqf.device}")
        wl = ZipfWorkload(x, beta=1.2, sigma=0.05, seed=1)
    else:
        rng = np.random.default_rng(0)
        centers = rng.standard_normal(
            (24, args.dim)).astype(np.float32) * 1.5
        x = centers[rng.integers(0, 24, args.n)] \
            + rng.standard_normal((args.n, args.dim)).astype(np.float32)
        t0 = time.time()
        dqf = DQF(cfg, device=args.device).build(x)
        print(f"[serve] built full index on {dqf.device} in "
              f"{time.time() - t0:.1f}s")
        wl = ZipfWorkload(x, beta=1.2, sigma=0.05, seed=1)
        _, t = wl.sample(20_000, with_targets=True)
        dqf.counter.record(t)
        dqf.rebuild_hot()
        dqf.fit_tree(wl.sample(args.n // 6))
        if args.save_index:
            dqf.save(args.save_index)

    def serve_batch(queries, label):
        eng = WaveEngine(dqf, wave_size=args.wave)
        eng.submit(queries)
        out = eng.run_until_drained()
        ids = np.stack([out["results"][i]["ids"]
                        for i in range(len(queries))])
        gt = ground_truth(x, queries, cfg.k)
        recall = recall_at_k(ids, gt)
        print(f"[serve] {label}: qps={out['qps']:.0f} "
              f"p99={out['p99_ms']:.1f}ms recall@10={recall:.3f} "
              f"straggled={out['straggled']}")
        return recall

    recalls = {"steady": serve_batch(wl.sample(args.requests),
                                     "steady state")}
    if args.drift:
        wl.drift(1.0)
        recalls["stale"] = serve_batch(wl.sample(args.requests),
                                       "post-drift (stale hot)")
        dqf.counter.counts[:] = 0
        _, t = wl.sample(20_000, with_targets=True)
        dqf.counter.record(t)
        t0 = time.time()
        dqf.rebuild_hot()
        print(f"[serve] hot rebuild: {time.time() - t0:.3f}s")
        recalls["rebuilt"] = serve_batch(wl.sample(args.requests),
                                         "post-drift (rebuilt hot)")
    return recalls


if __name__ == "__main__":
    main()
