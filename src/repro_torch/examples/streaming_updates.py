"""Search under churn: the mutable index lifecycle end to end, in PyTorch.

Builds an sq8-quantized DQF, then alternates query waves (through the
continuous-batching ``WaveEngine``) with insert/delete churn, compacts,
saves and loads, and shows that:

* recall on live points holds through the churn (no rebuild);
* tombstoned rows never appear in results;
* external ids survive compaction, so application-level handles stay valid
  while internal ids shift;
* a checkpoint of the churned index searches as the index does.

Run on the card (the default) or on the CPU::

    PYTHONPATH=src python -m repro_torch.examples.streaming_updates
    PYTHONPATH=src python -m repro_torch.examples.streaming_updates --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import (DQF, DQFConfig, QuantConfig, ZipfWorkload,
                              ground_truth, recall_at_k)
from repro_torch.serving.engine import WaveEngine


def make_data(n, d=24, clusters=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 1.5
    return (centers[rng.integers(0, clusters, n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def live_recall(dqf, queries, k):
    """Recall@k of dqf.search against exact search over *live* rows."""
    live = dqf.store.live_ids()
    gt = live[ground_truth(dqf.store.x[live], queries, k)]
    ids = dqf.search(queries, record=False).ids.cpu().numpy()
    return recall_at_k(ids, gt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=3000, help="rows at build")
    ap.add_argument("--rounds", type=int, default=3, help="churn rounds")
    args = ap.parse_args(argv)
    n, d = args.n, 24
    x = make_data(n, d)
    cfg = DQFConfig(knn_k=16, out_degree=16, index_ratio=0.02, k=10,
                    hot_pool=32, full_pool=64, max_hops=200,
                    n_query_trigger=10 ** 9,
                    quant=QuantConfig(mode="sq8", rerank_k=64))
    dqf = DQF(cfg, device=args.device)
    print(f"building over n={n} d={d} (sq8-quantized full index) on "
          f"{dqf.device}...")
    dqf.build(x)
    wl = ZipfWorkload(x, beta=1.2, sigma=0.05, seed=1)
    _, targets = wl.sample(10_000, with_targets=True)
    dqf.counter.record(targets)
    dqf.rebuild_hot()
    dqf.fit_tree(wl.sample(1000))

    queries = wl.sample(256)
    print(f"recall@10 before churn:  {live_recall(dqf, queries, cfg.k):.4f}")

    engine = WaveEngine(dqf, wave_size=32, tick_hops=8)
    rng = np.random.default_rng(7)
    tracked_ext = tracked_vec = None
    for round_ in range(args.rounds):
        # churn ~5% of the corpus (the engine re-captures its device tables
        # through the store epoch at its next tick)...
        m = n // 20
        ext_new = dqf.insert(make_data(m, d, seed=100 + round_))
        if tracked_ext is None:
            tracked_ext = int(ext_new[0])
            tracked_vec = dqf.store.x[dqf.store.to_internal(
                np.asarray([tracked_ext]))[0]].copy()
        live = dqf.store.live_ids()
        dqf.delete(dqf.store.to_external(
            rng.choice(live, size=m, replace=False)))
        # ...then serve a wave of traffic over the churned index.
        rids = engine.submit(wl.sample(64))
        out = engine.run_until_drained()
        leaked = 0
        for rid in rids:
            ids = out["results"][rid]["ids"]
            ids = ids[(ids >= 0) & (ids < dqf.store.n)]
            leaked += int((~dqf.store.alive[ids]).sum())
        print(f"round {round_}: +{m}/-{m} rows, "
              f"live={dqf.store.live_count}, "
              f"capacity={dqf.store.capacity}, "
              f"recall={live_recall(dqf, queries, cfg.k):.4f}, "
              f"p99={out['p99_ms']:.1f}ms, dead-in-results={leaked}")

    dropped = dqf.compact()["dropped"]
    print(f"compacted: dropped {dropped} tombstones, n={dqf.store.n}")
    print(f"recall@10 after compact: {live_recall(dqf, queries, cfg.k):.4f}")

    # the external handle minted in round 0 still resolves to the same row
    back = dqf.store.to_internal(np.asarray([tracked_ext]))[0]
    if not np.array_equal(dqf.store.x[back], tracked_vec):
        raise SystemExit(f"external id {tracked_ext} lost its row")
    print(f"external id {tracked_ext} still resolves (internal id {back}) "
          "after compaction — handles survive")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "churned.npz")
        dqf.save(path)
        loaded = DQF.load(path, cfg, device=dqf.device)
    a = dqf.search(queries, record=False)
    b = loaded.search(queries, record=False)
    same = torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    print(f"saved and loaded: searches {'identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit("the loaded checkpoint searches differently")


if __name__ == "__main__":
    main()
