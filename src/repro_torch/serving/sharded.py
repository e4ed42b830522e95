"""The degraded cross-shard merge of ``repro/serving/sharded.py``.

Only :func:`merge_with_dropout` is ported here: ``ShardedDQF.
search_degraded`` merges over the shards that responded with it.  The
frozen segment index of that module (``ShardedIndex``,
``build_sharded_index``, ``sharded_search``) needs a two-axis mesh and is
not ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["merge_with_dropout"]


def merge_with_dropout(per_shard_ids: list, per_shard_dists: list,
                       alive: list, k: int, *, registry=None):
    """Host-side degraded merge: skip shards flagged dead (stragglers that
    timed out / failed hosts).  Returns (ids, dists, coverage).

    With a :class:`repro_torch.obs.MetricsRegistry`, every degraded merge
    is visible in ``scrape()``/``exposition()``: responding shards count
    into ``shard_responses_total{shard=i}`` and each dead shard into
    ``shard_dropout_total``.
    """
    if registry is not None:
        resp = registry.counter(
            "shard_responses_total",
            "per-shard responses folded into degraded merges")
        for s, a in enumerate(alive):
            if a:
                resp.inc(1.0, shard=s)
        dead = len(alive) - sum(bool(a) for a in alive)
        if dead:
            registry.counter(
                "shard_dropout_total",
                "shards dropped from degraded merges").inc(float(dead))
    ids = [i for i, a in zip(per_shard_ids, alive) if a]
    ds = [d for d, a in zip(per_shard_dists, alive) if a]
    if not ids:
        raise RuntimeError("all shards lost")
    cat_i = np.concatenate(ids, axis=1)
    cat_d = np.concatenate(ds, axis=1)
    order = np.argsort(cat_d, axis=1)[:, :k]
    return (np.take_along_axis(cat_i, order, 1),
            np.take_along_axis(cat_d, order, 1),
            sum(alive) / len(alive))
