"""Sharded index of the port: per-shard DQFs behind one merged search.

A port of ``repro/sharding``'s read path: ``ShardedDQF`` builds S shards
(or carries them from saved arrays), searches them in one stacked pass on
the device merged by the ``pool_merge`` kernel, bit-identical to a
sequential single-shard oracle.  See :mod:`repro_torch.sharding.sharded`.
"""

from .merge import merge_topk, merge_topk_host
from .sharded import ShardedDQF
from .types import ShardConfig

__all__ = ["ShardConfig", "ShardedDQF", "merge_topk", "merge_topk_host"]
