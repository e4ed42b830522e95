"""Sharded index of the port: per-shard DQFs behind one merged search.

A port of ``repro/sharding``: ``ShardedDQF`` builds S shards (or carries
them from saved arrays), searches them in one stacked pass on the device
merged by the ``pool_merge`` kernel, bit-identical to a sequential
single-shard oracle, and takes writes (insert, delete, compact with the
rebalance); ``ShardedEngine`` serves it as one continuous-batching wave
(fixed or paged) with ``ShardHealth``'s quarantine under chaos.  See
:mod:`repro_torch.sharding.sharded` and :mod:`repro_torch.sharding.engine`.
With a process group of S ranks, ``ShardConfig(use_mesh=...)`` places
the shards one a rank and merges over ``torch.distributed``.
"""

from .engine import ShardedEngine
from .health import ShardHealth
from .merge import merge_topk, merge_topk_host
from .sharded import ShardedDQF
from .types import ShardConfig

__all__ = ["ShardConfig", "ShardedDQF", "ShardedEngine", "ShardHealth",
           "merge_topk", "merge_topk_host"]
