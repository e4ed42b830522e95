"""Configuration of the sharded index (``repro/sharding/types.py``)."""

from __future__ import annotations

import dataclasses

__all__ = ["ShardConfig"]


@dataclasses.dataclass
class ShardConfig:
    """How a :class:`~repro_torch.sharding.ShardedDQF` splits and serves rows.

    ``num_shards`` per-shard VectorStores are built from a density-balancing
    permutation of the input rows (identity at ``num_shards == 1``, so the
    single-shard deployment is bit-identical to a plain :class:`DQF`).

    ``use_mesh`` is where the stacked per-shard tables live.  ``"auto"``
    places the shards one a rank over the first S ranks of the process
    group when it has at least S ranks, and otherwise keeps them on the
    DQF's device as a batch axis of one search; ``True`` requires a group
    of at least S ranks (``RuntimeError`` otherwise, as the reference with
    too few devices); ``False`` keeps them on one device; a
    :class:`~repro_torch.distributed.mesh.Mesh` with an ``axis`` of S
    ranks is the placement itself, at any S (one included, where the
    reference never places: a world of one rank reaches the placed path
    only so).

    Rebalancing (``rebalance*``) runs at the end of
    :meth:`~repro_torch.sharding.ShardedDQF.compact`: when the hottest
    shard's preference mass exceeds ``rebalance_imbalance`` times the
    coldest's, up to ``rebalance_max_rows`` of its most-hit rows move there.
    """

    num_shards: int = 1
    seed: int = 0                    # partition permutation seed
    axis: str = "shard"              # mesh axis name
    use_mesh: object = "auto"        # "auto" | True | False | a Mesh
    rebalance: bool = True
    rebalance_imbalance: float = 2.0
    rebalance_max_rows: int = 64

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if self.rebalance_imbalance <= 1.0:
            raise ValueError("rebalance_imbalance must be > 1")
