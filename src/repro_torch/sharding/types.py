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
    and ``False`` keep them on the DQF's device: the shards are a batch
    axis of one search.  ``True`` asks for one card a shard; placement
    across cards is not ported, so it raises ``RuntimeError`` with fewer
    CUDA devices than shards (as the reference does with too few devices)
    and ``NotImplementedError`` otherwise.

    ``use_mesh=True`` waits for a slice of the port that runs on more than
    one card; the reference's legacy segment index runs on one card
    (:mod:`repro_torch.serving.sharded`).

    Rebalancing (``rebalance*``) runs at the end of
    :meth:`~repro_torch.sharding.ShardedDQF.compact`: when the hottest
    shard's preference mass exceeds ``rebalance_imbalance`` times the
    coldest's, up to ``rebalance_max_rows`` of its most-hit rows move there.
    """

    num_shards: int = 1
    seed: int = 0                    # partition permutation seed
    axis: str = "shard"              # mesh axis name
    use_mesh: object = "auto"        # "auto" | True | False
    rebalance: bool = True
    rebalance_imbalance: float = 2.0
    rebalance_max_rows: int = 64

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if self.rebalance_imbalance <= 1.0:
            raise ValueError("rebalance_imbalance must be > 1")
