"""Deterministic, resumable, host-sharded LM data pipeline (numpy only).

The port's own copy of the reference's ``data/pipeline.py``: the same
classes and the same draws, so a batch is the reference's bit for bit.

Production behavior without external deps:

* a :class:`TokenSource` yields fixed-length token windows — either
  synthetic (seeded Markov-ish stream: cheap, deterministic, non-trivial
  statistics so loss curves move) or from a memory-mapped ``.bin`` token
  file (the `prepare_tokens` helper writes one);
* every batch is addressed by ``(step, host_id)`` — *stateless* indexing,
  so restoring from a checkpoint only needs the step counter (the
  fault-tolerance contract: no data replays/skips after restart);
* per-host sharding: host h of H draws rows h::H of the global batch, the
  layout a multi-host data-parallel job feeds its local devices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["DataConfig", "TokenSource", "SyntheticSource", "FileSource",
           "make_source", "prepare_tokens"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "synthetic"          # synthetic | file
    path: Optional[str] = None
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


class TokenSource:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide among hosts")
        self.local_batch = cfg.global_batch // cfg.num_hosts

    def batch(self, step: int) -> dict:
        """Stateless: {tokens, labels} (local_batch, seq_len) int32."""
        rows = [self._row(step, self.cfg.host_id + i * self.cfg.num_hosts)
                for i in range(self.local_batch)]
        tokens = np.stack(rows)
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "labels": tokens[:, 1:].astype(np.int32)}

    def _row(self, step: int, row: int) -> np.ndarray:
        raise NotImplementedError


class SyntheticSource(TokenSource):
    """Seeded per-(step,row) stream with local structure (learnable)."""

    def _row(self, step: int, row: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, row]))
        n = c.seq_len + 1
        # piecewise-linear token walks: next ≈ prev + small step (mod V),
        # so a model can beat uniform loss quickly.
        start = rng.integers(0, c.vocab_size)
        steps = rng.integers(-3, 4, size=n)
        jumps = rng.random(n) < 0.05
        steps = np.where(jumps, rng.integers(0, c.vocab_size, n), steps)
        out = (start + np.cumsum(steps)) % c.vocab_size
        return out.astype(np.int32)


class FileSource(TokenSource):
    """Memory-mapped flat int32 token file, wrap-around windows."""

    def __init__(self, cfg: DataConfig):
        super().__init__(cfg)
        if not cfg.path:
            raise ValueError("FileSource needs cfg.path")
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        if self.data.size < cfg.seq_len + 1:
            raise ValueError("token file smaller than one window")

    def _row(self, step: int, row: int) -> np.ndarray:
        c = self.cfg
        n = c.seq_len + 1
        stride = max(1, (self.data.size - n) // max(c.global_batch, 1))
        off = ((step * c.global_batch + row) * stride) % (self.data.size - n)
        return np.asarray(self.data[off: off + n])


def make_source(cfg: DataConfig) -> TokenSource:
    return {"synthetic": SyntheticSource,
            "file": FileSource}[cfg.kind](cfg)


def prepare_tokens(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(path)
