"""The four assigned input shapes + per-arch applicability (DESIGN.md §4)."""

from __future__ import annotations

import dataclasses

from .base import ArchConfig

__all__ = ["ShapeSpec", "SHAPES", "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeSpec]:
    """long_500k only for sub-quadratic archs (skip documented in DESIGN)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.is_subquadratic:
        out.append(SHAPES["long_500k"])
    return out
