"""Architecture configuration schema + registry (a copy of the reference's).

One :class:`ArchConfig` per assigned architecture lives in
``src/repro_torch/configs/<id>.py`` with the exact public numbers; reduced
variants for CPU smoke tests come from :meth:`ArchConfig.reduced`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "get_config",
           "ARCH_IDS", "list_configs"]

ARCH_IDS = (
    "deepseek-moe-16b",
    "deepseek-v2-lite-16b",
    "musicgen-medium",
    "yi-34b",
    "gemma3-4b",
    "glm4-9b",
    "qwen3-0.6b",
    "hymba-1.5b",
    "llama-3.2-vision-11b",
    "xlstm-1.3b",
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    experts_per_token: int      # top-k
    num_shared: int = 0         # always-on shared experts
    d_expert: int = 0           # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # beyond-paper distributed trick (EXPERIMENTS §Perf cell C): move the
    # dispatch/combine buffers over the EP all-to-all in int8 with per-row
    # scales (2x traffic cut); dequantized on arrival.
    quantize_dispatch: bool = False
    # DeepSeek-V2's device-limited routing: restrict each token's top-k to
    # experts from its best `route_groups` expert groups (groups = EP
    # shards), bounding the all-to-all span.  0 = unrestricted.
    route_groups: int = 0
    num_groups: int = 0          # 0 → num_experts // 8 (one group per shard)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0        # 0 → no query compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16         # N (ssm_state)
    conv_width: int = 4
    expand: int = 2             # inner dim = expand * d_model (mamba-style)
    dt_rank: int = 0            # 0 → ceil(d_model / 16)
    chunk: int = 256            # SSD chunk length (perf knob, §Perf bonus 2:
                                # intra-chunk score flops scale with S*chunk)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                       # dense FFN hidden (0 for xlstm)
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads
    # attention flavor
    attention: str = "gqa"          # gqa | mla
    qk_norm: bool = False
    window_size: int = 0            # 0 = full attention
    global_layer_every: int = 0     # N>0: every Nth layer full-attn (gemma3)
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # separate theta for global layers
    # mixture of experts
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0          # leading dense layers (deepseek)
    dense_layer_ff: int = 0         # FFN dim of those dense layers
    # state space / hybrid / xlstm
    ssm: Optional[SSMConfig] = None
    xlstm_slstm_every: int = 0      # N>0: every Nth block is sLSTM
    # multimodal
    cross_attn_every: int = 0       # N>0: every Nth layer cross-attends
    vision_tokens: int = 0          # stub frontend sequence length
    embed_inputs: bool = True       # False: input_specs provides embeddings
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_seq_len: int = 131_072
    source: str = ""                # provenance note ([arXiv/hf; tier])

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, the source of truth for the layer schedule."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                s = self.xlstm_slstm_every
                kinds.append("slstm" if s and (i + 1) % s == 0 else "mlstm")
            elif self.family == "hybrid":
                kinds.append("hybrid")
            elif self.cross_attn_every and (i + 1) % self.cross_attn_every == 0:
                kinds.append("cross")
            elif self.moe is not None and i >= self.first_k_dense:
                kinds.append("moe")
            elif self.global_layer_every:
                g = (i + 1) % self.global_layer_every == 0
                kinds.append("global" if g else "local")
            else:
                kinds.append("dense")
        return tuple(kinds)

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid decode state)."""
        return self.family in ("ssm", "hybrid")

    def active_params(self) -> int:
        """Approximate active parameter count (MoE counts top-k only)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> int:
        return _param_count(self, active_only=False)

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        changes = dict(
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            dense_layer_ff=0 if self.dense_layer_ff == 0 else 256,
            vocab_size=512,
            window_size=min(self.window_size, 64) if self.window_size else 0,
            vision_tokens=min(self.vision_tokens, 16)
            if self.vision_tokens else 0,
            max_seq_len=2048,
            dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=8,
                experts_per_token=min(2, self.moe.experts_per_token),
                d_expert=64)
            changes["first_k_dense"] = min(self.first_k_dense, 1)
        if self.mla_enabled:
            changes["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=32,
                                       qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(self.ssm, state_dim=8)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)

    # MLA is stored on a separate field to keep `attention` a simple string.
    mla: Optional[MLAConfig] = None

    @property
    def mla_enabled(self) -> bool:
        return self.attention == "mla"

    def __post_init__(self):
        if self.attention == "mla" and self.mla is None:
            object.__setattr__(self, "mla", MLAConfig())
        if self.family not in ("dense", "moe", "hybrid", "ssm", "vlm",
                               "audio"):
            raise ValueError(f"unknown family {self.family}")


def _param_count(cfg: ArchConfig, active_only: bool) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    for kind in cfg.layer_kinds:
        p = 2 * d  # norms
        if kind in ("dense", "local", "global", "cross", "moe", "hybrid"):
            if cfg.mla_enabled:
                m = cfg.mla
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * n_q * (m.qk_nope_head_dim
                                             + m.v_head_dim)
                p += d * n_q * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                p += n_q * m.v_head_dim * d
            else:
                p += d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
        if kind == "moe":
            e = cfg.moe
            k = e.experts_per_token if active_only else e.num_experts
            p += 3 * d * e.d_expert * (k + e.num_shared)
            p += d * e.num_experts  # router
        elif kind == "hybrid":
            s = cfg.ssm
            inner = s.expand * d
            p += d * inner * 2 + inner * d  # in/out proj
            p += inner * (s.state_dim * 2 + 1)
            p += 3 * d * cfg.d_ff
        elif kind == "mlstm":
            inner = 2 * d
            p += d * inner * 4 + inner * d
        elif kind == "slstm":
            p += d * d * 4 + d * d  # 4 gates + proj (block-diag approximated)
        elif kind in ("dense", "local", "global", "cross"):
            ff = cfg.dense_layer_ff if (cfg.moe is not None
                                        and kind == "dense") else cfg.d_ff
            p += 3 * d * ff
        total += p
    return total


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def list_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
