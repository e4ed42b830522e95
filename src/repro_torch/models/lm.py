"""The decoder LM of the port: serving (forward, prefill, decode).

A :class:`DecoderLM` reads an :class:`~repro_torch.configs.ArchConfig` as
the reference's ``models/lm.py`` does: ``cfg.layer_kinds`` gives each
layer's block kind, and a kind fixes the layer's RoPE theta and attention
window (:func:`_kind_attn_mode`).  It holds one :class:`Block` a layer, in
layer order; the reference's per-kind parameter stacks and ``lax.scan``
are a compile-time device of XLA and are not copied
(:func:`repro_torch.convert.lm_from_arrays` unstacks them).

The block kinds ``dense``, ``local``, ``global`` and ``moe`` are ported,
with GQA or (``cfg.mla_enabled``) MLA attention: qwen3-0.6b, yi-34b,
glm4-9b, gemma3-4b, musicgen-medium (fed embeddings), deepseek-moe-16b
and deepseek-v2-lite-16b.  A dense layer of a MoE config is
``cfg.dense_layer_ff`` wide.  The kinds ``hybrid``, ``cross``, ``mlstm``
and ``slstm`` raise ``NotImplementedError``.  Training (the loss, remat,
optimizers) is not ported; ``forward`` returns the MoE aux sums the loss
reads (``want_aux``).

The model runs on the card unless ``device="cpu"`` is given; its weights
are drawn from ``seed`` by a ``torch.Generator`` on that device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dqf import resolve_device

from . import attention as attn
from .common import (dtype_of, embed, kernel_init, rms_norm, unembed,
                     zeros)
from .mlp import init_mlp_params, mlp_forward
from .moe import init_moe_params, moe_forward

__all__ = ["DecoderLM", "Block", "layer_runs", "PORTED_KINDS"]

PORTED_KINDS = ("dense", "local", "global", "moe")


def layer_runs(cfg) -> list[tuple[str, int, int]]:
    """(kind, start_index_within_kind, length) for consecutive runs."""
    runs = []
    seen: dict[str, int] = {}
    kinds = cfg.layer_kinds
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        k = kinds[i]
        runs.append((k, seen.get(k, 0), j - i))
        seen[k] = seen.get(k, 0) + (j - i)
        i = j
    return runs


def _kind_attn_mode(cfg, kind: str) -> tuple[float, int]:
    """(rope theta, window) for a block kind."""
    if kind == "global":
        return (cfg.rope_theta_global or cfg.rope_theta, 0)
    if kind in ("local", "hybrid"):
        return (cfg.rope_theta, cfg.window_size)
    return (cfg.rope_theta, cfg.window_size if cfg.window_size
            and cfg.global_layer_every == 0 else 0)


def _attn_chunks(cfg, seq_len: int) -> tuple[int, int]:
    c = 512 if seq_len <= 4096 else 1024
    return min(c, seq_len), min(c, seq_len)


def _refuse_unported(cfg) -> None:
    other = sorted(set(cfg.layer_kinds) - set(PORTED_KINDS))
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {other} not ported yet (ROADMAP.md, "
            f"queue 1, the LLM substrate); ported kinds: "
            f"{', '.join(PORTED_KINDS)}")


def _cache_from_kv(cfg, kv, window: int, seq_len: int):
    """The ring-buffer cache of a layer from its full prefill K/V (MLA:
    the latent and rope key of every position, no window)."""
    if cfg.mla_enabled:
        c, k_rope = kv
        pos = torch.arange(seq_len, dtype=torch.int32, device=c.device)
        return attn.MLACache(c_kv=c, k_rope=k_rope, pos=pos)
    k, v = kv
    if window and seq_len >= window and seq_len % window == 0:
        # the last `window` positions land exactly on slots 0..W-1
        k, v = k[:, -window:], v[:, -window:]
        pos = torch.arange(seq_len - window, seq_len, dtype=torch.int32,
                           device=k.device)
    else:
        pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    return attn.KVCache(k=k, v=v, pos=pos)


class Block(torch.nn.Module):
    """One pre-norm decoder layer: GQA or MLA attention, then the SwiGLU
    MLP (``dense``, ``local``, ``global``) or the MoE (``moe``)."""

    def __init__(self, kind: str, cfg, gen, dtype, device):
        super().__init__()
        self.kind = kind
        self.cfg = cfg
        self.theta, self.window = _kind_attn_mode(cfg, kind)
        d = cfg.d_model
        self.ln1 = zeros((d,), dtype, device)
        self.attn = (attn.init_mla_params(gen, cfg, dtype, device)
                     if cfg.mla_enabled else
                     attn.init_gqa_params(gen, cfg, dtype, device))
        self.ln2 = zeros((d,), dtype, device)
        if kind == "moe":
            self.moe = init_moe_params(gen, cfg, dtype, device)
        else:
            ff = (cfg.dense_layer_ff
                  if cfg.moe is not None and kind == "dense" else cfg.d_ff)
            self.mlp = init_mlp_params(gen, d, ff, dtype, device)

    def _ffn(self, x):
        """The layer's second half: (x, aux (3,) = load balance, z,
        dropped; zeros for a dense layer)."""
        h = rms_norm(x, self.ln2, self.cfg.norm_eps)
        if self.kind == "moe":
            y, aux = moe_forward(self.moe, h, self.cfg)
            return x + y, torch.stack(list(aux))
        return (x + mlp_forward(self.mlp, h),
                torch.zeros(3, dtype=torch.float32, device=x.device))

    def forward(self, x, *, chunks: tuple[int, int], want_kv: bool):
        """The layer over a full sequence: (x, aux, kv), ``kv`` its K/V
        (MLA: its latent and rope key) with ``want_kv``, else None."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        kw = dict(chunk_q=chunks[0], chunk_k=chunks[1], return_kv=want_kv)
        if cfg.mla_enabled:
            a = attn.mla_forward(self.attn, h, cfg=cfg, **kw)
        else:
            a = attn.gqa_forward(self.attn, h, cfg=cfg, theta=self.theta,
                                 window=self.window, **kw)
        kv = None
        if want_kv:
            a, kv = a
        x, aux = self._ffn(x + a)
        return x, aux, kv

    def decode(self, x1, cache, pos: int):
        cfg = self.cfg
        h = rms_norm(x1, self.ln1, cfg.norm_eps)
        if cfg.mla_enabled:
            a, cache = attn.mla_decode(self.attn, h, cache, pos, cfg=cfg)
        else:
            a, cache = attn.gqa_decode(self.attn, h, cache, pos, cfg=cfg,
                                       theta=self.theta, window=self.window)
        x1, _ = self._ffn(x1 + a)
        return x1, cache


class DecoderLM(torch.nn.Module):
    """A decoder LM for serving, one :class:`Block` a layer.

    ``seed`` draws the weights (truncated normals at the reference's
    standard deviations); ``seed=None`` leaves them uninitialised for a
    caller that copies weights in.
    """

    def __init__(self, cfg, *, seed: Optional[int] = 0, device=None):
        super().__init__()
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device, what="DecoderLM")
        dev = self.device
        dtype = dtype_of(cfg)
        gen = None if seed is None else \
            torch.Generator(device=dev).manual_seed(seed)
        d, V = cfg.d_model, cfg.vocab_size
        self.final_norm = zeros((d,), dtype, dev)
        # d^-1/2 init keeps tied-head logits O(1); gemma-style activations
        # rescale by sqrt(d) at the embed lookup.
        self.embed = (kernel_init(gen, (V, d), dtype, dev, scale=d ** -0.5)
                      if cfg.embed_inputs else None)
        self.lm_head = (kernel_init(gen, (V, d), dtype, dev, scale=d ** -0.5)
                        if not cfg.tie_embeddings or not cfg.embed_inputs
                        else None)
        self.blocks = torch.nn.ModuleList(
            Block(kind, cfg, gen, dtype, dev) for kind in cfg.layer_kinds)
        self.embed_scale = d ** 0.5 if cfg.name.startswith("gemma") else 1.0

    @property
    def head(self) -> torch.Tensor:
        return self.lm_head if self.lm_head is not None else self.embed

    def _inputs(self, tokens, embeds) -> torch.Tensor:
        if embeds is not None:
            return torch.as_tensor(embeds, device=self.device).to(
                dtype_of(self.cfg))
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return embed(self.embed, tokens, self.embed_scale)

    def forward(self, tokens=None, embeds=None, *, want_caches: bool = False,
                logits_mode: str = "all", want_aux: bool = False):
        """Full-sequence forward: float32 logits ``(B, S, V)`` (``(B, 1,
        V)`` with ``logits_mode="last"``); with ``want_aux`` then the
        layers' summed MoE aux terms ``(3,)`` (load balance, z, dropped
        fraction), and with ``want_caches`` last one cache a layer
        (:class:`~repro_torch.models.attention.KVCache`, or ``MLACache``)."""
        x = self._inputs(tokens, embeds)
        S = x.shape[1]
        chunks = _attn_chunks(self.cfg, S)
        caches = []
        aux_sum = torch.zeros(3, dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x, aux, kv = blk(x, chunks=chunks, want_kv=want_caches)
            aux_sum = aux_sum + aux
            if want_caches:
                caches.append(_cache_from_kv(self.cfg, kv, blk.window, S))
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if logits_mode == "last":
            x = x[:, -1:]
        out = (unembed(x, self.head),)
        if want_aux:
            out += (aux_sum,)
        if want_caches:
            out += (caches,)
        return out if len(out) > 1 else out[0]

    def prefill(self, tokens=None, embeds=None):
        """Full forward, per-layer caches and last-position logits."""
        return self.forward(tokens, embeds, want_caches=True,
                            logits_mode="last")

    def init_decode_caches(self, batch: int, max_len: int) -> list:
        """Empty ring-buffer caches, one a layer (``MLACache`` under MLA)."""
        dtype = dtype_of(self.cfg)
        if self.cfg.mla_enabled:
            return [attn.mla_init_cache(self.cfg, batch, max_len, dtype,
                                        self.device) for _ in self.blocks]
        return [attn.gqa_init_cache(self.cfg, batch, max_len, blk.window,
                                    dtype, self.device)
                for blk in self.blocks]

    def decode_step(self, token, caches: list, pos: int):
        """One serving step: ``token`` (B, 1) ids (or (B, 1, d) embeds for
        a model fed embeddings) at absolute position ``pos``.  Returns
        (float32 logits (B, 1, V), caches), the caches updated in place."""
        if self.cfg.embed_inputs:
            x = self._inputs(token, None)
        else:
            x = self._inputs(None, token)
        for i, blk in enumerate(self.blocks):
            x, caches[i] = blk.decode(x, caches[i], pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return unembed(x, self.head), caches
