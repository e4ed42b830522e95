"""The decoder LM of the port: serving (forward, prefill, decode) and the
training loss (:func:`lm_loss`, with per-block remat).

A :class:`DecoderLM` reads an :class:`~repro_torch.configs.ArchConfig` as
the reference's ``models/lm.py`` does: ``cfg.layer_kinds`` gives each
layer's block kind, and a kind fixes the layer's RoPE theta and attention
window (:func:`_kind_attn_mode`).  It holds one :class:`Block` a layer, in
layer order; the reference's per-kind parameter stacks and ``lax.scan``
are a compile-time device of XLA and are not copied
(:func:`repro_torch.convert.lm_from_arrays` unstacks them).

Every block kind is ported: ``dense``, ``local``, ``global`` and ``moe``
over GQA or (``cfg.mla_enabled``) MLA attention; ``hybrid``, 0.5 ·
(windowed GQA + a Mamba branch, :mod:`~repro_torch.models.ssm`);
``cross``, gated cross-attention to ``media`` tokens; and xLSTM's
``mlstm`` and ``slstm`` (:mod:`~repro_torch.models.xlstm`), which carry
no MLP.  So every config of :mod:`repro_torch.configs` is served.  A
dense layer of a MoE config is ``cfg.dense_layer_ff`` wide.

Training reads :func:`lm_loss`: the token NLL
(:func:`~repro_torch.models.common.softmax_cross_entropy`) plus the
weighted MoE aux terms, through ``forward(..., remat=True)``, which runs
each block under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of a block): a block keeps its input and recomputes its
activations in the backward pass.  Serving's parameters are frozen
(``requires_grad=False``);
:func:`repro_torch.training.train_step.train_state_init` makes them
trainable.

As the reference's, an xLSTM layer's prefill returns no cache (its
``_block_forward`` returns None for them): an xLSTM sequence is decoded
from :meth:`DecoderLM.init_decode_caches`, one token a step.

Tensor parallelism: :func:`repro_torch.distributed.tensor_parallel.
shard_lm` cuts a model's parameters into this rank's blocks over a mesh's
model axis and wires every layer (GQA, MLA and cross-attention by whole
heads, the MLP and the shared experts column- then row-parallel, the
routed experts a block of them a rank, the Mamba branch by channels and
the xLSTM blocks by heads) and its vocabulary tables (rows);
``forward``, ``prefill``, ``init_decode_caches``, ``decode_step`` and
:func:`lm_loss` then run the split, and take that mesh (``mesh=``, which
must be the one the model was sharded over).  ``forward`` and
``decode_step`` return the logits gathered along the vocabulary;
:func:`lm_loss` keeps each rank's slice and reduces its cross-entropy
over the model group.

The model runs on the card unless ``device="cpu"`` is given; its weights
are drawn from ``seed`` by a ``torch.Generator`` on that device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.dqf import resolve_device

from . import attention as attn
from . import ssm
from . import xlstm as xl
from .common import (dtype_of, embed, kernel_init, rms_norm,
                     softmax_cross_entropy, unembed, zeros)
from .mlp import init_mlp_params, mlp_forward
from .moe import init_moe_params, moe_forward

__all__ = ["DecoderLM", "Block", "layer_runs", "lm_loss"]

XLSTM_KINDS = ("mlstm", "slstm")


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
    """One pre-norm decoder layer: a mixer, then (but in an xLSTM layer)
    the SwiGLU MLP or the MoE.  The mixer is GQA or MLA attention
    (``dense``, ``local``, ``global``, ``moe``), 0.5 · (GQA + Mamba)
    (``hybrid``), cross-attention (``cross``), or an xLSTM block."""

    def __init__(self, kind: str, cfg, gen, dtype, device):
        super().__init__()
        self.kind = kind
        self.cfg = cfg
        self.theta, self.window = _kind_attn_mode(cfg, kind)
        # tensor parallelism (``shard_lm``): (TensorParallel, HeadSplit)
        # for the attention, the TensorParallel for the Mamba branch or
        # the xLSTM block (``tp_mix``) and for the MLP, the MoE (expert
        # parallelism) or sLSTM's MLP (``tp_ffn``); None = whole
        self.tp_attn = None
        self.tp_mix = None
        self.tp_ffn = None
        d = cfg.d_model
        self.ln1 = zeros((d,), dtype, device)
        if kind == "mlstm":
            self.mix = xl.init_mlstm_params(gen, cfg, dtype, device)
        elif kind == "slstm":
            self.mix = xl.init_slstm_params(gen, cfg, dtype, device)
        elif kind == "cross":
            self.attn = attn.init_cross_params(gen, cfg, dtype, device)
        else:
            self.attn = (attn.init_mla_params(gen, cfg, dtype, device)
                         if cfg.mla_enabled else
                         attn.init_gqa_params(gen, cfg, dtype, device))
        if kind == "hybrid":
            self.ssm = ssm.init_mamba_params(gen, cfg, dtype, device)
        if kind in XLSTM_KINDS:
            return
        self.ln2 = zeros((d,), dtype, device)
        if kind == "moe":
            self.moe = init_moe_params(gen, cfg, dtype, device)
        else:
            ff = (cfg.dense_layer_ff
                  if cfg.moe is not None and kind == "dense" else cfg.d_ff)
            self.mlp = init_mlp_params(gen, d, ff, dtype, device)

    def _shared_copy(self) -> bool:
        """Whether a hybrid layer's two branches read one
        ``copy_to_model`` of their input in training: both split, the
        attention's kv heads too (replicated kv heads read the input
        uncopied).  One copy sums the input's gradient once, in the plain
        layer's order at one rank."""
        return (self.kind == "hybrid" and self.tp_mix is not None
                and self.tp_attn is not None and self.tp_attn[1].kv_split)

    def _ffn(self, x, data_group=None):
        """The layer's second half: (x, aux (3,) = load balance, z,
        dropped; zeros but for a MoE layer, whose statistics are over
        ``data_group``'s whole batch, :func:`~repro_torch.models.moe.
        moe_forward`)."""
        zero = torch.zeros(3, dtype=torch.float32, device=x.device)
        if self.kind in XLSTM_KINDS:
            return x, zero
        h = rms_norm(x, self.ln2, self.cfg.norm_eps)
        if self.kind == "moe":
            y, aux = moe_forward(self.moe, h, self.cfg, group=data_group,
                                 tp=self.tp_ffn)
            return x + y, torch.stack(list(aux))
        return x + mlp_forward(self.mlp, h, tp=self.tp_ffn), zero

    def forward(self, x, *, chunks: tuple[int, int], want_cache: bool,
                media=None, data_group=None):
        """The layer over a full sequence: (x, aux, cache), the cache a
        decode continues from with ``want_cache`` (a ``KVCache`` or
        ``MLACache``; hybrid: (``KVCache``, ``SSMCache``); cross: the
        media's (k, v)), else None; an xLSTM layer's is always None."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        cache = None
        if self.kind == "mlstm":
            x = x + xl.mlstm_forward(self.mix, h, cfg=cfg, tp=self.tp_mix)
        elif self.kind == "slstm":
            x = x + xl.slstm_forward(self.mix, h, cfg=cfg, tp=self.tp_mix,
                                     tp_ff=self.tp_ffn)
        elif self.kind == "cross":
            if media is None:
                raise ValueError(f"{cfg.name}: a cross layer needs media")
            x = x + attn.cross_forward(self.attn, h, media, cfg=cfg,
                                       chunk_q=chunks[0], tp=self.tp_attn)
            if want_cache:
                cache = attn._cross_kv(self.attn, media, cfg, self.tp_attn)
        else:
            copied = self._shared_copy()
            if copied:
                h = self.tp_mix.copy(h)
            kw = dict(chunk_q=chunks[0], chunk_k=chunks[1],
                      return_kv=want_cache, tp=self.tp_attn)
            if cfg.mla_enabled:
                a = attn.mla_forward(self.attn, h, cfg=cfg, **kw)
            else:
                a = attn.gqa_forward(self.attn, h, cfg=cfg,
                                     theta=self.theta, window=self.window,
                                     copied=copied, **kw)
            if want_cache:
                a, kv = a
                cache = _cache_from_kv(cfg, kv, self.window, x.shape[1])
            if self.kind == "hybrid":
                s = ssm.mamba_forward(self.ssm, h, cfg=cfg,
                                      return_state=want_cache,
                                      tp=self.tp_mix, copied=copied)
                if want_cache:
                    s, ssm_cache = s
                    cache = (cache, ssm_cache)
                a = 0.5 * (a + s)
            x = x + a
        x, aux = self._ffn(x, data_group)
        return x, aux, cache

    def init_cache(self, batch: int, max_len: int, flash_mesh=None):
        """The layer's empty decode cache (a cross layer's: zero media
        K/V of ``cfg.vision_tokens``, as the reference's); with
        ``flash_mesh`` a GQA ring holds this rank's slots only
        (:func:`~repro_torch.models.attention.flash_cache_shard`), under
        tensor parallelism a GQA or cross cache this rank's kv heads (an
        MLA cache stays whole), an SSM cache this rank's channels and
        sub-heads, an xLSTM cache this rank's heads."""
        cfg, dev = self.cfg, self.ln1.device
        dtype = dtype_of(cfg)
        if self.kind == "mlstm":
            return xl.mlstm_init_cache(cfg, batch, dev, self.tp_mix)
        if self.kind == "slstm":
            return xl.slstm_init_cache(cfg, batch, dev, self.tp_mix)
        kv_heads = (self.tp_attn[1].hkv if self.tp_attn is not None
                    else None)
        if self.kind == "cross":
            shape = (batch, cfg.vision_tokens, kv_heads or cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            return tuple(torch.zeros(shape, dtype=dtype, device=dev)
                         for _ in range(2))
        if cfg.mla_enabled:
            return attn.mla_init_cache(cfg, batch, max_len, dtype, dev)
        kv = attn.gqa_init_cache(cfg, batch, max_len, self.window, dtype,
                                 dev, kv_heads)
        if flash_mesh is not None:
            kv = attn.flash_cache_shard(kv, flash_mesh)
        if self.kind == "hybrid":
            return kv, ssm.mamba_init_cache(cfg, batch, dtype, dev,
                                            self.tp_mix)
        return kv

    def decode(self, x1, cache, pos: int, flash_mesh=None):
        """One decode step; ``flash_mesh`` reaches the GQA kinds (dense,
        local, global, moe and hybrid), as the reference's
        ``_block_decode``."""
        cfg = self.cfg
        h = rms_norm(x1, self.ln1, cfg.norm_eps)
        if self.kind == "mlstm":
            a, cache = xl.mlstm_decode(self.mix, h, cache, cfg=cfg,
                                       tp=self.tp_mix)
        elif self.kind == "slstm":
            a, cache = xl.slstm_decode(self.mix, h, cache, cfg=cfg,
                                       tp=self.tp_mix, tp_ff=self.tp_ffn)
        elif self.kind == "cross":
            a = attn.cross_decode(self.attn, h, *cache, cfg=cfg,
                                  tp=self.tp_attn)
        elif self.kind == "hybrid":
            kv, ssm_cache = cache
            a, kv = attn.gqa_decode(self.attn, h, kv, pos, cfg=cfg,
                                    theta=self.theta, window=self.window,
                                    flash_mesh=flash_mesh, tp=self.tp_attn)
            s, ssm_cache = ssm.mamba_decode(self.ssm, h, ssm_cache, cfg=cfg,
                                            tp=self.tp_mix)
            a = 0.5 * (a + s)
            cache = (kv, ssm_cache)
        elif cfg.mla_enabled:
            a, cache = attn.mla_decode(self.attn, h, cache, pos, cfg=cfg,
                                       tp=self.tp_attn)
        else:
            a, cache = attn.gqa_decode(self.attn, h, cache, pos, cfg=cfg,
                                       theta=self.theta, window=self.window,
                                       flash_mesh=flash_mesh,
                                       tp=self.tp_attn)
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
        self.tp = None          # TensorParallel once shard_lm has run

    @property
    def head(self) -> torch.Tensor:
        return self.lm_head if self.lm_head is not None else self.embed

    def _vocab_tp(self):
        """The TensorParallel when the vocabulary tables are split."""
        return self.tp if self.tp is not None and self.tp.vocab else None

    def _check_mesh(self, mesh, flash_mesh=None) -> None:
        if mesh is not None and (self.tp is None or self.tp.mesh is not mesh):
            raise ValueError("the model is not sharded over this mesh: "
                             "repro_torch.distributed.tensor_parallel."
                             "shard_lm(model, mesh) first")
        if self.tp is not None and flash_mesh is not None:
            raise ValueError("flash decoding and tensor parallelism on the "
                             "same model axis are not combined")

    def _inputs(self, tokens, embeds) -> torch.Tensor:
        if embeds is not None:
            return torch.as_tensor(embeds, device=self.device).to(
                dtype_of(self.cfg))
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return embed(self.embed, tokens, self.embed_scale,
                     tp=self._vocab_tp())

    def _logits(self, x) -> torch.Tensor:
        """Float32 logits over the whole vocabulary (gathered from the
        ranks' slices under tensor parallelism)."""
        vt = self._vocab_tp()
        logits = unembed(x, self.head, vt)
        return logits if vt is None else vt.gather(logits)

    def forward(self, tokens=None, embeds=None, media=None, *,
                want_caches: bool = False, logits_mode: str = "all",
                want_aux: bool = False, remat: bool = False,
                data_group=None, mesh=None):
        """Full-sequence forward: float32 logits ``(B, S, V)`` (``(B, 1,
        V)`` with ``logits_mode="last"``); with ``want_aux`` then the
        layers' summed MoE aux terms ``(3,)`` (load balance, z, dropped
        fraction), and with ``want_caches`` last one cache a layer
        (:meth:`Block.forward`; None for an xLSTM layer).  ``media`` (B,
        T, d), the tokens a cross layer attends to, is used in its own
        dtype, as the reference uses it.  ``remat`` checkpoints each
        block (training: keep only each block's input, recompute its
        activations in the backward pass); it takes no caches.
        ``data_group``: the data-parallel group whose ranks' rows, in
        rank order, make the batch; a MoE layer's capacity, drops and
        load balance are then the whole batch's.  ``mesh``: the mesh the
        model is sharded over (module docstring)."""
        self._check_mesh(mesh)
        x, aux_sum, caches = self._hidden(tokens, embeds, media,
                                          want_caches, logits_mode, remat,
                                          data_group)
        out = (self._logits(x),)
        if want_aux:
            out += (aux_sum,)
        if want_caches:
            out += (caches,)
        return out if len(out) > 1 else out[0]

    def _hidden(self, tokens, embeds, media, want_caches, logits_mode,
                remat, data_group):
        """The final-normed hidden states (the last position's with
        ``logits_mode="last"``), the summed aux terms and the caches."""
        if remat and want_caches:
            raise ValueError("remat is for training and returns no caches")
        x = self._inputs(tokens, embeds)
        if media is not None:
            media = torch.as_tensor(media, device=self.device)
        chunks = _attn_chunks(self.cfg, x.shape[1])
        caches = []
        aux_sum = torch.zeros(3, dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            if remat:
                x, aux, cache = checkpoint(
                    blk, x, chunks=chunks, want_cache=False, media=media,
                    data_group=data_group, use_reentrant=False)
            else:
                x, aux, cache = blk(x, chunks=chunks,
                                    want_cache=want_caches, media=media,
                                    data_group=data_group)
            aux_sum = aux_sum + aux
            caches.append(cache)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if logits_mode == "last":
            x = x[:, -1:]
        return x, aux_sum, caches

    def prefill(self, tokens=None, embeds=None, media=None, mesh=None):
        """Full forward, per-layer caches and last-position logits
        (``mesh``: as :meth:`forward`'s)."""
        return self.forward(tokens, embeds, media, want_caches=True,
                            logits_mode="last", mesh=mesh)

    def init_decode_caches(self, batch: int, max_len: int,
                           flash_mesh=None, mesh=None) -> list:
        """Empty decode caches, one a layer (:meth:`Block.init_cache`);
        with ``flash_mesh`` each GQA ring holds this rank's slots, on a
        sharded model this rank's kv heads."""
        self._check_mesh(mesh, flash_mesh)
        return [blk.init_cache(batch, max_len, flash_mesh)
                for blk in self.blocks]

    def decode_step(self, token, caches: list, pos: int, flash_mesh=None,
                    mesh=None):
        """One serving step: ``token`` (B, 1) ids (or (B, 1, d) embeds for
        a model fed embeddings) at absolute position ``pos``.  Returns
        (float32 logits (B, 1, V), caches): attention caches are updated
        in place, a recurrent layer's state replaced in the list.

        ``flash_mesh``: sequence-sharded flash decoding for the GQA layers
        over the mesh's model axis; their caches are then this rank's
        slots (``init_decode_caches(..., flash_mesh=)``).  ``mesh``: the
        mesh a sharded model is split over; its logits come gathered."""
        self._check_mesh(mesh, flash_mesh)
        if self.cfg.embed_inputs:
            x = self._inputs(token, None)
        else:
            x = self._inputs(None, token)
        for i, blk in enumerate(self.blocks):
            x, caches[i] = blk.decode(x, caches[i], pos, flash_mesh)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x), caches


def lm_loss(model: DecoderLM, tokens=None, embeds=None, labels=None,
            media=None, *, aux_weight: float = 0.01, z_weight: float = 1e-4,
            remat: bool = False, data_group=None, mesh=None):
    """The training loss: (total, metrics), total = the mean token NLL +
    ``aux_weight`` · load balance + ``z_weight`` · router z; metrics
    ``nll``, ``load_balance``, ``router_z`` and ``dropped_frac`` (0-d
    float32 tensors), as the reference's ``lm_loss``.  ``data_group``:
    see :meth:`DecoderLM.forward`.  On a sharded model (``mesh``) each
    rank keeps its vocabulary slice of the logits and the cross-entropy
    is reduced over the model group."""
    model._check_mesh(mesh)
    x, aux, _ = model._hidden(tokens, embeds, media, False, "all", remat,
                              data_group)
    vt = model._vocab_tp()
    logits = unembed(x, model.head, vt)
    labels = torch.as_tensor(labels, device=logits.device)
    loss = softmax_cross_entropy(logits, labels, tp=vt)
    total = loss + aux_weight * aux[0] + z_weight * aux[1]
    metrics = {"nll": loss, "load_balance": aux[0], "router_z": aux[1],
               "dropped_frac": aux[2]}
    return total, metrics
