"""GQA and MLA attention of the port: chunked prefill, ring-buffer decode.

The torch counterpart of the reference's ``models/attention.py``, its GQA
and MLA paths.  Prefill runs the reference's flash-style streaming
softmax over its static chunk-pair schedule (:func:`make_pair_schedule`:
only the (q-chunk, kv-chunk) pairs with a live entry under causality and
the window), one pair at a time; the running (max, denominator,
accumulator) of a q-chunk row resets at the row's first pair.  Scores,
softmax and the weighted sum run in float32 whatever the operands'
dtype, as the reference's ``preferred_element_type`` asks.

Decode keeps one :class:`KVCache` a layer, a ring buffer of ``W =
min(window, max_len)`` (or ``max_len``) slots written at ``pos % W``; a
slot's absolute position is ``-1`` until written.

MLA (DeepSeek-V2) keeps a compressed cache, :class:`MLACache`: the
normed latent ``c_kv`` and one shared RoPE key a position.  Its prefill
expands each kv chunk's keys and values from the latent inside
:func:`chunked_attention` (value width ``v_head_dim``, score scale
``(nope + rope)^-0.5``); its decode absorbs ``W_uk`` into the query and
scores in the latent space, rounding ``q_lat`` and ``o_lat`` to the model
dtype where the reference does.

Cross-attention (llama-3.2-vision) lets text queries attend to
``media`` tokens without RoPE, behind a tanh gate that starts at 0.  Its
keys and values are the media's projections (:func:`_cross_kv`), in the
dtype JAX promotes the media and the weights to; a decode reads them from
the layer's cache, filled by prefill.

The sequence-sharded flash decode (``flash_mesh``, :func:`_flash_decode`)
splits a GQA ring cache over a mesh's model axis, one ``W / S`` block a
rank (:func:`flash_cache_shard`), and combines the ranks' softmax
statistics and outputs with two small ``all_reduce`` calls a layer.

Tensor parallelism (``tp`` = (:class:`~repro_torch.distributed.
tensor_parallel.TensorParallel`, :class:`~repro_torch.distributed.
tensor_parallel.HeadSplit`)) splits a GQA layer by whole heads: ``wq``,
``wk`` and ``wv`` are this rank's heads' columns, QK-norm and RoPE act on
those heads, ``wo`` is row-parallel with one ``all_reduce`` a layer, and
the decode ring cache holds this rank's kv heads.  Where the kv heads do
not divide over the model axis, ``wk`` and ``wv`` are replicated: every
rank projects every kv head and keeps those its query heads read.  MLA
splits the same way by its query heads (``wq``, ``w_uk``, ``w_uv``, and
``wo``'s rows): ``w_dkv`` and ``kv_norm`` are replicated, the latent and
the RoPE key they make pass through ``copy_to_model``, and the latent
cache stays whole on every rank.  Cross-attention splits its text
queries and the media's K/V by whole heads as GQA does, its cache holds this
rank's kv heads, and its tanh gate acts after the ``all_reduce``.  Flash
decoding and tensor parallelism on the same model axis are refused.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .common import apply_rope, dense_init, rms_norm, rope_angles, zeros

__all__ = ["NEG_INF", "make_pair_schedule", "chunked_attention", "KVCache",
           "init_gqa_params", "gqa_forward", "gqa_init_cache", "gqa_decode",
           "flash_cache_shard",
           "MLACache", "init_mla_params", "mla_forward", "mla_init_cache",
           "mla_decode", "init_cross_params", "cross_forward",
           "cross_decode"]

NEG_INF = -1e30          # a finite mask value, as the reference's


def make_pair_schedule(nq: int, nk: int, *, cq: int, ck: int, causal: bool,
                       window: int = 0,
                       q_pos_offset: int = 0) -> tuple[np.ndarray, ...]:
    """Static (i, j, new_row) arrays of chunk pairs with any live entry.

    Predicates are in *positions*, not chunk indices, so mixed chunk sizes
    (cq != ck) stay exact: q chunk i spans [off+i·cq, off+(i+1)·cq) and kv
    chunk j spans [j·ck, (j+1)·ck).  Row-major in i so the streaming-softmax
    carry is valid.
    """
    i_l, j_l, n_l = [], [], []
    for i in range(nq):
        q_lo = q_pos_offset + i * cq
        q_hi = q_pos_offset + (i + 1) * cq - 1
        first = True
        for j in range(nk):
            k_lo = j * ck
            k_hi = (j + 1) * ck - 1
            if causal and k_lo > q_hi:
                continue          # entirely in the future
            if causal and window and k_hi <= q_lo - window:
                continue          # entirely outside the window
            i_l.append(i)
            j_l.append(j)
            n_l.append(first)
            first = False
        if first:
            raise ValueError("empty schedule row")
    return (np.asarray(i_l, np.int32), np.asarray(j_l, np.int32),
            np.asarray(n_l, np.bool_))


def chunked_attention(
    q: torch.Tensor,                 # (B, S, H, dk)
    kv_raw: torch.Tensor,            # (B, Skv, raw) stacked kv
    expand_fn: Callable,             # (kv_chunk (B,ck,raw), j) -> (k,v)
    *,
    chunk_q: int,
    chunk_k: int,
    causal: bool,
    window: int = 0,                 # 0 = unlimited
    q_pos_offset: int = 0,
    out_dim: Optional[int] = None,   # v head dim (defaults to dk)
    scale: Optional[float] = None,
    kv_valid_len: Optional[int] = None,  # mask padded kv tail
) -> torch.Tensor:
    B, S, H, dk = q.shape
    Skv = kv_raw.shape[1]
    dv = out_dim or dk
    cq, ck = min(chunk_q, S), min(chunk_k, Skv)
    if S % cq or Skv % ck:
        raise ValueError(f"S={S}/{Skv} not divisible by chunks {cq}/{ck}")
    i_arr, j_arr, new_arr = make_pair_schedule(
        S // cq, Skv // ck, cq=cq, ck=ck, causal=causal, window=window,
        q_pos_offset=q_pos_offset)
    sc = scale if scale is not None else dk ** -0.5
    dev = q.device
    rows = torch.arange(cq, device=dev)[:, None]
    cols = torch.arange(ck, device=dev)[None, :]
    out = torch.zeros((B, S, H, dv), dtype=q.dtype, device=dev)
    m = l = acc = None
    for i, j, new_row in zip(i_arr.tolist(), j_arr.tolist(),
                             new_arr.tolist()):
        qc = q[:, i * cq:(i + 1) * cq]
        kc, vc = expand_fn(kv_raw[:, j * ck:(j + 1) * ck], j)
        s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kc.float()) * sc
        qpos = q_pos_offset + i * cq + rows
        kpos = j * ck + cols
        live = torch.ones((cq, ck), dtype=torch.bool, device=dev)
        if causal:
            live &= kpos <= qpos
        if window:
            live &= kpos > qpos - window
        if kv_valid_len is not None and kv_valid_len < Skv:
            live &= kpos < kv_valid_len
        s = torch.where(live, s, NEG_INF)

        if new_row:                      # reset the row state
            m = torch.full((B, H, cq), NEG_INF, device=dev)
            l = torch.zeros((B, H, cq), device=dev)
            acc = torch.zeros((B, H, cq, dv), device=dev)
        m_new = torch.maximum(m, s.amax(dim=-1))          # (B,H,cq)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])               # (B,H,cq,ck)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vc.dtype).float(),
                          vc.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
        norm = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,H,cq,dv)
        out[:, i * cq:(i + 1) * cq] = norm.transpose(1, 2).to(out.dtype)
    return out


def _decode_attention(q1, k_all, v_all, live, scale):
    """Single-position attention: q (B,1,H,dk) vs full caches (B,W,H,·)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q1.float(), k_all.float()) * scale
    s = torch.where(live[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v_all.dtype).float(),
                     v_all.float())
    return o.to(q1.dtype)


class KVCache(NamedTuple):
    """Ring-buffer KV cache (window layers wrap; full layers W = max_len)."""

    k: torch.Tensor          # (B, W, Hkv, hd)
    v: torch.Tensor          # (B, W, Hkv, hd)
    pos: torch.Tensor        # (W,) int32 absolute positions, -1 = empty


def init_gqa_params(gen, cfg, dtype, device) -> torch.nn.ParameterDict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.num_heads * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.num_heads * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros((hd,), dtype, device)
        p["k_norm"] = zeros((hd,), dtype, device)
    return torch.nn.ParameterDict(p)


def _gqa_qkv(p, x, positions, *, cfg, theta, tp=None, copied=False):
    """Projections, per-head QK-RMSNorm (when the config has it), then
    RoPE on q and k; with ``tp`` this rank's heads (module docstring),
    ``copied``: x has passed through ``copy_to_model`` already (a hybrid
    layer's input, shared with its Mamba branch; kv heads split)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    if tp is None:
        q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
        k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
        v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        sin, cos = rope_angles(positions, hd, theta)
        return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v
    ctx, hs = tp
    xc = x if copied else ctx.copy(x)
    q = (xc @ p["wq"]).reshape(B, S, hs.hq, hd)
    if hs.kv_split:
        k = (xc @ p["wk"]).reshape(B, S, hs.hkv, hd)
        v = (xc @ p["wv"]).reshape(B, S, hs.hkv, hd)
    else:       # whole on every rank; the gradient summed after the pick
        k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
        v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, ctx.copy(p["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, ctx.copy(p["k_norm"]) if hs.kv_split
                     else p["k_norm"], cfg.norm_eps)
    sin, cos = rope_angles(positions, hd, theta)
    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    if not hs.kv_split:
        held = slice(hs.kv_lo, hs.kv_lo + hs.hkv)
        k, v = ctx.copy(k)[:, :, held], ctx.copy(v)[:, :, held]
    return q, k, v


def _expand_kv(t: torch.Tensor, groups: int, tp=None) -> torch.Tensor:
    """A kv tensor (B, ·, Hkv, hd) spread over its query heads: each kv
    head repeated ``groups`` times, or (replicated kv under ``tp``) each
    local query head's held kv head."""
    if tp is None or tp[1].kv_split:
        return torch.repeat_interleave(t, groups, dim=2)
    return t.index_select(2, tp[1].kv_map)


def gqa_forward(p, x, *, cfg, theta: float, window: int,
                chunk_q: int = 1024, chunk_k: int = 1024,
                return_kv: bool = False, tp=None, copied: bool = False):
    """Prefill GQA over the full sequence (``tp``: module docstring;
    ``copied``: :func:`_gqa_qkv`'s)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, x, positions, cfg=cfg, theta=theta, tp=tp,
                       copied=copied)
    n_kv = k.shape[2]
    groups = cfg.num_heads // cfg.num_kv_heads
    kv_raw = torch.cat([k.reshape(B, S, -1), v.reshape(B, S, -1)], dim=-1)

    def expand(kvc, j):
        ck = kvc.shape[1]
        kk = kvc[..., : n_kv * hd].reshape(B, ck, n_kv, hd)
        vv = kvc[..., n_kv * hd:].reshape(B, ck, n_kv, hd)
        return _expand_kv(kk, groups, tp), _expand_kv(vv, groups, tp)

    out = chunked_attention(q, kv_raw, expand, chunk_q=chunk_q,
                            chunk_k=chunk_k, causal=True, window=window)
    out = out.reshape(B, S, -1) @ p["wo"]
    if tp is not None:
        out = tp[0].reduce(out)
    if return_kv:
        return out, (k, v)
    return out


def gqa_init_cache(cfg, batch: int, max_len: int, window: int, dtype,
                   device, kv_heads: Optional[int] = None) -> KVCache:
    """An empty ring cache of ``kv_heads`` heads (the config's unless
    given: this rank's under tensor parallelism)."""
    W = min(window, max_len) if window else max_len
    shape = (batch, W, kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((W,), -1, dtype=torch.int32, device=device),
    )


def gqa_decode(p, x1, cache: KVCache, pos: int, *, cfg, theta: float,
               window: int, flash_mesh=None, tp=None):
    """One decode step at absolute position ``pos``: writes the new K/V
    into the cache's slot ``pos % W`` in place and returns (out, cache).

    ``flash_mesh``: the flash-decoding path over the mesh's model axis
    (:func:`_flash_decode`); ``cache`` is then this rank's ``W / S``
    slots (:func:`flash_cache_shard`).  ``tp``: this rank's heads, the
    cache holding its kv heads (module docstring)."""
    B = x1.shape[0]
    hd = cfg.resolved_head_dim
    pos = int(pos)
    if tp is not None and flash_mesh is not None:
        raise ValueError("flash decoding and tensor parallelism on the "
                         "same model axis are not combined")
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x1.device)
    q, k, v = _gqa_qkv(p, x1, positions, cfg=cfg, theta=theta, tp=tp)
    if flash_mesh is not None:
        o, cache = _flash_decode(q, k, v, cache, pos, cfg=cfg,
                                 window=window, mesh=flash_mesh)
        return o.reshape(B, 1, -1) @ p["wo"], cache
    W = cache.k.shape[1]
    slot = pos % W
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.pos[slot] = pos
    live = (cache.pos >= 0) & (cache.pos <= pos)
    if window:
        live &= cache.pos > pos - window
    groups = cfg.num_heads // cfg.num_kv_heads
    k_all = _expand_kv(cache.k, groups, tp)
    v_all = _expand_kv(cache.v, groups, tp)
    o = _decode_attention(q, k_all, v_all, live[None].expand(B, W),
                          hd ** -0.5)
    o = o.reshape(B, 1, -1) @ p["wo"]
    return (o if tp is None else tp[0].reduce(o)), cache



def _model_axis(mesh, model_axis: str) -> tuple[int, int]:
    """(S, this rank's index) along the model axis (1, 0 without one)."""
    if model_axis not in mesh.axis_names:
        return 1, 0
    return mesh.shape[model_axis], mesh.coordinate[model_axis]


def flash_cache_shard(cache: KVCache, mesh,
                      model_axis: str = "model") -> KVCache:
    """This rank's slots of a whole ring cache for :func:`_flash_decode`:
    slots ``[r·W/S, (r+1)·W/S)`` for model-axis index r of S.  ``W % S``
    must be 0 (``ValueError``, as the reference's)."""
    S, me = _model_axis(mesh, model_axis)
    W = cache.k.shape[1]
    if W % S:
        raise ValueError(f"window {W} not divisible by model axis {S}")
    sl = slice(me * (W // S), (me + 1) * (W // S))
    return KVCache(cache.k[:, sl].clone(), cache.v[:, sl].clone(),
                   cache.pos[sl].clone())


def _flash_decode(q, k_new, v_new, cache: KVCache, pos: int, *, cfg,
                  window: int, mesh, model_axis: str = "model"):
    """Sequence-sharded decode attention (flash decoding on the model
    axis), the reference's ``shard_map`` body over ``torch.distributed``.

    ``cache`` holds this rank's ``Wl = W / S`` slots of the ring; the new
    K/V go only to the rank that owns slot ``pos % W``, written in place.
    Queries and weights are replicated.  Each rank scores its slots in
    float32 and takes its max ``m`` and ``l = Σ exp(s − m)``; one
    ``all_gather`` of (m, l) over the model group gives every rank the
    global max ``m_g`` and sum ``l_g = Σ_r l_r · exp(m_r − m_g)``.  The
    weights ``exp(s − m_g) / l_g`` are cast to the cache's dtype and
    multiply v, and one ``all_reduce`` SUM of that (B, H, 1, hd) float32
    product over the group gives ``o``: 2 collectives a layer, as the
    reference's (a max, then the sums).  The reference instead casts the
    unnormalised ``exp(s − m_g)`` and divides after its sum; in float32
    the two agree to rounding, and normalising first makes a bf16 decode
    round its weights as the default decode (:func:`_decode_attention`)
    does.  A model axis of one rank makes no collective.  A rank whose
    slots are all dead scores ``NEG_INF`` everywhere and adds zeros.
    Returns (o (B, 1, H, hd) in q's dtype, cache)."""
    import torch.distributed as dist

    S, me = _model_axis(mesh, model_axis)
    B, _, H, hd = q.shape
    Wl = cache.k.shape[1]
    W = Wl * S
    slot = pos % W
    if slot // Wl == me:
        local = slot % Wl
        cache.k[:, local] = k_new[:, 0]
        cache.v[:, local] = v_new[:, 0]
        cache.pos[local] = pos
    live = (cache.pos >= 0) & (cache.pos <= pos)
    if window:
        live &= cache.pos > pos - window
    groups = cfg.num_heads // cfg.num_kv_heads
    k_all = torch.repeat_interleave(cache.k, groups, dim=2)  # (B, Wl, H, hd)
    v_all = torch.repeat_interleave(cache.v, groups, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_all.float()) \
        * hd ** -0.5
    s = torch.where(live[None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                   # (B, H, 1)
    p_ = torch.exp(s - m[..., None])
    l = p_.sum(dim=-1)                                   # (B, H, 1)
    if S > 1:
        stats = [torch.empty((2, *m.shape), dtype=m.dtype, device=m.device)
                 for _ in range(S)]
        dist.all_gather(stats, torch.stack([m, l]),
                        group=mesh.group(model_axis))
        every = torch.stack(stats)                       # (S, 2, B, H, 1)
        m_g = every[:, 0].amax(dim=0)
        l = (every[:, 1] * torch.exp(every[:, 0] - m_g)).sum(dim=0)
        p_ = p_ * torch.exp(m - m_g)[..., None]
    p_ = p_ / torch.clamp(l, min=1e-30)[..., None]
    o = torch.einsum("bhqk,bkhd->bhqd", p_.to(v_all.dtype).float(),
                     v_all.float())                      # (B, H, 1, hd)
    if S > 1:
        dist.all_reduce(o, group=mesh.group(model_axis))
    return o.permute(0, 2, 1, 3).to(q.dtype), cache


# ======================================================================= MLA
class MLACache(NamedTuple):
    """Compressed cache: latent c_kv + shared rope key (the MLA point)."""

    c_kv: torch.Tensor       # (B, W, rank)
    k_rope: torch.Tensor     # (B, W, rope_dim)
    pos: torch.Tensor        # (W,) int32 absolute positions, -1 = empty


def init_mla_params(gen, cfg, dtype, device) -> torch.nn.ParameterDict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return torch.nn.ParameterDict({
        "wq": dense_init(gen, d, H * qd, dtype, device),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype, device),
        "kv_norm": zeros((m.kv_lora_rank,), dtype, device),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                           dtype, device),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype,
                           device),
        "wo": dense_init(gen, H * m.v_head_dim, d, dtype, device),
    })


def _mla_heads(cfg, tp) -> int:
    """The query heads an MLA layer computes here (this rank's under
    ``tp``)."""
    return cfg.num_heads if tp is None else tp[1].hq


def _mla_q(p, x, positions, cfg, tp=None):
    m = cfg.mla
    B, S, _ = x.shape
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    if tp is not None:
        x = tp[0].copy(x)
    q = (x @ p["wq"]).reshape(B, S, _mla_heads(cfg, tp), qd)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    sin, cos = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, sin, cos)


def _mla_compress(p, x, positions, cfg):
    m = cfg.mla
    ckv = x @ p["w_dkv"]                                 # (B,S,rank+rope)
    c, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    sin, cos = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], sin, cos)[..., 0, :]
    return c, k_rope


def mla_forward(p, x, *, cfg, chunk_q: int = 1024, chunk_k: int = 1024,
                return_kv: bool = False, tp=None):
    """Train/prefill MLA; k/v expanded chunk-locally from the latent
    (``tp``: this rank's heads, module docstring)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = _mla_heads(cfg, tp)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, positions, cfg, tp)
    q = torch.cat([q_nope, q_rope], dim=-1)
    c, k_rope = _mla_compress(p, x, positions, cfg)
    kv_raw = torch.cat([c, k_rope], dim=-1)
    if tp is not None:      # whole on every rank, read by this rank's heads
        kv_raw = tp[0].copy(kv_raw)

    def expand(kvc, j):
        ck = kvc.shape[1]
        cc = kvc[..., :m.kv_lora_rank]
        kr = kvc[..., m.kv_lora_rank:]
        k_nope = (cc @ p["w_uk"]).reshape(B, ck, H, m.qk_nope_head_dim)
        v = (cc @ p["w_uv"]).reshape(B, ck, H, m.v_head_dim)
        kr = kr[..., None, :].expand(B, ck, H, m.qk_rope_head_dim)
        return torch.cat([k_nope, kr], dim=-1), v

    dk = m.qk_nope_head_dim + m.qk_rope_head_dim
    out = chunked_attention(q, kv_raw, expand, chunk_q=chunk_q,
                            chunk_k=chunk_k, causal=True,
                            out_dim=m.v_head_dim, scale=dk ** -0.5)
    out = out.reshape(B, S, -1) @ p["wo"]
    if tp is not None:
        out = tp[0].reduce(out)
    if return_kv:
        return out, (c, k_rope)
    return out


def mla_init_cache(cfg, batch: int, max_len: int, dtype, device
                   ) -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, m.qk_rope_head_dim),
                           dtype=dtype, device=device),
        pos=torch.full((max_len,), -1, dtype=torch.int32, device=device),
    )


def mla_decode(p, x1, cache: MLACache, pos: int, *, cfg, tp=None):
    """Decode with weight absorption — scores live in the latent space.
    Writes the new latent and rope key into slot ``pos % W`` in place and
    returns (out, cache); ``tp``: this rank's heads over the whole
    cache."""
    m = cfg.mla
    B = x1.shape[0]
    H = _mla_heads(cfg, tp)
    pos = int(pos)
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x1.device)
    q_nope, q_rope = _mla_q(p, x1, positions, cfg, tp)
    c1, kr1 = _mla_compress(p, x1, positions, cfg)
    W = cache.c_kv.shape[1]
    slot = pos % W
    cache.c_kv[:, slot] = c1[:, 0]
    cache.k_rope[:, slot] = kr1[:, 0]
    cache.pos[slot] = pos
    live = (cache.pos >= 0) & (cache.pos <= pos)
    cc, ckr = cache.c_kv.float(), cache.k_rope.float()

    # absorb W_uk into q: (B,1,H,rank)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(),
                         w_uk.float()).to(x1.dtype)
    s = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), cc)
         + torch.einsum("bqhn,bkn->bhqk", q_rope.float(), ckr))
    dk = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = s * dk ** -0.5
    s = torch.where(live[None, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr",
                         pattn.to(cache.c_kv.dtype).float(), cc)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat.to(x1.dtype).float(),
                     w_uv.float()).to(x1.dtype)
    o = o.reshape(B, 1, -1) @ p["wo"]
    return (o if tp is None else tp[0].reduce(o)), cache


# ============================================================ cross-attention
def init_cross_params(gen, cfg, dtype, device) -> torch.nn.ParameterDict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return torch.nn.ParameterDict({
        "wq": dense_init(gen, d, cfg.num_heads * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.num_heads * hd, d, dtype, device),
        "gate": zeros((), dtype, device),   # llama3.2-style tanh gate, 0
        "q_norm": zeros((hd,), dtype, device),
        "k_norm": zeros((hd,), dtype, device),
    })


def _cross_kv(p, media, cfg, tp=None):
    """The media's keys (normed) and values, (B, T, Hkv, hd) each, in the
    dtype JAX gives ``media @ w`` (float32 media against bf16 weights:
    float32); under ``tp`` this rank's kv heads, as :func:`_gqa_qkv`
    makes them."""
    B, T, _ = media.shape
    hd = cfg.resolved_head_dim
    dt = torch.promote_types(media.dtype, p["wk"].dtype)
    media = media.to(dt)
    k_norm = p["k_norm"]
    split = tp is not None and tp[1].kv_split
    if split:
        media, k_norm = tp[0].copy(media), tp[0].copy(k_norm)
    n_kv = tp[1].hkv if split else cfg.num_kv_heads
    k = (media @ p["wk"].to(dt)).reshape(B, T, n_kv, hd)
    v = (media @ p["wv"].to(dt)).reshape(B, T, n_kv, hd)
    k = rms_norm(k, k_norm, cfg.norm_eps)
    if tp is not None and not split:
        held = slice(tp[1].kv_lo, tp[1].kv_lo + tp[1].hkv)
        k, v = tp[0].copy(k)[:, :, held], tp[0].copy(v)[:, :, held]
    return k, v


def _cross_gate(p, out):
    return torch.tanh(p["gate"].float()).to(out.dtype)


def _cross_q(p, x, cfg, tp):
    """The text queries (normed), this rank's heads under ``tp``."""
    B, S, _ = x.shape
    q_norm = p["q_norm"]
    if tp is not None:
        x, q_norm = tp[0].copy(x), tp[0].copy(q_norm)
    heads = cfg.num_heads if tp is None else tp[1].hq
    q = (x @ p["wq"]).reshape(B, S, heads, cfg.resolved_head_dim)
    return rms_norm(q, q_norm, cfg.norm_eps)


def _cross_out(p, o, tp):
    """``wo`` (row-parallel under ``tp``, summed), then the gate."""
    out = o @ p["wo"]
    if tp is not None:
        out = tp[0].reduce(out)
    return out * _cross_gate(p, out)


def cross_forward(p, x, media, *, cfg, chunk_q: int = 1024, tp=None):
    """Text queries attend to the media tokens — no rope, gated."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _cross_q(p, x, cfg, tp)
    k, v = _cross_kv(p, media, cfg, tp)
    T, n_kv = k.shape[1], k.shape[2]
    groups = cfg.num_heads // cfg.num_kv_heads
    # pad the media tokens to a chunk multiple; kv_valid_len masks the tail
    ck = min(1024, 1 << (T - 1).bit_length())
    Tp = -(-T // ck) * ck
    kv_raw = torch.cat([k.reshape(B, T, -1), v.reshape(B, T, -1)], dim=-1)
    kv_raw = torch.nn.functional.pad(kv_raw, (0, 0, 0, Tp - T))

    def expand(kvc, j):
        cc = kvc.shape[1]
        kk = kvc[..., : n_kv * hd].reshape(B, cc, n_kv, hd)
        vv = kvc[..., n_kv * hd:].reshape(B, cc, n_kv, hd)
        return _expand_kv(kk, groups, tp), _expand_kv(vv, groups, tp)

    out = chunked_attention(q, kv_raw, expand, chunk_q=min(chunk_q, S),
                            chunk_k=ck, causal=False, window=0,
                            kv_valid_len=T)
    return _cross_out(p, out.reshape(B, S, -1), tp)


def cross_decode(p, x1, k_cache, v_cache, *, cfg, tp=None):
    """Decode: the media's K/V come from prefill; nothing is written
    (``tp``: the caches hold this rank's kv heads)."""
    B = x1.shape[0]
    hd = cfg.resolved_head_dim
    q = _cross_q(p, x1, cfg, tp)
    groups = cfg.num_heads // cfg.num_kv_heads
    k_all = _expand_kv(k_cache, groups, tp)
    v_all = _expand_kv(v_cache, groups, tp)
    live = torch.ones((B, k_all.shape[1]), dtype=torch.bool,
                      device=x1.device)
    o = _decode_attention(q, k_all, v_all, live, hd ** -0.5)
    return _cross_out(p, o.reshape(B, 1, -1), tp)
