"""xLSTM blocks of the port: mLSTM (matrix memory) and sLSTM (scalar memory).

The torch counterpart of the reference's ``models/xlstm.py``.  mLSTM is
linear attention with exponential-style gating,

    C_t = f_t C_{t-1} + i_t v_t k_tᵀ ,  n_t = f_t n_{t-1} + i_t k_t ,
    h_t = (C_t q_t) / max(|n_t·q_t|, 1),

run on :func:`~repro_torch.models.ssm.ssd_chunked` (decay = log σ(f̃),
dt = the i gate, a ones channel appended to v so one scan gives both the
values and the normaliser).  sLSTM is a true recurrence (scalar memories,
block-diagonal recurrent gate weights), a Python loop over time, with the
xLSTM paper's stabiliser state ``m``, one a head.

The up/down projections live inside the blocks (``d_ff = 0``): mLSTM
up-projects 2× (value path + output gate); sLSTM is followed by a 4/3
GELU MLP, the tanh form (``jax.nn.gelu``'s default).  The gate weights
``w_if`` and both ``f_bias`` stay float32 whatever the model's dtype.

Tensor parallelism (``tp``, a :class:`~repro_torch.distributed.
tensor_parallel.TensorParallel`) splits both blocks by whole heads.
mLSTM: ``w_up`` by columns, role by role (this rank's value channels
and their gates); u is gathered whole (one ``all_gather``) and ``w_q``,
``w_k``, ``w_v`` and ``w_if`` (role by role, [i | f]) are cut by this
rank's heads' columns, so every dot product is whole; ``out_norm`` is cut
by channels (its mean of squares summed over the group) and ``w_down``
by rows (one ``all_reduce``); :class:`MLSTMCache` holds this rank's
heads.  sLSTM: ``w_gates`` by columns, role by role ([i f z o] of this
rank's heads), ``r_gates`` and ``f_bias`` replicated and read by this
rank's heads, so the time loop makes no collective; after it h is
gathered whole (one ``all_gather``) for the norm, the residual and the
GELU MLP, whose ``w_ff1`` columns and ``w_ff2`` rows are split (one
``all_reduce``, ``tp_ff``) where its width divides;
:class:`SLSTMCache` holds this rank's channels and its heads' ``m``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init, frozen, kernel_init, rms_norm, zeros
from .ssm import ssd_chunked, ssd_decode_step

__all__ = ["init_mlstm_params", "mlstm_forward", "mlstm_init_cache",
           "mlstm_decode", "init_slstm_params", "slstm_forward",
           "slstm_init_cache", "slstm_decode", "MLSTMCache", "SLSTMCache"]


def _full(shape, value, device) -> torch.nn.Parameter:
    return frozen(torch.full(shape, value, dtype=torch.float32,
                             device=device))


# ==================================================================== mLSTM
class MLSTMCache(NamedTuple):
    state: torch.Tensor     # (B, H, dk, dv+1) f32 — matrix memory + norm col


def init_mlstm_params(gen, cfg, dtype, device) -> torch.nn.ParameterDict:
    d = cfg.d_model
    inner = 2 * d                      # xLSTM pf=2 up-projection
    H = cfg.num_heads
    return torch.nn.ParameterDict({
        "w_up": dense_init(gen, d, 2 * inner, dtype, device),  # value + gate
        "w_q": dense_init(gen, inner, inner, dtype, device),
        "w_k": dense_init(gen, inner, inner, dtype, device),
        "w_v": dense_init(gen, inner, inner, dtype, device),
        "w_if": kernel_init(gen, (inner, 2 * H), torch.float32, device,
                            scale=inner ** -0.5),        # i,f gate logits
        "f_bias": _full((H,), 3.0, device),              # open forget gates
        "out_norm": zeros((inner,), dtype, device),
        "w_down": dense_init(gen, inner, d, dtype, device),
    })


def _mlstm_up(p, x, tp):
    """The up-projection: (u, gate), this rank's channels of each under
    ``tp`` (``w_up`` cut role by role)."""
    if tp is not None:
        x = tp.copy(x)
    ug = x @ p["w_up"]
    inner = ug.shape[-1] // 2
    return ug[..., :inner], ug[..., inner:]


def _mlstm_qkvg(p, u, cfg, tp=None):
    """q, k, v (B,S,H,P), the input gate and log forget gate (B,S,H);
    with ``tp`` this rank's heads, from u gathered whole (module
    docstring)."""
    B, S, _ = u.shape
    H = cfg.num_heads
    P = 2 * cfg.d_model // H
    f_bias = p["f_bias"]
    if tp is not None:
        # u whole on every rank, read by this rank's heads only
        u = tp.copy(tp.gather(u))
        H //= tp.size
        f_bias = tp.copy(f_bias)[tp.index * H:(tp.index + 1) * H]
    q = (u @ p["w_q"]).reshape(B, S, H, P)
    k = (u @ p["w_k"]).reshape(B, S, H, P) * (P ** -0.5)
    v = (u @ p["w_v"]).reshape(B, S, H, P)
    gates = u.float() @ p["w_if"]                        # (B,S,2H) f32
    i_raw, f_raw = gates[..., :H], gates[..., H:]
    log_f = F.logsigmoid(f_raw + f_bias)                 # ≤ 0 decay
    i_gate = torch.exp(F.logsigmoid(i_raw))              # bounded input gate
    return q, k, v, i_gate, log_f


def _mlstm_read(y_aug):
    """Split value/normaliser channels; h = Cq / max(|n·q|, 1)."""
    y, n = y_aug[..., :-1], y_aug[..., -1:]
    denom = torch.clamp(n.float().abs(), min=1.0)
    return (y.float() / denom).to(y.dtype)


def _mlstm_out(p, h, gate, cfg, tp=None):
    h = rms_norm(h, p["out_norm"], cfg.norm_eps, tp)
    h = h * F.silu(gate.float()).to(h.dtype)
    h = h @ p["w_down"]
    return h if tp is None else tp.reduce(h)


def _v_aug(v):
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def mlstm_forward(p, x, *, cfg, chunk: int = 0, tp=None):
    chunk = chunk or (cfg.ssm.chunk if cfg.ssm else 256)
    B, S, d = x.shape
    u, gate = _mlstm_up(p, x, tp)
    q, k, v, i_gate, log_f = _mlstm_qkvg(p, u, cfg, tp)
    # SSD mapping: x=v_aug, dt=i, log_a=log_f, B=k, C=q
    y_aug = ssd_chunked(_v_aug(v), i_gate, log_f, k, q, chunk=chunk)
    return _mlstm_out(p, _mlstm_read(y_aug).reshape(B, S, -1), gate, cfg,
                      tp)


def mlstm_init_cache(cfg, batch: int, device, tp=None) -> MLSTMCache:
    """An empty memory: every head's, or (``tp``) this rank's."""
    H = cfg.num_heads
    P = 2 * cfg.d_model // H
    if tp is not None:
        H //= tp.size
    return MLSTMCache(state=torch.zeros((batch, H, P, P + 1),
                                        dtype=torch.float32, device=device))


def mlstm_decode(p, x1, cache: MLSTMCache, *, cfg, tp=None):
    B = x1.shape[0]
    u, gate = _mlstm_up(p, x1, tp)
    q, k, v, i_gate, log_f = _mlstm_qkvg(p, u, cfg, tp)
    y_aug, state = ssd_decode_step(
        cache.state, _v_aug(v)[:, 0], i_gate[:, 0], log_f[:, 0], k[:, 0],
        q[:, 0])
    h = _mlstm_read(y_aug).reshape(B, 1, -1)
    return _mlstm_out(p, h, gate, cfg, tp), MLSTMCache(state=state)


# ==================================================================== sLSTM
class SLSTMCache(NamedTuple):
    h: torch.Tensor   # (B, d)
    c: torch.Tensor   # (B, d) cell
    n: torch.Tensor   # (B, d) normaliser
    m: torch.Tensor   # (B, H) stabiliser


def init_slstm_params(gen, cfg, dtype, device) -> torch.nn.ParameterDict:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    return torch.nn.ParameterDict({
        "w_gates": dense_init(gen, d, 4 * d, dtype, device),  # i,f,z,o of x
        "r_gates": kernel_init(gen, (4, H, dh, dh), dtype, device,
                               scale=dh ** -0.5),        # recurrent, blockdiag
        "f_bias": _full((d,), 3.0, device),
        "out_norm": zeros((d,), dtype, device),
        # post-block 4/3 GELU MLP (the paper's sLSTM block)
        "w_ff1": dense_init(gen, d, (4 * d) // 3, dtype, device),
        "w_ff2": dense_init(gen, (4 * d) // 3, d, dtype, device),
    })


def _slstm_local(p, x, tp):
    """The sLSTM's input and recurrent weights for this rank: (x for
    ``w_gates``, ``r_gates``, ``f_bias``), under ``tp`` the blocks of its
    heads, the replicated leaves through ``copy_to_model``."""
    r_gates, f_bias = p["r_gates"], p["f_bias"]
    if tp is None:
        return x, r_gates, f_bias
    H = r_gates.shape[1] // tp.size
    d = f_bias.shape[0] // tp.size
    i = tp.index
    return (tp.copy(x), tp.copy(r_gates)[:, i * H:(i + 1) * H],
            tp.copy(f_bias)[i * d:(i + 1) * d])


def _slstm_step(r_gates, f_bias, carry, xg):
    """One timestep. xg: (B, 4d) precomputed input contribution."""
    h, c, n, m = carry
    B, d = h.shape
    H = m.shape[-1]
    dh = d // H
    rec = torch.einsum("bhd,ghde->bghe", h.reshape(B, H, dh),
                       r_gates.float())                      # (B,4,H,dh)
    g = xg.float() + rec.reshape(B, 4 * d)
    gi, gf, gz, go = g.chunk(4, dim=-1)
    gf = gf + f_bias
    # stabilised exponential gating (per-head max state)
    log_f = F.logsigmoid(gf)
    m_prev = torch.repeat_interleave(m, dh, dim=-1)          # (B, d)
    m_new = torch.maximum(log_f + m_prev, gi)
    i_st = torch.exp(gi - m_new)
    f_st = torch.exp(log_f + m_prev - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = f_st * c + i_st * z
    n_new = f_st * n + i_st
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    m_head = m_new.reshape(B, H, dh).amax(dim=-1)
    return SLSTMCache(h_new, c_new, n_new, m_head)


def _slstm_out(p, h, dtype, cfg, tp_ff=None):
    """Norm and the post-block GELU (tanh form) MLP of the hidden states
    (``tp_ff``: ``w_ff1``'s columns and ``w_ff2``'s rows, summed)."""
    h = rms_norm(h, p["out_norm"], cfg.norm_eps)
    hf = h if tp_ff is None else tp_ff.copy(h)
    ff = F.gelu((hf @ p["w_ff1"]).float(), approximate="tanh").to(dtype)
    ff = ff @ p["w_ff2"]
    return h + (ff if tp_ff is None else tp_ff.reduce(ff))


def slstm_forward(p, x, *, cfg, tp=None, tp_ff=None):
    """(B,S,d) → (B,S,d); ``tp``: this rank's heads (module docstring),
    ``tp_ff``: the MLP split."""
    B, S, d = x.shape
    xin, r_gates, f_bias = _slstm_local(p, x, tp)
    xg = xin @ p["w_gates"]                                  # (B,S,4d)
    carry = slstm_init_cache(cfg, B, x.device, tp)
    hs = []
    for t in range(S):
        carry = _slstm_step(r_gates, f_bias, carry, xg[:, t])
        hs.append(carry.h)
    h = torch.stack(hs, dim=1).to(x.dtype)                   # (B,S,d)
    if tp is not None:
        h = tp.gather(h)
    return _slstm_out(p, h, x.dtype, cfg, tp_ff)


def slstm_init_cache(cfg, batch: int, device, tp=None) -> SLSTMCache:
    """An empty state: every channel's, or (``tp``) this rank's channels
    and its heads' stabilisers."""
    d, H = cfg.d_model, cfg.num_heads
    if tp is not None:
        d, H = d // tp.size, H // tp.size

    def z():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)

    return SLSTMCache(h=z(), c=z(), n=z(), m=torch.full(
        (batch, H), -1e30, dtype=torch.float32, device=device))


def slstm_decode(p, x1, cache: SLSTMCache, *, cfg, tp=None, tp_ff=None):
    xin, r_gates, f_bias = _slstm_local(p, x1, tp)
    xg = (xin @ p["w_gates"])[:, 0]
    carry = _slstm_step(r_gates, f_bias, cache, xg)
    h = carry.h[:, None].to(x1.dtype)
    if tp is not None:
        h = tp.gather(h)
    return _slstm_out(p, h, x1.dtype, cfg, tp_ff), carry
