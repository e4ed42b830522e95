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


def _mlstm_qkvg(p, u, cfg):
    B, S, inner = u.shape
    H = cfg.num_heads
    P = inner // H
    q = (u @ p["w_q"]).reshape(B, S, H, P)
    k = (u @ p["w_k"]).reshape(B, S, H, P) * (P ** -0.5)
    v = (u @ p["w_v"]).reshape(B, S, H, P)
    gates = u.float() @ p["w_if"]                        # (B,S,2H) f32
    i_raw, f_raw = gates[..., :H], gates[..., H:]
    log_f = F.logsigmoid(f_raw + p["f_bias"])            # ≤ 0 decay
    i_gate = torch.exp(F.logsigmoid(i_raw))              # bounded input gate
    return q, k, v, i_gate, log_f


def _mlstm_read(y_aug):
    """Split value/normaliser channels; h = Cq / max(|n·q|, 1)."""
    y, n = y_aug[..., :-1], y_aug[..., -1:]
    denom = torch.clamp(n.float().abs(), min=1.0)
    return (y.float() / denom).to(y.dtype)


def _mlstm_out(p, h, gate, cfg):
    h = rms_norm(h, p["out_norm"], cfg.norm_eps)
    h = h * F.silu(gate.float()).to(h.dtype)
    return h @ p["w_down"]


def _v_aug(v):
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def mlstm_forward(p, x, *, cfg, chunk: int = 0):
    chunk = chunk or (cfg.ssm.chunk if cfg.ssm else 256)
    B, S, d = x.shape
    inner = 2 * d
    ug = x @ p["w_up"]
    u, gate = ug[..., :inner], ug[..., inner:]
    q, k, v, i_gate, log_f = _mlstm_qkvg(p, u, cfg)
    # SSD mapping: x=v_aug, dt=i, log_a=log_f, B=k, C=q
    y_aug = ssd_chunked(_v_aug(v), i_gate, log_f, k, q, chunk=chunk)
    return _mlstm_out(p, _mlstm_read(y_aug).reshape(B, S, inner), gate, cfg)


def mlstm_init_cache(cfg, batch: int, device) -> MLSTMCache:
    H = cfg.num_heads
    P = 2 * cfg.d_model // H
    return MLSTMCache(state=torch.zeros((batch, H, P, P + 1),
                                        dtype=torch.float32, device=device))


def mlstm_decode(p, x1, cache: MLSTMCache, *, cfg):
    B, _, d = x1.shape
    inner = 2 * d
    ug = x1 @ p["w_up"]
    u, gate = ug[..., :inner], ug[..., inner:]
    q, k, v, i_gate, log_f = _mlstm_qkvg(p, u, cfg)
    y_aug, state = ssd_decode_step(
        cache.state, _v_aug(v)[:, 0], i_gate[:, 0], log_f[:, 0], k[:, 0],
        q[:, 0])
    h = _mlstm_read(y_aug).reshape(B, 1, inner)
    return _mlstm_out(p, h, gate, cfg), MLSTMCache(state=state)


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


def _slstm_step(p, cfg, carry, xg):
    """One timestep. xg: (B, 4d) precomputed input contribution."""
    h, c, n, m = carry
    B, d = h.shape
    H = cfg.num_heads
    dh = d // H
    rec = torch.einsum("bhd,ghde->bghe", h.reshape(B, H, dh),
                       p["r_gates"].float())                 # (B,4,H,dh)
    g = xg.float() + rec.reshape(B, 4 * d)
    gi, gf, gz, go = g.chunk(4, dim=-1)
    gf = gf + p["f_bias"]
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


def _slstm_out(p, h, dtype, cfg):
    """Norm and the post-block GELU (tanh form) MLP of the hidden states."""
    h = rms_norm(h, p["out_norm"], cfg.norm_eps)
    ff = F.gelu((h @ p["w_ff1"]).float(), approximate="tanh").to(dtype)
    return h + ff @ p["w_ff2"]


def slstm_forward(p, x, *, cfg):
    B, S, d = x.shape
    xg = x @ p["w_gates"]                                    # (B,S,4d)
    carry = slstm_init_cache(cfg, B, x.device)
    hs = []
    for t in range(S):
        carry = _slstm_step(p, cfg, carry, xg[:, t])
        hs.append(carry.h)
    h = torch.stack(hs, dim=1).to(x.dtype)                   # (B,S,d)
    return _slstm_out(p, h, x.dtype, cfg)


def slstm_init_cache(cfg, batch: int, device) -> SLSTMCache:
    d = cfg.d_model

    def z():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)

    return SLSTMCache(h=z(), c=z(), n=z(), m=torch.full(
        (batch, cfg.num_heads), -1e30, dtype=torch.float32, device=device))


def slstm_decode(p, x1, cache: SLSTMCache, *, cfg):
    xg = (x1 @ p["w_gates"])[:, 0]
    carry = _slstm_step(p, cfg, cache, xg)
    return _slstm_out(p, carry.h[:, None].to(x1.dtype), x1.dtype, cfg), carry
