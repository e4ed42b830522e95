"""State-space sequence mixing of the port: SSD (Mamba-2) chunked form.

The torch counterpart of the reference's ``models/ssm.py``.  Within a
chunk the output is an attention-like (c × c) product with a decay mask;
across chunks a small (B, H, N, P) float32 state is carried, here by a
Python loop over the chunks (the reference's ``lax.scan``).  Per-head
*scalar* decay is what makes the (c × c) factorisation exact.

``ssd_chunked`` serves the hymba Mamba branch and the xLSTM mLSTM block
(:mod:`repro_torch.models.xlstm`).  The reference's einsums accumulate
in float32 (``preferred_element_type``) and JAX widens a bf16 operand
met by a float32 one; torch's einsum refuses mixed dtypes, so the
operands are widened first, which is exact.  The intra-chunk decay is
masked before its ``exp`` as well as after: the forward is the
reference's bit for bit, and the gradient stays finite where the
reference's turns NaN (a chunk whose summed log decay passes ~88, as
Hymba's at 256 tokens: ``where``'s masked branch passes 0 · inf back).

Tensor parallelism (``tp``, a :class:`~repro_torch.distributed.
tensor_parallel.TensorParallel`) splits the Mamba branch by channels, as
the reference's rules cut it: ``w_in`` by columns, role by role (this
rank's x channels and their gates), the depthwise ``conv`` by channels
(it runs locally), ``w_bc`` and ``w_dt`` by rows (their partial B, C and
dt summed in one ``all_reduce``), ``out_norm`` by channels (its mean of
squares summed over the group) and ``w_out`` by rows (one
``all_reduce``).  ``dt_bias``, ``a_log`` and ``d_skip`` are replicated.
A rank's channels need not hold whole heads (Hymba's 25 heads at M = 2
or 4): it runs the SSD over sub-heads (:func:`_sub_heads`), and its
:class:`SSMCache` holds its channels and sub-heads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init, frozen, kernel_init, rms_norm, zeros

__all__ = ["ssd_chunked", "ssd_decode_step", "init_mamba_params",
           "mamba_forward", "mamba_init_cache", "mamba_decode", "SSMCache"]


# ============================================================== SSD core
def ssd_chunked(x, dt, log_a, Bm, Cm, *, chunk: int,
                initial_state=None, return_state: bool = False):
    """Chunked scan of  h_t = a_t h_{t-1} + dt_t B_t x_tᵀ ;  y_t = C_t·h_t.

    Shapes: x (B,S,H,P) values; dt (B,S,H) input scale; log_a (B,S,H)
    per-head log decay (≤ 0); Bm/Cm (B,S,H,N) input/output projections.
    Returns y (B,S,H,P) in x's dtype [+ final float32 state (B,H,N,P)].
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"S={S} not divisible by chunk={c}")
    dev = x.device
    h = (initial_state if initial_state is not None
         else torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=dev))
    pos = torch.arange(c, device=dev)
    causal = (pos[None, :] <= pos[:, None])[None, None]     # (1,1,t,s)
    ys = []
    for k0 in range(0, S, c):
        xk, dtk, lak = x[:, k0:k0 + c], dt[:, k0:k0 + c], log_a[:, k0:k0 + c]
        bk, ck = Bm[:, k0:k0 + c].float(), Cm[:, k0:k0 + c].float()
        cum = torch.cumsum(lak, dim=1)           # (B,c,H) Σ log a up to t
        total = cum[:, -1]                       # (B,H)
        # intra-chunk: L[t,s] = exp(cum_t - cum_s) (C_t · B_s), s <= t;
        # the decay is masked before its exp too: above the diagonal it
        # grows with the chunk (exp overflows past ~88), and where's
        # masked branch would pass 0 · inf = NaN back into the gradient
        scores = torch.einsum("bthn,bshn->bhts", ck, bk)
        decay = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        decay = torch.where(causal, decay, 0.0)
        L = torch.where(causal, scores * torch.exp(decay), 0.0)
        xdt = xk.float() * dtk[..., None]                    # (B,c,H,P)
        y_intra = torch.einsum("bhts,bshp->bthp", L, xdt)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bthn,bhnp->bthp", ck, h)
        y_inter = y_inter * torch.exp(cum)[..., None]
        # state update
        w = torch.exp(total[:, None] - cum)                  # (B,c,H)
        h_in = torch.einsum("bshn,bshp->bhnp", bk * w[..., None], xdt)
        h = h * torch.exp(total)[..., None, None] + h_in
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)
    if return_state:
        return y, h
    return y


def ssd_decode_step(h, x1, dt1, log_a1, B1, C1):
    """One-token state update. h (B,H,N,P); x1 (B,H,P); dt1/log_a1 (B,H);
    B1/C1 (B,H,N).  Returns (y (B,H,P) in x1's dtype, h_new)."""
    a = torch.exp(log_a1)[..., None, None]
    h_new = h * a + torch.einsum("bhn,bhp->bhnp",
                                 B1.float() * dt1[..., None], x1.float())
    y = torch.einsum("bhn,bhnp->bhp", C1.float(), h_new)
    return y.to(x1.dtype), h_new


# ============================================================ Mamba branch
class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, W-1, d_inner) rolling conv window
    state: torch.Tensor   # (B, H, N, P) f32 SSD state


def init_mamba_params(gen, cfg, dtype, device) -> torch.nn.ParameterDict:
    """The Mamba branch's weights; ``dt_bias``, ``a_log`` and ``d_skip``
    stay float32 whatever the model's dtype, as the reference's."""
    s = cfg.ssm
    d = cfg.d_model
    inner = s.expand * d
    H = cfg.num_heads
    N = s.state_dim
    f32 = torch.float32
    return torch.nn.ParameterDict({
        "w_in": dense_init(gen, d, 2 * inner, dtype, device),  # x + gate
        "conv": kernel_init(gen, (s.conv_width, inner), dtype, device,
                            scale=s.conv_width ** -0.5),
        "w_bc": dense_init(gen, inner, 2 * H * N, dtype, device),   # B, C
        "w_dt": dense_init(gen, inner, H, dtype, device),
        "dt_bias": zeros((H,), f32, device),
        "a_log": zeros((H,), f32, device),               # A = -exp(a_log)
        "d_skip": frozen(torch.ones((H,), dtype=f32, device=device)),
        "out_norm": zeros((inner,), dtype, device),
        "w_out": dense_init(gen, inner, d, dtype, device),
    })


def _causal_conv(x, w, prev=None):
    """Depthwise causal conv along S. x (B,S,C), w (W,C); prev (B,W-1,C).

    Sums in x's dtype in the reference's order, from 0; the tail kept for
    the next step is the input before the SiLU."""
    W = w.shape[0]
    pad = prev if prev is not None else torch.zeros(
        (x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i][None, None] for i in range(W))
    return (F.silu(out.float()).to(x.dtype),
            xp[:, -(W - 1):] if W > 1 else pad)


def _sub_heads(cfg, tp, device):
    """The SSD heads this rank runs: (P′, heads).  Without ``tp`` or at a
    model axis of one rank, the config's heads of P channels (``heads``
    None).  Else this rank's ``inner / M`` channels as sub-heads of P′ =
    gcd(P, inner / M) channels, and ``heads`` (inner / M / P′,) the head
    each sub-head belongs to: a head's channels are independent in the
    SSD recurrence, so a sub-head carrying its head's dt, log a, B, C and
    skip computes its channels of the head's output (25 heads of 128
    channels at M = 2 are 25 sub-heads of 64 a rank)."""
    inner = cfg.ssm.expand * cfg.d_model
    P = inner // cfg.num_heads
    if tp is None or tp.size == 1:
        return P, None
    n = inner // tp.size
    Ps = math.gcd(P, n)
    first = tp.index * n + torch.arange(0, n, Ps, device=device)
    return Ps, first // P


def _mamba_core_inputs(p, u, cfg, tp=None):
    """Shared projections: u (B,S,inner) → (x, dt, log_a, B, C, skip),
    x (B,S,H,P) and skip (H,).  With ``tp`` u is this rank's channels and
    ``w_bc``/``w_dt`` its rows: the partial B, C and dt are summed over
    the model group in one float32 ``all_reduce`` and cast once, and the
    heads are this rank's sub-heads (:func:`_sub_heads`)."""
    H, N = cfg.num_heads, cfg.ssm.state_dim
    B_, S, _ = u.shape
    bc = u @ p["w_bc"]
    dt_raw = u @ p["w_dt"]
    dt_bias, a_log, d_skip = p["dt_bias"], p["a_log"], p["d_skip"]
    if tp is not None:      # whole, read by this rank's sub-heads
        bc, dt_raw = tp.sum_parts(bc, dt_raw)
        dt_bias, a_log, d_skip = (tp.copy(t) for t in (dt_bias, a_log,
                                                       d_skip))
    Bm = bc[..., : H * N].reshape(B_, S, H, N).float()
    Cm = bc[..., H * N:].reshape(B_, S, H, N).float()
    # u @ w_dt in the model's dtype, widened after the product
    dt = F.softplus(dt_raw.float() + dt_bias)                  # (B,S,H)
    log_a = -torch.exp(a_log)[None, None] * dt                # ≤ 0
    P, heads = _sub_heads(cfg, tp, u.device)
    if heads is not None:
        dt, log_a, Bm, Cm = (t.index_select(2, heads)
                             for t in (dt, log_a, Bm, Cm))
        d_skip = d_skip.index_select(0, heads)
    xh = u.reshape(B_, S, -1, P)
    return xh, dt, log_a, Bm, Cm, d_skip


def _mamba_out(p, y, gate, cfg, tp=None):
    """Norm, the SiLU gate and the output projection of (B,S,inner)
    (this rank's channels and ``w_out``'s rows under ``tp``, summed over
    the model group)."""
    y = rms_norm(y, p["out_norm"], cfg.norm_eps, tp)
    y = y * F.silu(gate.float()).to(y.dtype)
    y = y @ p["w_out"]
    return y if tp is None else tp.reduce(y)


def _mamba_in(p, x, tp, copied=False):
    """The input projection: (u, gate), this rank's channels of each
    under ``tp`` (``w_in`` cut role by role; ``copied``: x has passed
    through ``copy_to_model`` already, shared with the layer's
    attention)."""
    if tp is not None and not copied:
        x = tp.copy(x)
    ug = x @ p["w_in"]
    inner = ug.shape[-1] // 2
    return ug[..., :inner], ug[..., inner:]


def mamba_forward(p, x, *, cfg, chunk: int = 0, return_state: bool = False,
                  tp=None, copied: bool = False):
    """(B,S,d) → (B,S,d) Mamba mixing (prefill); with ``return_state``
    also the :class:`SSMCache` a decode continues from.  ``tp``: the
    split over the model axis (module docstring); ``copied``:
    :func:`_mamba_in`'s."""
    chunk = chunk or cfg.ssm.chunk
    B_, S, d = x.shape
    u, gate = _mamba_in(p, x, tp, copied)
    u, conv_tail = _causal_conv(u, p["conv"])
    xh, dt, log_a, Bm, Cm, d_skip = _mamba_core_inputs(p, u, cfg, tp)
    y, h_fin = ssd_chunked(xh, dt, log_a, Bm, Cm, chunk=chunk,
                           return_state=True)
    y = y + xh.float().to(y.dtype) \
        * d_skip.to(y.dtype)[None, None, :, None]
    out = _mamba_out(p, y.reshape(B_, S, -1), gate, cfg, tp)
    if return_state:
        return out, SSMCache(conv=conv_tail, state=h_fin)
    return out


def mamba_init_cache(cfg, batch: int, dtype, device, tp=None) -> SSMCache:
    """An empty state: the whole branch's, or (``tp``) this rank's
    channels and sub-heads."""
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    P, _ = _sub_heads(cfg, tp, device)
    if tp is not None:
        inner //= tp.size
    return SSMCache(
        conv=torch.zeros((batch, s.conv_width - 1, inner), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, inner // P, s.state_dim, P),
                          dtype=torch.float32, device=device),
    )


def mamba_decode(p, x1, cache: SSMCache, *, cfg, tp=None):
    """One-token step. x1 (B,1,d) → ((B,1,d), the next :class:`SSMCache`)."""
    B_ = x1.shape[0]
    u, gate = _mamba_in(p, x1, tp)
    u, conv_new = _causal_conv(u, p["conv"], prev=cache.conv)
    xh, dt, log_a, Bm, Cm, d_skip = _mamba_core_inputs(p, u, cfg, tp)
    y1, h_new = ssd_decode_step(
        cache.state, xh[:, 0], dt[:, 0], log_a[:, 0], Bm[:, 0], Cm[:, 0])
    y1 = y1 + xh[:, 0].float().to(y1.dtype) \
        * d_skip.to(y1.dtype)[None, :, None]
    out = _mamba_out(p, y1.reshape(B_, 1, -1), gate, cfg, tp)
    return out, SSMCache(conv=conv_new, state=h_new)
