"""Fine-grained Mixture-of-Experts (DeepSeekMoE-style) of the port.

The torch counterpart of the reference's ``models/moe.py``: token-choice
top-k routing with capacity, dispatched **sort-based** (a stable sort of
the chosen experts gives every (token, choice) its slot in its expert's
capacity ``C``; slot ``E·C`` catches the overflow, whose output is 0),
the router in float32 whatever the model's dtype, and the
Switch-style load-balance and z aux losses.

``lax.top_k`` orders ties toward the smaller index and ``torch.topk``
promises no order, so every top-k here is a stable sort of the negated
values (:func:`_top_k`): the exact zeros that masked expert groups put
into the probabilities tie, and keep the reference's order.

The expert products keep the reference's ``preferred_element_type=
float32`` (:func:`_expert_mm`).  Expert weight stacks carry a leading
expert axis ``(E, d, f)``.  Shared experts (always on) are a plain
SwiGLU of width ``num_shared * d_expert``.

Under data parallelism (``group``, the data-parallel process group) a
rank holds only its rows of the batch, and the batch's rows are the
ranks' rows in rank order.  The capacity, the tokens dropped and the load
balance are then those of the whole batch, as the reference's SPMD step
computes them over its global batch (:func:`moe_forward`).

Under expert parallelism (``tp``, a :class:`~repro_torch.distributed.
tensor_parallel.TensorParallel`) a model rank holds the experts ``[r·E/M,
(r+1)·E/M)`` and its columns (rows) of the shared experts' ``w_gate`` and
``w_up`` (``w_down``).  Routing runs whole on every model rank, which all
see the same tokens; only this rank's experts fill its ``(E/M, C, d)``
buffer, and the ranks' float32 partial combines and partial shared
outputs are summed in one ``all_reduce`` before the cast.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .common import kernel_init
from .mlp import init_mlp_params, mlp_forward

__all__ = ["init_moe_params", "moe_forward", "MoEAux", "MoEParams"]


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor   # scalar
    router_z_loss: torch.Tensor       # scalar
    dropped_fraction: torch.Tensor    # scalar, tokens over capacity


class MoEParams(torch.nn.Module):
    """A MoE layer's parameters under the reference's leaf names
    (``router``, ``w_gate``, ``w_up``, ``w_down``, ``shared.*``), read
    like the reference's dict: ``p["router"]``, ``"shared" in p``."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, leaf in leaves.items():
            if isinstance(leaf, torch.nn.Parameter):
                self.register_parameter(name, leaf)
            else:
                self.add_module(name, leaf)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def init_moe_params(gen, cfg, dtype, device) -> MoEParams:
    m = cfg.moe
    d = cfg.d_model
    e, f = m.num_experts, m.d_expert
    p = {
        "router": kernel_init(gen, (d, e), torch.float32, device,
                              scale=d ** -0.5),
        "w_gate": kernel_init(gen, (e, d, f), dtype, device),
        "w_up": kernel_init(gen, (e, d, f), dtype, device),
        "w_down": kernel_init(gen, (e, f, d), dtype, device),
    }
    if m.num_shared:
        p["shared"] = init_mlp_params(gen, d, m.num_shared * f, dtype, device)
    return MoEParams(p)


def _top_k(v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties toward the
    smaller index (a stable ascending sort of ``-v``)."""
    idx = torch.sort(-v, dim=-1, stable=True).indices[..., :k]
    return v.gather(-1, idx), idx


class _WidenedMM(torch.autograd.Function):
    """``bmm(a, b)`` of narrow operands with a float32 result, and its
    derivative, which torch has none of for ``bmm(..., out_dtype=)``: each
    operand's gradient is the product of the float32 cotangent with the
    other operand widened (exact), a float32 result cast to the operand's
    dtype, as JAX transposes a ``preferred_element_type=float32``
    einsum."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def _expert_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(E, C, i) @ (E, i, o)`` with a float32 result, as the reference's
    ``einsum(..., preferred_element_type=float32)``.

    Float32 operands multiply as they are (TF32 off).  Narrower operands
    on the card go through one batched product with a float32 output
    (``out_dtype``), which reads each expert's weights once in their own
    dtype; on the CPU, which has no such product, they are widened first.
    Both keep every product exact and the sums in float32; the backward is
    :class:`_WidenedMM`'s.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    return _WidenedMM.apply(a, b)


def _quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 rows and one float32 scale a row (``round`` is half to even,
    as ``jnp.round``)."""
    s = v.abs().float().amax(-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(v / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def _every_rank(counts: torch.Tensor, group) -> torch.Tensor:
    """``counts`` of every rank of ``group``, stacked in rank order."""
    import torch.distributed as dist

    out = [torch.empty_like(counts)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, counts, group=group)
    return torch.stack(out)


def moe_forward(p, x: torch.Tensor, cfg, group=None, tp=None
                ) -> tuple[torch.Tensor, MoEAux]:
    """x: (B, S, d) → (B, S, d), plus router aux losses.

    ``group``: the data-parallel group of D > 1 ranks whose rows, in rank
    order, make the batch.  One ``all_gather`` of this rank's per-expert
    counts gives the whole batch's: the capacity ``C`` is the whole
    batch's, a (token, choice) keeps its slot when the ranks before this
    one and the tokens before it on this rank took fewer than ``C`` of
    its expert's, and the expert buffer holds ``C`` rows an expert.  The
    load-balance term is ``D`` times this rank's share of the whole
    batch's (its router mass over the whole batch's top-1 fractions), so
    the data-parallel mean of the ranks' losses, and of their gradients,
    is the whole batch's.  The z loss and the dropped fraction are means
    over tokens, which that mean already makes whole.

    ``tp``: expert parallelism over a model axis (module docstring).  The
    experts' and the shared path's input and the combine weights pass
    through ``copy_to_model``, since each rank's share of their gradient
    is partial; the router's logits and the aux terms are whole on every
    rank, and their gradient is not summed."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.num_experts, m.experts_per_token
    D = 1
    if group is not None:
        import torch.distributed as dist
        D = dist.get_world_size(group)
    C = int(math.ceil(T * D * K / E * m.capacity_factor))
    dev = x.device
    xt = x.reshape(T, d)
    # the experts' input: one node, so the split's gradient sums (the
    # experts' and the shared path's, then the router's) are the plain
    # model's at a model axis of one rank
    xe = xt.view_as(xt) if tp is None else tp.copy(xt)
    El = p["w_gate"].shape[0]                    # this rank's experts
    e0 = 0 if tp is None else tp.index * El

    # ---- router (f32) -------------------------------------------------
    logits = xt.float() @ p["router"].float()                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    if m.route_groups:
        # device-limited routing (DeepSeek-V2 §2.1.2): keep each token's
        # best `route_groups` expert groups by group-max affinity
        G = m.num_groups or max(E // 8, 1)
        gsz = E // G
        gmax = probs.reshape(T, G, gsz).amax(dim=-1)         # (T, G)
        _, top_g = _top_k(gmax, m.route_groups)              # (T, Rg)
        keep_g = torch.zeros((T, G), dtype=torch.bool, device=dev)
        keep_g.scatter_(1, top_g, True)
        probs = torch.where(keep_g.repeat_interleave(gsz, dim=1), probs,
                            0.0)
    top_p, top_e = _top_k(probs, K)                          # (T, K)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)          # deepseek norm

    flat_e = top_e.reshape(-1)                               # (T*K,)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    # aux losses (Switch-style load balance + z-loss)
    if D == 1:
        me = probs.mean(dim=0)                               # (E,)
        # the mean of one_hot(top_e[:, 0]) as a scatter (one_hot's range
        # check would stop the host for the card)
        ce = torch.zeros(E, device=dev).index_add_(
            0, top_e[:, 0], torch.ones(T, device=dev)) / T
        lb = E * torch.sum(me * ce)
        before = 0
    else:
        top1 = torch.zeros(E, dtype=flat_e.dtype, device=dev).index_add_(
            0, top_e[:, 0], torch.ones_like(top_e[:, 0]))
        every = _every_rank(torch.stack([counts, top1]), group)  # (D, 2, E)
        me = probs.sum(dim=0) / (T * D)                      # this rank's
        ce = every[:, 1].sum(dim=0).float() / (T * D)
        lb = D * E * torch.sum(me * ce)
        before = every[:dist.get_rank(group), 0].sum(dim=0)[flat_e]
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # ---- sort-based dispatch ------------------------------------------
    order = torch.sort(flat_e, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(T * K, device=dev)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = ranks - starts[flat_e]                             # slot in expert
    keep = pos + before < C
    local = flat_e - e0                                      # expert here
    mine = keep & (local >= 0) & (local < El)
    slot = torch.where(mine, local * C + pos, El * C)        # overflow slot

    token_rep = xe.repeat_interleave(K, dim=0)               # (T*K, d)
    if m.quantize_dispatch:
        # int8 transport with one float32 scale a row, dequantized on the
        # expert side
        tok_q, s_in = _quantize_rows(token_rep)
        buf_q = torch.zeros((El * C + 1, d), dtype=torch.int8, device=dev)
        buf_q[slot] = tok_q
        buf_s = torch.zeros((El * C + 1,), dtype=torch.float32, device=dev)
        buf_s[slot] = s_in
        buf = (buf_q[:El * C].float() * buf_s[:El * C, None]).to(
            x.dtype).reshape(El, C, d)
    else:
        buf = torch.zeros((El * C + 1, d), dtype=x.dtype, device=dev)
        buf[slot] = token_rep
        buf = buf[:El * C].reshape(El, C, d)

    # ---- expert FFN (batched over this rank's experts) ----------------
    g = _expert_mm(buf, p["w_gate"])                         # (El, C, f)
    u = _expert_mm(buf, p["w_up"])
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    out_buf = _expert_mm(h, p["w_down"])                     # (El, C, d)

    # ---- combine -------------------------------------------------------
    zero_row = torch.zeros((1, d), dtype=torch.float32, device=dev)
    if m.quantize_dispatch:
        ob_q, s_out = _quantize_rows(out_buf.reshape(El * C, d))
        out_q = torch.cat([ob_q, zero_row.to(torch.int8)])
        out_s = torch.cat([s_out, zero_row[0, :1]])
        gathered = (out_q[slot].float() * out_s[slot, None]).reshape(T, K, d)
    else:
        out_flat = torch.cat([out_buf.reshape(El * C, d), zero_row])
        gathered = out_flat[slot].reshape(T, K, d)           # dropped → 0
    w = (top_p * keep.reshape(T, K)).float()
    if tp is not None:
        w = tp.copy(w)
    out = torch.einsum("tkd,tk->td", gathered, w)            # float32
    shared = mlp_forward(p["shared"], xe) if m.num_shared else None
    if tp is not None:       # one sum of both partials, then the casts
        parts = [out] + ([shared.float()] if shared is not None else [])
        out, *rest = tp.reduce(torch.cat(parts, dim=-1)).split(d, dim=-1)
        shared = rest[0].to(x.dtype) if rest else None
    out = out.to(x.dtype)
    if shared is not None:
        out = out + shared

    aux = MoEAux(load_balance_loss=lb, router_z_loss=z,
                 dropped_fraction=1.0 - keep.float().mean())
    return out.reshape(B, S, d), aux
