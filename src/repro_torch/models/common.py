"""Shared model primitives of the port: norms, RoPE, embeddings, init, dtypes.

The torch counterpart of the reference's ``models/common.py``: serving's
primitives and the training loss (:func:`softmax_cross_entropy`).
Conventions kept from it:

* weight matrices are stored ``(d_in, d_out)``, so a layer is ``x @ w``;
* parameters live in ``cfg.dtype`` (bf16 in production); math that needs
  it (norms, softmax, rope, the vocab logits) runs in float32.

Under tensor parallelism (``tp``, a
:class:`~repro_torch.distributed.tensor_parallel.TensorParallel` whose
vocabulary tables are split by rows over the model axis) :func:`embed`
looks up the rows this rank holds and sums over the model group,
:func:`unembed` returns this rank's vocabulary slice of the logits, and
:func:`softmax_cross_entropy` reduces the max, the sum of exponentials
and the label's logit over the group, so no rank holds ``(B, S, V)``
whole while training; :func:`rms_norm` over a norm cut by channels (the
Mamba branch's and mLSTM's ``out_norm``) sums the ranks' means of
squares over the group.  At a model axis of one rank each is the plain
expression bit for bit, its gradient included.

The init draws truncated normals at the reference's standard deviations
from a ``torch.Generator``; the values differ from JAX's draws, so weights
that must match the reference are carried by
:func:`repro_torch.convert.lm_from_arrays`.
"""

from __future__ import annotations

import math

import torch

__all__ = ["DTYPES", "dtype_of", "frozen", "zeros", "kernel_init",
           "dense_init", "rms_norm", "rope_angles", "apply_rope", "embed",
           "unembed", "softmax_cross_entropy"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def frozen(t: torch.Tensor) -> torch.nn.Parameter:
    """A parameter that serving never differentiates."""
    return torch.nn.Parameter(t, requires_grad=False)


def zeros(shape, dtype, device) -> torch.nn.Parameter:
    """A norm scale at its init (the ``1 + w`` form starts at identity)."""
    return frozen(torch.zeros(shape, dtype=dtype, device=device))


def kernel_init(gen: torch.Generator | None, shape, dtype, device,
                scale: float | None = None) -> torch.nn.Parameter:
    """Truncated-normal fan-in init (the llama/gemma default), drawn in
    float32 and cast; ``gen`` None leaves the values uninitialised (the
    caller copies weights in)."""
    if gen is None:
        return frozen(torch.empty(shape, dtype=dtype, device=device))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    # inverse-CDF draw of N(0, 1) truncated to [-3, 3]
    b = math.erf(3.0 / math.sqrt(2.0))
    out.uniform_(-b, b, generator=gen)
    out.erfinv_().mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0)
    return frozen((out * std).to(dtype))


def dense_init(gen, d_in: int, d_out: int, dtype, device
               ) -> torch.nn.Parameter:
    return kernel_init(gen, (d_in, d_out), dtype, device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, tp=None
             ) -> torch.Tensor:
    """RMSNorm over the last dim; with ``tp`` that dim is this rank's
    channels of a norm cut over the model axis (``weight`` its block):
    the ranks' means of squares are summed over the model group and
    divided by its size, then pass through ``copy_to_model`` (the sum
    feeds only this rank's channels)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    if tp is not None:
        var = tp.copy(tp.reduce(var)) / tp.size
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape (..., head_dim/2) for the given positions."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = torch.pow(theta, exponent)     # float32; no host-to-device copy
    ang = positions.float()[..., None] * freq              # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """Rotate the halves (x1, x2) = (x[..., :h/2], x[..., h/2:]).

    x: (..., S, n_heads, head_dim); sin/cos: (..., S, head_dim/2).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    s = sin[..., None, :].float()
    c = cos[..., None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          scale: float = 1.0, tp=None) -> torch.Tensor:
    if tp is None:
        out = table[tokens]
    else:                   # this rank's rows, then the sum over ranks
        V = table.shape[0]
        local = tokens - tp.index * V
        mine = (local >= 0) & (local < V)
        out = table[local.clamp(0, V - 1)]
        out = tp.reduce(torch.where(mine[..., None], out,
                                    torch.zeros((), dtype=out.dtype,
                                                device=out.device)))
    if scale != 1.0:
        out = (out.float() * scale).to(out.dtype)
    return out


def unembed(x: torch.Tensor, table: torch.Tensor, tp=None) -> torch.Tensor:
    """Vocab logits in float32 (the reference's ``preferred_element_type``):
    a bf16 operand is widened first, which is exact, so the products and
    their sum are float32 and never rounded to the operands' dtype.  With
    ``tp`` the logits of this rank's vocabulary slice."""
    if tp is not None:
        x = tp.copy(x)
    return x.float() @ table.float().T


class _VocabParallelNLL(torch.autograd.Function):
    """Each token's NLL from this rank's vocabulary slice of the logits:
    ``torch.logsumexp``'s expression with its max and sum of exponentials
    reduced over the model group, less the label's logit, which only its
    owner holds; the backward is autograd's of the plain expression,
    ``g · exp(x − lse)`` less ``g`` at the label."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        import torch.distributed as dist

        x = logits.float()
        V = x.shape[-1]
        m = torch.amax(x, dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = torch.sum(torch.exp(x - m), dim=-1)
        local = labels.long() - tp.index * V
        mine = (local >= 0) & (local < V)
        idx = local.clamp(0, V - 1)[..., None]
        ll = torch.where(mine, torch.gather(x, -1, idx)[..., 0], 0.0)
        both = torch.stack([s, ll])
        dist.all_reduce(both, group=tp.group)
        lse = torch.log(both[0]) + m[..., 0]
        ctx.save_for_backward(x, lse, idx, mine)
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        x, lse, idx, mine = ctx.saved_tensors
        grad = g[..., None] * torch.exp(x - lse[..., None])
        grad.scatter_add_(-1, idx, torch.where(mine, -g, 0.0)[..., None])
        return grad, None, None


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          tp=None) -> torch.Tensor:
    """Mean token NLL; logits (..., V) float32, labels (...) integer ids:
    a float32 ``logsumexp`` less the gathered logit, then the mean (or
    the mean over ``mask``), as the reference's expression.  With ``tp``
    ``logits`` are this rank's vocabulary slice (:func:`unembed`)."""
    if tp is not None:
        nll = _VocabParallelNLL.apply(logits, labels, tp)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
