"""Shared model primitives of the port: norms, RoPE, embeddings, init, dtypes.

The torch counterpart of the reference's ``models/common.py``: serving's
primitives and the training loss (:func:`softmax_cross_entropy`).
Conventions kept from it:

* weight matrices are stored ``(d_in, d_out)``, so a layer is ``x @ w``;
* parameters live in ``cfg.dtype`` (bf16 in production); math that needs
  it (norms, softmax, rope, the vocab logits) runs in float32.

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


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
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
          scale: float = 1.0) -> torch.Tensor:
    out = table[tokens]
    if scale != 1.0:
        out = (out.float() * scale).to(out.dtype)
    return out


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Vocab logits in float32 (the reference's ``preferred_element_type``):
    a bf16 operand is widened first, which is exact, so the products and
    their sum are float32 and never rounded to the operands' dtype."""
    return x.float() @ table.float().T


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL; logits (..., V) float32, labels (...) integer ids:
    a float32 ``logsumexp`` less the gathered logit, then the mean (or
    the mean over ``mask``), as the reference's expression."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
