"""AdamW of the port: the reference's update, expression for expression.

The state is ``AdamWState(step, m, v)``: ``step`` a 0-d int32 tensor on
the parameters' device, ``m`` and ``v`` float32 tensors keyed by parameter
name (``DecoderLM.named_parameters()``), whatever the parameters' dtype.

:func:`adamw_update` clips by the global norm, then updates each leaf as
the reference does: the moments in float32, ``bc1 = 1 - b1**t`` with ``t``
a float32 tensor, the weight decay inside ``delta``, and the new parameter
computed in float32 and cast **once** to the parameter's dtype, written in
place under ``torch.no_grad``.  ``torch.optim.AdamW`` is not used: it
applies the decay and the step as two in-place updates in the parameter's
dtype and computes the bias correction in float64 on the host, which round
differently from the reference.

The global norm sums the leaves' squares in the order of the mapping it is
given (the port's parameter order, layer by layer), not in the order JAX
flattens the reference's stacked tree (sorted keys); the two agree to
roundoff, not to the bit.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    m: dict
    v: dict


def adamw_init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()})


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """(float32 grads scaled to at most ``max_norm``, their norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: AdamWState,
                 lr: torch.Tensor):
    """Returns (params, new_state, metrics); ``params``, ``state.m`` and
    ``state.v`` are updated in place (the state's step is a new tensor).
    The clipped float32 gradient of a leaf is formed inside its update,
    so no float32 copy of all gradients is held at once."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state.m[name], state.v[name]
        m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        p32 = p.float()
        delta = delta + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    metrics = {"grad_norm": norm, "lr": lr}
    return params, AdamWState(step, state.m, state.v), metrics
