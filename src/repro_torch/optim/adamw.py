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

Over a mesh: under tensor parallelism (``tp``) a leaf split over the
model axis contributes the sum of its blocks' squares over the model
group (one ``all_reduce`` of every leaf's square sum, replicated leaves
counted once); with ZeRO-1 (``AdamWState.zero``, a
:class:`~repro_torch.distributed.tensor_parallel.Zero1`) each data rank
holds its block of a leaf's moments, updates that block of the
parameter and gathers the parameter whole over the data group.  AdamW is
elementwise, so the split step equals the unsplit one bit for bit.
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
    zero: object = None   # a Zero1: the moments are this data rank's blocks


def adamw_init(params: Mapping[str, torch.Tensor], zero=None) -> AdamWState:
    """Zero moments (with ``zero``, each leaf's block on this data rank)
    and step 0."""
    def zeros(k, p):
        shape = p.shape if zero is None else zero.cut(p, k).shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    dev = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m={k: zeros(k, p) for k, p in params.items()},
                      v={k: zeros(k, p) for k, p in params.items()},
                      zero=zero)


def global_norm(tree: Mapping[str, torch.Tensor], tp=None) -> torch.Tensor:
    """The L2 norm of every leaf; with ``tp`` the leaves split over the
    model axis summed over its group (module docstring)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree.values()]
    if tp is not None:
        import torch.distributed as dist

        split = torch.tensor([tp.sharded(k) for k in tree],
                             device=sq[0].device)
        every = torch.stack(sq)
        part = torch.where(split, every, 0.0)
        dist.all_reduce(part, group=tp.group)
        sq = list(torch.where(split, part, every).unbind())
    return torch.sqrt(sum(sq))


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
                 lr: torch.Tensor, tp=None):
    """Returns (params, new_state, metrics); ``params``, ``state.m`` and
    ``state.v`` are updated in place (the state's step is a new tensor).
    The clipped float32 gradient of a leaf is formed inside its update,
    so no float32 copy of all gradients is held at once.  ``tp``: the
    model's :class:`~repro_torch.distributed.tensor_parallel.
    TensorParallel` (the norm); ``state.zero``: ZeRO-1 (module
    docstring)."""
    norm = global_norm(grads, tp)
    scale = _clip_scale(norm, cfg.clip_norm)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    zero = state.zero
    for name, p in params.items():
        whole = p
        if zero is not None:        # this data rank's block (a view)
            p = zero.cut(p, name)
        g = (grads[name].float() if zero is None
             else zero.cut(grads[name], name).float()) * scale
        m, v = state.m[name], state.v[name]
        m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        p32 = p.float()
        delta = delta + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        if zero is not None and name in zero.dims:
            _gather_zero(whole, zero, name)
    metrics = {"grad_norm": norm, "lr": lr}
    return params, AdamWState(step, state.m, state.v, zero), metrics


def _gather_zero(p: torch.Tensor, zero, name: str) -> None:
    """Every data rank's updated block of ``p`` gathered into it."""
    import torch.distributed as dist

    d = zero.dims[name]
    mine = zero.cut(p, name).contiguous()
    parts = [torch.empty_like(mine) for _ in range(zero.size)]
    dist.all_gather(parts, mine, group=zero.group())
    p.copy_(torch.cat(parts, dim=d))
