"""Train-step factory of the port: microbatches, clipping, AdamW, int8
gradient compression with error feedback, remat.

* **Microbatches** (a leading ``M`` axis on every batch entry) each take
  one ``torch.autograd.grad``; their gradients are added in **float32**
  (the reference adds ``g.astype(float32)`` in its ``lax.scan``), then
  scaled by ``1/M``, and the loss and metrics are averaged.  ``.grad`` is
  not used: ``backward()`` accumulates it in the parameter's dtype, bf16
  in production.  Besides the reference's reasons, a microbatch bounds the
  float32 logits, ``(B/M · S, V)``, which dominate memory at a 151,936
  vocabulary.
* **Gradient compression** (optional): each leaf quantized to int8 at one
  float32 scale, the quantization error carried to the next step in
  ``TrainState.err`` (float32).  ``torch.round`` rounds half to even, as
  ``jnp.round``.
* **Remat**: each block under ``torch.utils.checkpoint`` (``TrainConfig.
  remat``, see :func:`repro_torch.models.lm.lm_loss`).

The model's parameters are updated in place, so ``TrainState.model`` is
the same module before and after a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.models.lm import lm_loss
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update)
from repro_torch.optim import schedule as sched

__all__ = ["TrainConfig", "TrainState", "make_train_step", "train_state_init"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # grad accumulation steps
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "warmup_cosine"
    adamw: AdamWConfig = AdamWConfig()
    compress_grads: bool = False     # int8 + error feedback
    aux_weight: float = 0.01
    z_weight: float = 1e-4
    remat: bool = True               # checkpoint each block


class TrainState(NamedTuple):
    model: torch.nn.Module           # a DecoderLM, its parameters trainable
    opt: AdamWState
    err: Optional[dict]              # error-feedback residual (compression)


def train_state_init(model, tcfg: TrainConfig) -> TrainState:
    """A fresh state over ``model``: its parameters made trainable
    (serving keeps them frozen), zero moments, step 0 and, with
    compression, a zero float32 residual a parameter."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    err = ({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()} if tcfg.compress_grads else None)
    return TrainState(model=model, opt=adamw_init(params), err=err)


def _quantize_int8(g: torch.Tensor):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress(grads: dict, err: dict):
    """int8 quantization with error feedback; returns (deq grads, new err)."""
    deq, new_err = {}, {}
    for k, g in grads.items():
        g = g.float() + err[k]
        q, scale = _quantize_int8(g)
        deq[k] = q.float() * scale
        new_err[k] = g - deq[k]
    return deq, new_err


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` maps ``tokens`` (or ``embeds``), ``labels`` and, for a model
    with cross layers, ``media`` to arrays or tensors; each carries a
    leading microbatch axis when ``tcfg.microbatches > 1``: tokens
    ``(M, B/M, S)`` etc.  Metrics are 0-d device tensors (reading one
    stops the host).  The step's two halves are ``train_step.grads(state,
    batch) -> (loss, metrics, grads)`` and ``train_step.update(state,
    loss, metrics, grads) -> (state, metrics)``.
    """
    schedule_fn = getattr(sched, tcfg.schedule)
    dev = next(model.parameters()).device

    def loss_and_grads(params, mb):
        total, metrics = lm_loss(
            model, tokens=mb.get("tokens"), embeds=mb.get("embeds"),
            labels=mb["labels"], media=mb.get("media"),
            aux_weight=tcfg.aux_weight, z_weight=tcfg.z_weight,
            remat=tcfg.remat)
        grads = torch.autograd.grad(total, list(params.values()))
        return (total.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def grads_of(state: TrainState, batch: dict):
        params = dict(state.model.named_parameters())
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                 if v is not None}
        M = tcfg.microbatches
        if M == 1:
            return loss_and_grads(params, batch)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for k, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        per_mb = []
        for i in range(M):
            loss, metrics, g = loss_and_grads(
                params, {k: v[i] for k, v in batch.items()})
            for k, gk in g.items():
                acc[k].add_(gk.float())
            loss_sum = loss_sum + loss
            per_mb.append(metrics)
            del g
        inv = 1.0 / M
        for a in acc.values():
            a.mul_(inv)
        metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                   for k in per_mb[0]}
        return loss_sum * inv, metrics, acc

    def update(state: TrainState, loss, metrics: dict, grads: dict):
        err = state.err
        if tcfg.compress_grads:
            grads, err = _compress(grads, err)
        lr = schedule_fn(state.opt.step, peak_lr=tcfg.peak_lr,
                         warmup_steps=tcfg.warmup_steps,
                         total_steps=tcfg.total_steps)
        _, opt, opt_metrics = adamw_update(
            tcfg.adamw, dict(state.model.named_parameters()), grads,
            state.opt, lr)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(state.model, opt, err), metrics

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = grads_of(state, batch)
        return update(state, loss, metrics, grads)

    train_step.grads = grads_of
    train_step.update = update
    return train_step
