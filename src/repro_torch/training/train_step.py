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
* **Data parallelism** (``mesh=``): each rank computes its loss and
  gradients on its ``global_batch / D`` rows (D the size of the mesh's
  data axes, ``pod`` and ``data``).  The global batch is the ranks' rows
  in rank order, microbatch by microbatch: global microbatch i is every
  rank's microbatch i, as the reference's SPMD step splits a batch
  sharded over its data axes.  A MoE layer takes its capacity, drops and
  load balance over the whole microbatch (one ``all_gather`` of counts a
  layer, :func:`repro_torch.models.moe.moe_forward`).  One
  ``all_reduce`` SUM over the data group a step, of one flat float32
  buffer (every gradient leaf, the loss and the metrics), divided by D,
  then gives every rank the global batch's loss and gradients.
  Compression then runs on that averaged gradient with a
  replicated residual, as the reference's compiled step compresses the
  global gradient; parameters and moments stay replicated.  At D = 1 the
  all-reduce still runs, and the step equals the one-device step bit for
  bit.
* **Tensor parallelism** (a model cut by :func:`repro_torch.distributed.
  tensor_parallel.shard_lm` over the mesh's model axis): each rank's
  gradients are its parameters' blocks; the data-parallel all-reduce
  stays over the data group, the global norm sums a split leaf's squares
  over the model group (replicated leaves once), and the int8 scale of a
  split leaf is the whole leaf's max (one ``all_reduce`` MAX over the
  model group), so the compressed step is the one-device step's.
* **ZeRO-1** (``train_state_init(..., mesh=)`` with more than one data
  rank): the moments are split over the data axes
  (:class:`~repro_torch.distributed.tensor_parallel.Zero1`) and each rank
  updates its block of each parameter, then gathers it whole
  (:func:`repro_torch.optim.adamw.adamw_update`).

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


def train_state_init(model, tcfg: TrainConfig, mesh=None) -> TrainState:
    """A fresh state over ``model``: its parameters made trainable
    (serving keeps them frozen), zero moments, step 0 and, with
    compression, a zero float32 residual a parameter.  With ``mesh`` of
    more than one data rank the moments are ZeRO-1 blocks
    (:func:`repro_torch.distributed.tensor_parallel.zero1_plan`)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    err = ({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()} if tcfg.compress_grads else None)
    zero = None
    if mesh is not None:
        from repro_torch.distributed.tensor_parallel import zero1_plan
        zero = zero1_plan(model, mesh)
    return TrainState(model=model, opt=adamw_init(params, zero), err=err)


def _quantize_int8(g: torch.Tensor, amax=None):
    if amax is None:
        amax = torch.max(torch.abs(g))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress(grads: dict, err: dict, tp=None):
    """int8 quantization with error feedback; returns (deq grads, new err).
    With ``tp`` each leaf's scale is its whole max over the model group:
    every leaf's max of this rank's block, one ``all_reduce`` MAX."""
    amax = [None] * len(grads)
    if tp is not None:
        import torch.distributed as dist

        every = torch.stack([torch.max(torch.abs(g.float() + err[k]))
                             for k, g in grads.items()])
        dist.all_reduce(every, op=dist.ReduceOp.MAX, group=tp.group)
        amax = every.unbind()
    deq, new_err = {}, {}
    for (k, g), a in zip(grads.items(), amax):
        g = g.float() + err[k]
        q, scale = _quantize_int8(g, a)
        deq[k] = q.float() * scale
        new_err[k] = g - deq[k]
    return deq, new_err


def _all_reduce_mean(loss, metrics: dict, grads: dict, mesh):
    """The data-parallel mean of a rank's loss, metrics and gradients:
    one flat float32 buffer, one ``all_reduce`` SUM over the data group,
    divided by its size.  The gradients come back float32."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import DATA_AXES

    scalars = [loss, *metrics.values()]
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()]
                     + [torch.stack([x.float() for x in scalars])])
    dist.all_reduce(flat, group=mesh.group(DATA_AXES))
    flat.div_(mesh.size(DATA_AXES))
    out, off = {}, 0
    for k, g in grads.items():
        out[k] = flat[off:off + g.numel()].view(g.shape)
        off += g.numel()
    tail = flat[off:]
    return tail[0], dict(zip(metrics, tail[1:])), out


def make_train_step(model, tcfg: TrainConfig, *, mesh=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` maps ``tokens`` (or ``embeds``), ``labels`` and, for a model
    with cross layers, ``media`` to arrays or tensors; each carries a
    leading microbatch axis when ``tcfg.microbatches > 1``: tokens
    ``(M, B/M, S)`` etc.  Metrics are 0-d device tensors (reading one
    stops the host).  The step's two halves are ``train_step.grads(state,
    batch) -> (loss, metrics, grads)`` and ``train_step.update(state,
    loss, metrics, grads) -> (state, metrics)``.

    With ``mesh`` (a :class:`repro_torch.distributed.mesh.Mesh`), ``batch`` is
    this rank's rows and ``grads`` returns the data-parallel mean over
    the mesh's data axes (:func:`_all_reduce_mean`).  A model sharded by
    ``shard_lm`` trains over its own mesh when ``mesh`` is None.
    """
    schedule_fn = getattr(sched, tcfg.schedule)
    dev = next(model.parameters()).device
    tp = getattr(model, "tp", None)
    if mesh is None and tp is not None:
        mesh = tp.mesh
    data_group = None
    if mesh is not None:
        from repro_torch.distributed.sharding import DATA_AXES
        if mesh.size(DATA_AXES) > 1:
            data_group = mesh.group(DATA_AXES)

    def loss_and_grads(params, mb):
        total, metrics = lm_loss(
            model, tokens=mb.get("tokens"), embeds=mb.get("embeds"),
            labels=mb["labels"], media=mb.get("media"),
            aux_weight=tcfg.aux_weight, z_weight=tcfg.z_weight,
            remat=tcfg.remat, data_group=data_group)
        grads = torch.autograd.grad(total, list(params.values()))
        return (total.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def grads_of(state: TrainState, batch: dict):
        loss, metrics, grads = local_grads(state, batch)
        if mesh is not None:
            return _all_reduce_mean(loss, metrics, grads, mesh)
        return loss, metrics, grads

    def local_grads(state: TrainState, batch: dict):
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
            grads, err = _compress(grads, err, tp)
        lr = schedule_fn(state.opt.step, peak_lr=tcfg.peak_lr,
                         warmup_steps=tcfg.warmup_steps,
                         total_steps=tcfg.total_steps)
        _, opt, opt_metrics = adamw_update(
            tcfg.adamw, dict(state.model.named_parameters()), grads,
            state.opt, lr, tp)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(state.model, opt, err), metrics

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = grads_of(state, batch)
        return update(state, loss, metrics, grads)

    train_step.grads = grads_of
    train_step.update = update
    return train_step
