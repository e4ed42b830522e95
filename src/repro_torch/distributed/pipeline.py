"""GPipe-style pipeline parallelism over a mesh axis (the ``pod`` axis), the
port of ``repro/distributed/pipeline.py`` over ``torch.distributed``.

* stage s is the rank at coordinate s of ``axis`` and holds its slice of
  the stacked stage parameters;
* the classic GPipe schedule runs ``M + S − 1`` ticks over ``M``
  microbatches: at tick t stage 0 takes microbatch t, each stage applies
  ``stage_fn`` to the microbatch it holds and hands the activation to the
  next stage (``send``/``recv``), and the last stage emits microbatch
  ``t − S + 1``;
* a stage works only on the ticks where it holds a microbatch (the
  reference computes on the bubble ticks too and throws the results
  away), and a rank never sends to itself: at S = 1 there is no hand-off;
* at the end the last stage broadcasts the outputs over the axis, so every
  rank returns them, as the reference's masked ``psum`` gives them;
* bubble fraction = (S − 1)/(M + S − 1) (:func:`bubble_fraction`).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_map

__all__ = ["pipeline_forward", "bubble_fraction"]


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def pipeline_forward(stage_fn: Callable, stage_params, x: torch.Tensor,
                     mesh, *, axis: str = "pod",
                     num_microbatches: int | None = None) -> torch.Tensor:
    """Run ``stage_fn(params_s, h) -> h`` through S pipeline stages.

    ``stage_params`` leaves have a leading stage axis (S, ...); this rank
    uses row ``mesh.coordinate[axis]``.  ``x`` is the (M, mb, ...)
    microbatched input, the same on every rank; ``stage_fn`` keeps an
    activation's shape and dtype.  Returns the pipeline output (M, mb,
    ...) on every rank of the axis — numerically the stages applied in
    sequence.
    """
    import torch.distributed as dist

    S = mesh.shape[axis]
    M = num_microbatches or x.shape[0]
    if x.shape[0] != M:
        raise ValueError("leading dim of x must be the microbatch count")
    stage = mesh.coordinate[axis]
    params = tree_map(lambda a: a[stage], stage_params)
    prev = mesh.rank_of(axis, stage - 1) if stage > 0 else None
    nxt = mesh.rank_of(axis, stage + 1) if stage < S - 1 else None
    outs = torch.zeros_like(x)
    buf = torch.empty_like(x[0])
    for t in range(M + S - 1):
        mb = t - stage                       # the microbatch this stage holds
        if not 0 <= mb < M:
            continue
        if prev is None:
            h = x[mb]
        else:
            dist.recv(buf, src=prev)
            h = buf
        h = stage_fn(params, h)
        if nxt is None:
            outs[mb] = h
        else:
            dist.send(h.contiguous(), dst=nxt)
    if S > 1:
        dist.broadcast(outs, src=mesh.rank_of(axis, S - 1),
                       group=mesh.group(axis))
    return outs
