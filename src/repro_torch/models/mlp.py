"""Gated (SwiGLU) feed-forward block, the dense FFN of every arch
(column- then row-parallel under tensor parallelism)."""

from __future__ import annotations

import torch

from .common import dense_init

__all__ = ["init_mlp_params", "mlp_forward"]


def init_mlp_params(gen, d_model: int, d_ff: int, dtype, device
                    ) -> torch.nn.ParameterDict:
    return torch.nn.ParameterDict({
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    })


def mlp_forward(p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The SwiGLU MLP; with ``tp`` (a :class:`~repro_torch.distributed.
    tensor_parallel.TensorParallel`) ``w_gate``/``w_up`` are this rank's
    columns and ``w_down`` its rows, and the output is summed over the
    model group (one ``all_reduce``)."""
    if tp is not None:
        x = tp.copy(x)
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = h @ p["w_down"]
    return y if tp is None else tp.reduce(y)
