"""Learning-rate schedules (warmup-cosine, warmup-linear, constant).

The reference's expressions on float32 tensors.  ``step`` is a device
int32 tensor (the optimizer's counter), so the learning rate is computed
where the step lives and reading it never stops the host.
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "warmup_linear", "constant"]


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    step = step.float()
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def warmup_linear(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                  total_steps: int) -> torch.Tensor:
    step = step.float()
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    return torch.where(step < warmup_steps, warm, peak_lr * (1.0 - prog))


def constant(step: torch.Tensor, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(step, peak_lr, dtype=torch.float32)
