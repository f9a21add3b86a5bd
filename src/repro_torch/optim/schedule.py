"""LR schedules (``repro.optim.schedule``), in float32 tensors on the
step's device, as the reference computes them."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def cosine_schedule(step: torch.Tensor, *, base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    t = (step.to(F32) / max(1, total_steps)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return base_lr * (final_frac + (1 - final_frac) * cos)


def linear_warmup_cosine(step: torch.Tensor, *, base_lr: float,
                         warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    step_f = step.to(F32)
    warm = base_lr * step_f / max(1, warmup_steps)
    cos = cosine_schedule(step - warmup_steps, base_lr=base_lr,
                          total_steps=max(1, total_steps - warmup_steps),
                          final_frac=final_frac)
    return torch.where(step_f < warmup_steps, warm, cos)
