"""Learning-rate schedules: pure functions of an int32 step tensor, ()
or (C,) (one step count a client), computed on the step's device, in
the JAX package's formulas."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def sched(step: torch.Tensor) -> torch.Tensor:
        return torch.full(step.shape, lr, dtype=torch.float32,
                          device=step.device)

    return sched


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def sched(step: torch.Tensor) -> torch.Tensor:
        t = step.clamp(max=total_steps).float() / max(total_steps, 1)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return sched


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup_steps, 1), final_frac)

    def sched(step: torch.Tensor) -> torch.Tensor:
        warm = lr * (step + 1).float() / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))

    return sched
