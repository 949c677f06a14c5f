"""LR schedules as functions of the step (counterpart of
``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(
    step, *, peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` then cosine decay to ``final_frac*peak``,
    as a 0-dim fp32 tensor computed in the reference's fp32 order."""
    step = torch.as_tensor(step, dtype=torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731 (a true division by it)
    warm = peak_lr * step / f32(max(warmup_steps, 1))
    prog = torch.clamp((step - warmup_steps) / f32(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    floor = final_frac * peak_lr
    cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)
