"""LR schedules on tensors (mirrors ``repro/optim/schedule.py``): linear
warm-up then cosine decay to a floor, and a constant."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, peak_lr: float, warmup: int,
                  total: int, floor_frac: float = 0.1) -> torch.Tensor:
    """The f32 learning rate at ``step`` (a tensor): ``peak_lr · step /
    warmup`` before ``warmup``, then a cosine from ``peak_lr`` down to
    ``floor_frac · peak_lr`` at ``total``, and that floor after."""
    step = step.to(torch.float32)
    warm = peak_lr * step / max(1, warmup)
    t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def constant(step: torch.Tensor, lr: float) -> torch.Tensor:
    return torch.full_like(step, lr, dtype=torch.float32)
