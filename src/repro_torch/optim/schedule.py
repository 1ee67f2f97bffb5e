"""LR schedules (multiplicative factors; compose with AdamWConfig.lr),
mirrors repro/optim/schedule.py."""
from __future__ import annotations

import math

import torch


def warmup_cosine(warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(1.0, float(warmup_steps))
        t = (step - warmup_steps) / max(1.0, float(total_steps - warmup_steps))
        t = torch.clamp(t, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return sched
