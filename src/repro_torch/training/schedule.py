"""LR schedules: plain functions of the step, in f32 as the reference
computes them (port of ``repro/training/schedule.py``).  ``step`` is an
int or a 0-d tensor; the rate is a 0-d float32 tensor on the step's
device (the CPU for an int)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = base_lr * step / max(1.0, warmup_steps)
        prog = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        prog = prog.clamp(0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(base_lr: float):
    def lr(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), base_lr, dtype=torch.float32, device=dev)
    return lr
