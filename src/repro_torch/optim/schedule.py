"""Learning-rate schedule: linear warmup + cosine decay, PyTorch port of
``repro.optim.schedule``.  The arithmetic runs in float32 on a 0-d
tensor, as ``jnp`` computes it (Python floats would round differently
in the last bits)."""
from __future__ import annotations

import math

import torch


def lr_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                total: int = 10_000, floor_frac: float = 0.1,
                device=None) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor) as a 0-d
    float32 tensor, on ``step``'s device (an int's: ``device``, default
    the CPU)."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.tensor(float(step), dtype=torch.float32, device=device)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
