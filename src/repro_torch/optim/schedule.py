"""LR schedules (step -> lr), in float32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``final_frac``
    of it at ``total_steps``, held after.  ``step`` is a host int or a
    0-d tensor; returns a 0-d float32 tensor on the step's device (the
    CPU for an int), each operation rounded to float32 as in
    ``repro.optim.schedule`` (the cosine itself may differ by an ulp)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    # cos correctly rounded (float64, then float32): XLA's float32 cos
    # is within an ulp of it, torch's float32 cos further off
    c = torch.cos((math.pi * t).to(torch.float64)).to(torch.float32)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + c))
    return torch.where(step < warmup_steps, warm, cos)
