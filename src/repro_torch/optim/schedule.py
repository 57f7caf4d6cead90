"""LR schedules for the LM stack (the MC engine uses core.stepsize)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, base_lr=3e-4, warmup=100, total=1000,
                  min_ratio=0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``min_ratio * base_lr`` at ``total``.  ``step`` is
    a number or a 0-d tensor (kept on its device); returns a 0-d fp32
    tensor, in the reference's fp32 arithmetic."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(step < warmup, warm, cos)
