"""Learning-rate schedules (``repro/optim/schedules.py``): functions of
the step returning a 0-d fp32 tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, total_steps: int, warmup: int = 0,
                 final_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from ``lr`` to
    ``final_frac * lr`` at ``total_steps``, in fp32 as the reference."""
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return fn
