"""LR schedules: ``fn(step) -> f32 scalar tensor``."""
import math

import torch


def constant_schedule(lr):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(peak, total_steps, warmup=0, floor=0.0):
    def fn(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn
