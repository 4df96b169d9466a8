"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``),
evaluated in float32 on the host and returned as Python floats."""
from __future__ import annotations

import math

import numpy as np


def constant(value: float):
    return lambda step: float(np.float32(value))


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    f32 = np.float32

    def fn(step):
        step = f32(step)
        if step < warmup_steps:
            return float(f32(peak) * step / f32(max(warmup_steps, 1)))
        prog = np.clip((step - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(floor) + (f32(peak) - f32(floor)) * f32(0.5) \
            * (f32(1.0) + np.cos(f32(math.pi) * prog))
        return float(cos)

    return fn
