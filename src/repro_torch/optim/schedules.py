"""Learning-rate schedules (port of ``repro/optim/schedules.py``): plain
Python functions of the step, evaluated on the host once per step."""

from __future__ import annotations

import math


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int, floor: float = 0.1):
    """Warmup-Stable-Decay: linear warmup, flat, then exponential decay to
    ``floor * peak_lr`` over ``decay`` steps."""

    def lr(step) -> float:
        step = float(step)
        warm = peak_lr * min(step / max(warmup, 1), 1.0)
        frac = min(max(step - (warmup + stable), 0.0) / max(decay, 1), 1.0)
        return warm if step < warmup + stable else peak_lr * floor ** frac

    return lr


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor_frac: float = 0.1):
    """Linear warmup, then a cosine from ``peak_lr`` down to ``floor_frac`` of it."""

    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return peak_lr * min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (floor_frac + (1 - floor_frac) * 0.5 * (1 + math.cos(math.pi * prog)))

    return lr
