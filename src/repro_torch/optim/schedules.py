"""Learning-rate schedules (port of ``repro/optim/schedules.py``): callables
``step -> lr``, computed in float32 as the reference computes them."""

from __future__ import annotations

import numpy as np

__all__ = ["linear_warmup", "cosine_schedule"]

_f = np.float32


def linear_warmup(base_lr: float, warmup_steps: int):
    def lr(step):
        frac = np.minimum(_f(step) / _f(max(1, warmup_steps)), _f(1.0))
        return _f(base_lr) * frac

    return lr


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        s = _f(step)
        warm = np.minimum(s / _f(max(1, warmup_steps)), _f(1.0))
        progress = np.clip((s - _f(warmup_steps)) / _f(max(1, total_steps - warmup_steps)),
                           _f(0.0), _f(1.0))
        cos = _f(min_frac) + _f(1 - min_frac) * _f(0.5) * (_f(1) + np.cos(_f(np.pi) * progress))
        return _f(base_lr) * warm * cos

    return lr
