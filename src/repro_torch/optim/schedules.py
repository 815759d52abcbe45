"""Learning-rate schedules (``repro/optim/schedules.py``).  A schedule maps
an int step to a python float, computed in f32 arithmetic as the JAX
schedules compute it.  Ported so far: ``cosine`` (the schedule of every
ported arch)."""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def cosine(lr: float, total_steps: int, warmup_steps: int = 0,
           final_frac: float = 0.1) -> Schedule:
    def f(step: int) -> float:
        s = _f32(step)
        warm = (min(s / _f32(max(warmup_steps, 1)), _f32(1.0))
                if warmup_steps else _f32(1.0))
        t = np.clip((s - _f32(warmup_steps))
                    / _f32(max(total_steps - warmup_steps, 1)),
                    _f32(0.0), _f32(1.0))
        cos = _f32(final_frac) + _f32((1.0 - final_frac) * 0.5) * (
            _f32(1.0) + np.cos(_f32(np.pi) * t))
        return float(_f32(lr) * warm * cos)

    return f
