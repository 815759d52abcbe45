"""Learning-rate schedules (``repro/optim/schedules.py``).  A schedule maps
an int step to a python float, computed in f32 arithmetic as the JAX
schedules compute it.  Includes WSD (warmup-stable-decay) from MiniCPM
[arXiv:2404.06395], the minicpm-2b config's schedule."""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: float(_f32(lr))


def linear_warmup(lr: float, warmup_steps: int) -> Schedule:
    def f(step: int) -> float:
        w = min(_f32(step) / _f32(max(warmup_steps, 1)), _f32(1.0))
        return float(_f32(lr) * w)

    return f


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


def wsd(lr: float, warmup_steps: int, stable_steps: int, decay_steps: int,
        final_frac: float = 0.01) -> Schedule:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat plateau, then an
    exponential-style decay ``final_frac ** t`` over the last
    ``decay_steps``."""

    def f(step: int) -> float:
        s = _f32(step)
        warm = min(s / _f32(max(warmup_steps, 1)), _f32(1.0))
        t = np.clip((s - _f32(warmup_steps) - _f32(stable_steps))
                    / _f32(max(decay_steps, 1)), _f32(0.0), _f32(1.0))
        return float(_f32(lr) * warm * _f32(final_frac) ** t)

    return f
