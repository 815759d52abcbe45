"""Learning-rate schedules (``repro/optim/schedules.py``).  A schedule maps
an int step to a python float: the f32 value that ``jax.jit(schedule)``
gives, which is the lr of JAX's jitted optimizer step (its ``update`` calls
the schedule inside the trace).  Includes WSD (warmup-stable-decay) from
MiniCPM [arXiv:2404.06395], the minicpm-2b config's schedule.

Under ``jit`` XLA rewrites JAX's arithmetic, so the eager values differ in
the last ulps: a division by a constant becomes a product by its f32
reciprocal (:func:`_recip`), LLVM fuses a product into the add that
follows it (:func:`_fma`), and ``cos`` and ``pow`` are the C library's
``cosf`` and ``powf`` (``random.xla_cos``, ``random.xla_pow``).  Each
formula below is the fused computation of XLA's dump (``--xla_dump_to``:
the HLO after optimisation and the object code), step by step."""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.random import xla_cos, xla_pow

Schedule = Callable[[int], float]
_f32 = np.float32


def _recip(n: int) -> np.float32:
    """f32(1 / n): XLA multiplies by it where JAX divides by n."""
    return _f32(1.0) / _f32(n)


def _warm(s: np.float32, warmup_steps: int) -> np.float32:
    """min(s / max(warmup, 1), 1), the division a product by the
    reciprocal."""
    return min(s * _recip(max(warmup_steps, 1)), _f32(1.0))


def _clip01(x: np.float32) -> np.float32:
    return min(max(x, _f32(0.0)), _f32(1.0))


def _fma(a, b, c) -> np.float32:
    """f32(a * b + c) of f32 scalars, rounded once (``random.fma``'s
    method): the product is exact in f64, and the f64 sum rounds to the
    right f32 unless it fell on a midpoint between two f32 values, where
    its error (TwoSum) says which way the exact sum lies."""
    p, c = np.float64(a) * np.float64(b), np.float64(c)
    s = p + c
    if int(s.view(np.int64)) & 0x1FFFFFFF == 0x10000000:
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        if err:
            s = np.nextafter(s, np.inf if err > 0 else -np.inf)
    return _f32(s)


def constant(lr: float) -> Schedule:
    return lambda step: float(_f32(lr))


def linear_warmup(lr: float, warmup_steps: int) -> Schedule:
    def f(step: int) -> float:
        return float(_warm(_f32(step), warmup_steps) * _f32(lr))

    return f


def cosine(lr: float, total_steps: int, warmup_steps: int = 0,
           final_frac: float = 0.1) -> Schedule:
    """lr * warm * (ff + (1 - ff) / 2 * (1 + cos(pi t))); under jit the
    last multiply-add is one FMA, (1 + cos) * f32((1 - ff) / 2) + f32(ff),
    and ``lr * warm`` is rounded before the product (lr alone without a
    warmup)."""
    def f(step: int) -> float:
        s = _f32(step)
        t = _clip01((s - _f32(warmup_steps))
                    * _recip(max(total_steps - warmup_steps, 1)))
        c = xla_cos(_f32(np.pi) * t) + _f32(1.0)
        cos = _fma(c, _f32((1.0 - final_frac) * 0.5), _f32(final_frac))
        head = _warm(s, warmup_steps) * _f32(lr) if warmup_steps \
            else _f32(lr)
        return float(head * cos)

    return f


def wsd(lr: float, warmup_steps: int, stable_steps: int, decay_steps: int,
        final_frac: float = 0.01) -> Schedule:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat plateau, then an
    exponential-style decay ``final_frac ** t`` over the last
    ``decay_steps`` (``powf``), as (lr * warm) * decay."""

    def f(step: int) -> float:
        s = _f32(step)
        t = _clip01((s - _f32(warmup_steps) - _f32(stable_steps))
                    * _recip(max(decay_steps, 1)))
        decay = xla_pow(_f32(final_frac), t)
        return float(_warm(s, warmup_steps) * _f32(lr) * decay)

    return f
