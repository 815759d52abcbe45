"""The compressor zoo, ported member by member (``repro/core/compressors.py``).

Ported so far: :class:`BlockTopK` (the block-local top-k contraction of the
block-sparse path), :class:`QSGD` (the stochastic quantizer of the
bidirectional path), :class:`RandK` (the unbiased sparsifier of the DIANA
path) and :class:`Identity`.  ``make_compressor`` parses
their specs and refuses every other zoo member as not yet ported.

A compressor ``C(key, x)`` maps a tensor to a dense tensor of its shape
with the non-kept coordinates zeroed, and certifies (eta, omega) for
``theory.tune_for``.  ``key`` is a threefry key (``repro_torch.random``);
the deterministic members ignore it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels.ref import topk_rows

#: the zoo's spec names that the port does not have yet
NOT_PORTED = ("topk", "scaled_randk", "comp", "mix", "sign",
              "natural", "frac_topk", "frac_comp")


class Compressor:
    """Base class: frozen dataclasses with certified constants."""

    def eta(self, d: int) -> float:
        raise NotImplementedError

    def omega(self, d: int) -> float:
        raise NotImplementedError

    def omega_av(self, d: int, n: int) -> float:
        """Average relative variance of n independent copies (Sect. 2.4)."""
        return self.omega(d) / max(n, 1)

    def __call__(self, key, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def codec(self, shape: Tuple[int, ...]):
        raise NotImplementedError(
            f"the wire codec of {type(self).__name__} is not yet ported")


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    def eta(self, d):
        return 0.0

    def omega(self, d):
        return 0.0

    def __call__(self, key, x):
        return x


@dataclasses.dataclass(frozen=True)
class BlockTopK(Compressor):
    """Block-local top-k: each contiguous block of ``block`` values keeps
    its own ``kb`` largest |.|, ties to the lowest index.  Deterministic,
    in B(kb/block)."""

    block: int
    kb: int

    def eta(self, d):
        return math.sqrt(max(0.0, 1.0 - self.kb / self.block))

    def omega(self, d):
        return 0.0

    def __call__(self, key, x):
        xf = x.reshape(-1)
        d = xf.numel()
        pad = -d % self.block
        xp = torch.nn.functional.pad(xf, (0, pad)).reshape(-1, self.block)
        idx = topk_rows(xp.abs(), self.kb)
        mask = torch.zeros_like(xp).scatter(1, idx, 1.0)
        return (xp * mask).reshape(-1)[:d].reshape(x.shape)

    def codec(self, shape):
        from repro_torch.distributed import wire
        return wire.LeafWire(shape=tuple(shape), size=int(math.prod(shape)),
                             block=self.block, kb=self.kb)


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """QSGD stochastic quantization with s levels (Alistarh et al. 2017).

    Unbiased with omega = min(d/s^2, sqrt(d)/s)."""

    s: int

    def eta(self, d):
        return 0.0

    def omega(self, d):
        return min(d / self.s**2, math.sqrt(d) / self.s)

    def __call__(self, key, x):
        """The op chain of the JAX compressor, with the uniforms of
        ``jax.random.uniform(key, (d,))``.  The norm is torch's reduction,
        which may differ from XLA's in its last bits."""
        xf = x.reshape(-1)
        norm = torch.linalg.vector_norm(xf)
        safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))
        level = xf.abs() / safe_norm * self.s
        low = torch.floor(level)
        p = level - low
        up = random.uniform(key, xf.numel(), xf.device) < p
        q = (low + up.to(xf.dtype)) * float(np.float32(1.0 / self.s))
        out = torch.where(norm > 0, norm * torch.sign(xf) * q,
                          torch.zeros_like(q))
        return out.reshape(x.shape)

    def codec(self, shape):
        from repro_torch.distributed import wire
        return wire.QsgdQuant(shape=tuple(shape), size=int(math.prod(shape)),
                              s=self.s)


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Unbiased rand-k (Sect. 2.1): keeps k random coordinates scaled by
    d/k, in U(d/k - 1).  The k positions are
    ``jax.random.choice(key, d, (k,), replace=False)``
    (:func:`repro_torch.random.choice`)."""

    k: int

    def eta(self, d):
        return 0.0

    def omega(self, d):
        return d / self.k - 1.0

    def __call__(self, key, x):
        """``(xf * mask) * f32(d / k)``, the JAX compressor's op order."""
        xf = x.reshape(-1)
        d = xf.numel()
        idx = random.choice(key, d, self.k, xf.device)
        mask = torch.zeros_like(xf)
        mask[idx.long()] = 1.0
        return ((xf * mask) * float(np.float32(d / self.k))).reshape(x.shape)

    def codec(self, shape):
        from repro_torch.distributed import wire
        return wire.RandKSparse(shape=tuple(shape),
                                size=int(math.prod(shape)), k=self.k,
                                selector=self)

    def encode(self, key, x):
        """(values (k,) = x[idx] * f32(d / k), idx (k,) int32)."""
        xf = x.reshape(-1)
        d = xf.numel()
        idx = random.choice(key, d, self.k, xf.device)
        return xf[idx.long()] * float(np.float32(d / self.k)), idx


def make_compressor(spec: str) -> Compressor:
    """Parse 'name[:a[,b]]' into a Compressor."""
    name, _, args = spec.partition(":")
    argv = [int(a) for a in args.split(",") if a]
    if name in ("identity", "none"):
        return Identity()
    if name == "block_topk":
        return BlockTopK(*argv)
    if name == "qsgd":
        return QSGD(*argv)
    if name == "randk":
        return RandK(*argv)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not yet ported to repro_torch "
            "(ported: block_topk, qsgd, randk, identity)")
    raise ValueError(f"unknown compressor {name!r}")
