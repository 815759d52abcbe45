"""The C(eta, omega) compressor zoo (``repro/core/compressors.py``).

Every member of the JAX zoo: :class:`Identity`, :class:`TopK`,
:class:`RandK`, :class:`ScaledRandK`, :class:`CompKK`, :class:`MixKK`,
:class:`BlockTopK`, :class:`SignNorm`, :class:`Natural`, :class:`QSGD`,
:class:`FracTopK`, :class:`FracCompKK` and :class:`MNice`, with
``make_compressor``'s spec table, ``expand_fleet`` and ``make_fleet``; the
contract's ``scaled`` and ``bias_variance_estimate``
(``repro/core/contract.py``); and the spec grammar
(``repro/core/specgrammar.py``): ``parse_*`` / ``format_*`` of atoms,
fleets, leaf-codec rules, the downlink and the pipeline, with JAX's
spellings and error messages.

A compressor ``C(key, x)`` maps a tensor to a dense tensor of its shape
with the non-kept coordinates zeroed, and certifies (eta, omega) for
``theory.tune_for``.  Each family states its law once, as
``C.batch(keys, X)``: ``vmap(C)`` over a leading worker axis, every draw
of the n workers in one row draw and every selection one sort along the
rows (``random.*_rows``), so its launches do not grow with n.  One
worker's ``C(key, x)`` is row 0 of the one-row batch.  Only
:class:`SignNorm` and :class:`QSGD` keep a 1-D call beside ``batch``: a
row of an (n, d) norm may round its last bit otherwise than the 1-D norm
of JAX's unbatched call (fault c).  ``key`` is a threefry key (``repro_torch.random``,
bit for bit ``jax.random``); the deterministic members ignore it.  Each
op follows the JAX compressor's, so outputs match it bit for bit; top-k
selections take JAX's tie order (``kernels.ref.topk_rows``).  Where they
cannot: :class:`SignNorm` and :class:`QSGD` reduce in torch's order (a
sum or norm may differ from XLA's in its last bits, ROADMAP fault c), and
:class:`Natural` takes its exponents exactly, where XLA's f32 ``log2`` and
``exp2`` are not exact (fault j).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels.ref import topk_rows


def _f32(x: float) -> float:
    """x rounded to f32, as JAX rounds a weakly typed Python constant."""
    return float(np.float32(x))


def jsign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, +1, and x itself where x is +-0.0 or NaN
    (``torch.sign`` gives +0.0 for -0.0 and 0.0 for NaN)."""
    return torch.where((x == 0) | x.isnan(), x, torch.sign(x))


def _topk_idx(xf: torch.Tensor, k: int) -> torch.Tensor:
    """int64 positions of the k largest |xf|, descending, ties to the
    lowest position (``jax.lax.top_k``'s order)."""
    return topk_rows(xf.abs().reshape(1, -1), k)[0]


def _scatter_decode(payload, d: int) -> torch.Tensor:
    """(values, positions) -> zeros((d,)) with the values added at their
    positions (``zeros.at[idx].add(vals)``)."""
    vals, idx = payload
    out = torch.zeros(d, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.reshape(-1).long(), vals.reshape(-1))


def _flat_rows(X: torch.Tensor) -> torch.Tensor:
    """A worker-stacked (n, ...) tensor as (n, d) rows."""
    return X.reshape(X.shape[0], -1)


def _topk_rows_idx(Xf: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`_topk_idx` of every row of (n, d) ``Xf``: (n, k) int64."""
    return topk_rows(Xf.abs(), k)


def _mask_rows(Xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Zeros like (n, d) ``Xf`` with 1.0 at the (n, k) columns ``idx``
    (``zeros.at[idx].set(1.0)`` on every row)."""
    return torch.zeros_like(Xf).scatter_(1, idx.long(), 1.0)


def _flat_sparse_codec(compressor, shape, k: int, wire_dtype: str):
    from repro_torch.distributed import wire
    return wire.FlatSparse(shape=tuple(shape), size=int(math.prod(shape)),
                           k=k, selector=compressor, val_dtype=wire_dtype)


class Compressor:
    """Base class: frozen dataclasses with certified constants."""

    def eta(self, d: int) -> float:
        raise NotImplementedError

    def omega(self, d: int) -> float:
        raise NotImplementedError

    def alpha(self, d: int) -> float:
        """Contraction factor when in B(alpha); eq. (5)."""
        return 1.0 - self.eta(d) ** 2 - self.omega(d)

    def omega_av(self, d: int, n: int) -> float:
        """Average relative variance of n independent copies (Sect. 2.4)."""
        return self.omega(d) / max(n, 1)

    def __call__(self, key, x: torch.Tensor) -> torch.Tensor:
        """One worker's call: row 0 of :meth:`batch` on the one-row stack
        (``key`` None for a deterministic member).  Only :class:`SignNorm`
        and :class:`QSGD` keep a call of their own, with the 1-D norm of
        JAX's unbatched call (a row of a batched norm may round otherwise,
        fault c)."""
        keys = None if key is None else np.asarray(key, np.uint32)[None]
        return self.batch(keys, x[None])[0]

    def batch(self, keys, X: torch.Tensor) -> torch.Tensor:
        """``vmap(self)(keys, X)``: X is worker-stacked (n, ...), ``keys``
        the (n, 2) uint32 key array (None for a deterministic member); row
        i of the result equals ``self(keys[i], X[i])``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no batched call")

    def batch_parts(self, keys, X: torch.Tensor):
        """(y, c): :meth:`batch` is ``y * c`` for a compressor whose output
        ends in a product by the f32 constant c (rand-k's d/k, comp's
        k'/k), else (``batch(keys, X)``, None).  Jitted JAX folds c into
        the constant of a product that follows (fault u)."""
        return self.batch(keys, X), None

    def codec(self, shape: Tuple[int, ...], *, wire_dtype: str = "float32"):
        """The wire codec of one leaf, its values of ``wire_dtype``: the
        dense value stream unless the compressor declares its own layout.
        The quantized and bit-packed codecs (QSGD, sign, natural) ignore
        the dtype."""
        from repro_torch.distributed import wire
        return wire.DensePack(shape=tuple(shape),
                              size=int(math.prod(shape)), compressor=self,
                              val_dtype=wire_dtype)

    def encode(self, key, x: torch.Tensor):
        raise NotImplementedError(
            f"{type(self).__name__} has no sparse encoding")

    def decode(self, payload, d: int) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no sparse encoding")


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    def eta(self, d):
        return 0.0

    def omega(self, d):
        return 0.0

    def batch(self, keys, X):
        return X


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Deterministic top-k by magnitude (Sect. 2.2): in B(k/d)."""

    k: int

    def eta(self, d):
        return math.sqrt(max(0.0, 1.0 - self.k / d))

    def omega(self, d):
        return 0.0

    def batch(self, keys, X):
        Xf = _flat_rows(X)
        return (Xf * _mask_rows(Xf, _topk_rows_idx(Xf, self.k))).reshape(
            X.shape)

    def codec(self, shape, *, wire_dtype="float32"):
        return _flat_sparse_codec(self, shape, self.k, wire_dtype)

    def encode(self, key, x):
        """(values (k,), int32 positions (k,)), largest |x| first."""
        xf = x.reshape(-1)
        idx = _topk_idx(xf, self.k)
        return xf[idx], idx.to(torch.int32)

    def decode(self, payload, d):
        return _scatter_decode(payload, d)


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

    def batch(self, keys, X):
        """``(xf * mask) * f32(d / k)``, the JAX compressor's op order."""
        y, c = self.batch_parts(keys, X)
        return y * c

    def batch_parts(self, keys, X):
        Xf = _flat_rows(X)
        d = Xf.shape[1]
        idx = random.choice_rows(keys, d, self.k, X.device)
        return (Xf * _mask_rows(Xf, idx)).reshape(X.shape), _f32(d / self.k)

    def codec(self, shape, *, wire_dtype="float32"):
        from repro_torch.distributed import wire
        return wire.RandKSparse(shape=tuple(shape),
                                size=int(math.prod(shape)), k=self.k,
                                selector=self, val_dtype=wire_dtype)

    def encode(self, key, x):
        """(values (k,) = x[idx] * f32(d / k), idx (k,) int32)."""
        xf = x.reshape(-1)
        d = xf.numel()
        idx = random.choice(key, d, self.k, xf.device)
        return xf[idx.long()] * _f32(d / self.k), idx

    def decode(self, payload, d):
        return _scatter_decode(payload, d)


@dataclasses.dataclass(frozen=True)
class ScaledRandK(Compressor):
    """rand-k without the d/k blow-up (== (k/d) * RandK; Sect. 2.5): in
    B(k/d)."""

    k: int

    def eta(self, d):
        return 1.0 - self.k / d  # Prop. 1 with lam = k/d, eta0 = 0

    def omega(self, d):
        return (self.k / d) * (1.0 - self.k / d)

    def batch(self, keys, X):
        Xf = _flat_rows(X)
        idx = random.choice_rows(keys, Xf.shape[1], self.k, X.device)
        return (Xf * _mask_rows(Xf, idx)).reshape(X.shape)

    def codec(self, shape, *, wire_dtype="float32"):
        return _flat_sparse_codec(self, shape, self.k, wire_dtype)

    def encode(self, key, x):
        xf = x.reshape(-1)
        idx = random.choice(key, xf.numel(), self.k, xf.device)
        return xf[idx.long()], idx


@dataclasses.dataclass(frozen=True)
class CompKK(Compressor):
    """comp-(k, k') = rand-k o top-k' (Appendix A.2, Prop. 5): keeps k
    coordinates among the k' largest, scaled by k'/k.  Requires k <= k'.
    The compressor of the paper's experiments: biased and random, with an
    omega that can exceed 1."""

    k: int
    kp: int  # k'

    def __post_init__(self):
        assert self.k <= self.kp

    def eta(self, d):
        return math.sqrt((d - self.kp) / d)

    def omega(self, d):
        return (self.kp - self.k) / self.k

    def _keep(self, key, xf):
        """The k kept positions: ``top_k(|x|, k')[choice(key, k', k)]``."""
        top_idx = _topk_idx(xf, self.kp)
        sub = random.choice(key, self.kp, self.k, xf.device)
        return top_idx[sub.long()]

    def batch(self, keys, X):
        y, c = self.batch_parts(keys, X)
        return y * c

    def batch_parts(self, keys, X):
        """Every row's top k' by one sort along the rows, every row's k of
        them by one row shuffle (:func:`random.choice_rows`)."""
        Xf = _flat_rows(X)
        top_idx = _topk_rows_idx(Xf, self.kp)
        sub = random.choice_rows(keys, self.kp, self.k, X.device)
        keep = torch.gather(top_idx, 1, sub.long())
        return ((Xf * _mask_rows(Xf, keep)).reshape(X.shape),
                _f32(self.kp / self.k))

    def codec(self, shape, *, wire_dtype="float32"):
        return _flat_sparse_codec(self, shape, self.k, wire_dtype)

    def encode(self, key, x):
        xf = x.reshape(-1)
        keep = self._keep(key, xf)
        return xf[keep] * _f32(self.kp / self.k), keep.to(torch.int32)

    def decode(self, payload, d):
        return _scatter_decode(payload, d)


@dataclasses.dataclass(frozen=True)
class MixKK(Compressor):
    """mix-(k, k'): top-k plus k' uniformly random others (Appendix A.1,
    Prop. 4).  The k' others are the top k' of uniform scores
    (``jax.random.uniform``) with the top-k positions scored -1.  A uniform
    takes one of 2**23 values, so 2**16 draws hold about 256 equal pairs;
    equal scores go to the lowest position, as ``jax.lax.top_k`` orders
    them."""

    k: int
    kp: int  # k'

    def eta(self, d):
        assert self.k + self.kp <= d
        return (d - self.k - self.kp) / math.sqrt((d - self.k) * d)

    def omega(self, d):
        return self.kp * (d - self.k - self.kp) / ((d - self.k) * d)

    def _picks(self, key, xf):
        """(top-k positions, the k' random others), int64."""
        top_idx = _topk_idx(xf, self.k)
        scores = random.uniform(key, xf.numel(), xf.device)
        scores[top_idx] = -1.0  # exclude the already kept
        return top_idx, topk_rows(scores.reshape(1, -1), self.kp)[0]

    def batch(self, keys, X):
        Xf = _flat_rows(X)
        top_idx = _topk_rows_idx(Xf, self.k)
        scores = random.uniform_rows(keys, Xf.shape[1], X.device)
        scores.scatter_(1, top_idx, -1.0)
        rnd_idx = topk_rows(scores, self.kp)
        mask = _mask_rows(Xf, top_idx).scatter_(1, rnd_idx, 1.0)
        return (Xf * mask).reshape(X.shape)

    def codec(self, shape, *, wire_dtype="float32"):
        return _flat_sparse_codec(self, shape, self.k + self.kp, wire_dtype)

    def encode(self, key, x):
        """k top positions then k' random ones, disjoint by construction,
        so the codec's scatter-add reproduces the dense output exactly."""
        xf = x.reshape(-1)
        idx = torch.cat(self._picks(key, xf))
        return xf[idx], idx.to(torch.int32)


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

    def batch(self, keys, X):
        """Each block's top kb on the (n * nb, block) stack of every
        worker's zero-padded blocks."""
        Xf = _flat_rows(X)
        n, d = Xf.shape
        xp = torch.nn.functional.pad(Xf, (0, -d % self.block)).reshape(
            -1, self.block)
        idx = topk_rows(xp.abs(), self.kb)
        mask = torch.zeros_like(xp).scatter(1, idx, 1.0)
        return (xp * mask).reshape(n, -1)[:, :d].reshape(X.shape)

    def codec(self, shape, *, wire_dtype="float32"):
        from repro_torch.distributed import wire
        return wire.LeafWire(shape=tuple(shape), size=int(math.prod(shape)),
                             block=self.block, kb=self.kb,
                             val_dtype=wire_dtype)

    def encode(self, key, x):
        """Per-block (values, block-local indices), (nb, kb) each: the
        wire's layout spec (``wire.pack_oracle``)."""
        from repro_torch.distributed import wire
        return wire.pack_oracle(self.codec((x.numel(),)), x.reshape(-1))

    def decode(self, payload, d):
        """One message (nb, kb) or worker-stacked (n, nb, kb), summed."""
        from repro_torch.distributed import wire
        return wire.scatter_add(self.codec((d,)), *payload)


@dataclasses.dataclass(frozen=True)
class SignNorm(Compressor):
    """L1-norm-scaled sign: C(x) = (||x||_1 / d) * sgn(x), sgn(0) = +1;
    B(1/d) worst case.  The L1 sum is torch's reduction (fault c)."""

    def eta(self, d):
        return math.sqrt(max(0.0, 1.0 - 1.0 / d))

    def omega(self, d):
        return 0.0

    def __call__(self, key, x):
        """(sum|x| * f32(1/d)) * sgn(x): jitted XLA rewrites the division
        by the constant d into that product (differing from the quotient
        for d = 3, 5, 7, 1000 on a third of draws)."""
        xf = x.reshape(-1)
        scale = xf.abs().sum() * _f32(1.0 / xf.numel())
        sgn = torch.where(xf < 0, -1.0, 1.0)
        return (scale * sgn).reshape(x.shape)

    def batch(self, keys, X):
        """The L1 sums are one reduction along the rows (fault c: a row may
        round otherwise than its 1-D sum)."""
        Xf = _flat_rows(X)
        scale = Xf.abs().sum(dim=1, keepdim=True) * _f32(1.0 / Xf.shape[1])
        sgn = torch.where(Xf < 0, -1.0, 1.0)
        return (scale * sgn).reshape(X.shape)

    def codec(self, shape, *, wire_dtype="float32"):
        from repro_torch.distributed import wire
        return wire.SignPack(shape=tuple(shape), size=int(math.prod(shape)))


def floor_log2(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) of f32 a > 0 as f32, exactly (``torch.frexp``'s
    exponent minus one; +inf for +inf).  XLA's f32 ``log2`` is not exact
    near powers of two (ROADMAP fault j), so the JAX package's floor can
    be one off there."""
    e = (torch.frexp(a)[1] - 1).to(torch.float32)
    return torch.where(torch.isinf(a), a, e)


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """2**e of integer-valued f32 e, exactly: the f32 whose bits are that
    power of two (subnormals down to 2**-149, +0.0 below, +inf above 127
    and for +inf).  XLA's f32 ``exp2`` is not exact at every integer
    (fault j), and ``torch.ldexp`` multiplies by a ``pow`` whose exactness
    is the device's, so the bits are built."""
    ei = e.clamp(-150.0, 128.0).to(torch.int32)
    normal = ((ei + 127).clamp(1, 254) << 23).view(torch.float32)
    sub = (torch.ones_like(ei) << (ei + 149).clamp(0, 22)).view(
        torch.float32)
    out = torch.where(ei >= -126, normal, sub)
    out = torch.where(ei < -149, torch.zeros_like(out), out)
    return torch.where(ei > 127, torch.full_like(out, math.inf), out)


def natural_exponent(key, a: torch.Tensor, u=None) -> torch.Tensor:
    """The exponent natural compression rounds |x| = a to, as f32: e or
    e + 1 with e = floor(log2(a)) and P(e + 1) = a / 2**e - 1, under the
    uniforms of ``jax.random.uniform(key, (a.numel(),))`` (or the uniforms
    ``u`` shaped like a); a = 0 counts as 1 (the caller masks it)."""
    safe = torch.where(a > 0, a, 1.0)
    e = floor_log2(safe)
    if u is None:
        u = random.uniform(key, a.numel(), a.device)
    up = u < safe / exp2_int(e) - 1.0
    return e + up.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Natural(Compressor):
    """Natural compression (Horvath et al. 2019): stochastic rounding of the
    magnitude to a power of two.  Unbiased with omega = 1/8.  Exponents are
    exact (:func:`floor_log2`, :func:`exp2_int`), where the JAX package's
    come from XLA's inexact ``log2``/``exp2`` (fault j)."""

    def eta(self, d):
        return 0.0

    def omega(self, d):
        return 1.0 / 8.0

    def batch(self, keys, X):
        Xf = _flat_rows(X)
        a = Xf.abs()
        u = random.uniform_rows(keys, Xf.shape[1], X.device)
        mag = exp2_int(natural_exponent(None, a, u))
        return torch.where(a > 0, jsign(Xf) * mag, 0.0).reshape(X.shape)

    def codec(self, shape, *, wire_dtype="float32"):
        from repro_torch.distributed import wire
        return wire.NaturalPack(shape=tuple(shape),
                                size=int(math.prod(shape)))


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
        u = random.uniform(key, xf.numel(), xf.device)
        return self._quantize(xf, norm, u).reshape(x.shape)

    def batch(self, keys, X):
        """The norms are one reduction along the rows (fault c)."""
        Xf = _flat_rows(X)
        norm = torch.linalg.vector_norm(Xf, dim=1, keepdim=True)
        u = random.uniform_rows(keys, Xf.shape[1], X.device)
        return self._quantize(Xf, norm, u).reshape(X.shape)

    def _quantize(self, xf, norm, u):
        safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))
        level = xf.abs() / safe_norm * self.s
        low = torch.floor(level)
        p = level - low
        up = u < p
        q = (low + up.to(xf.dtype)) * _f32(1.0 / self.s)
        return torch.where(norm > 0, norm * jsign(xf) * q,
                           torch.zeros_like(q))

    def codec(self, shape, *, wire_dtype="float32"):
        from repro_torch.distributed import wire
        return wire.QsgdQuant(shape=tuple(shape), size=int(math.prod(shape)),
                              s=self.s)


@dataclasses.dataclass(frozen=True)
class FracTopK(Compressor):
    """top-k with k = max(1, round(frac * d)): size-adaptive, for per-leaf
    use on trees whose leaves differ in size."""

    frac: float

    def _k(self, d: int) -> int:
        return max(1, int(round(self.frac * d)))

    def eta(self, d):
        return math.sqrt(max(0.0, 1.0 - self._k(d) / d))

    def omega(self, d):
        return 0.0

    def batch(self, keys, X):
        return TopK(self._k(X[0].numel())).batch(keys, X)

    def codec(self, shape, *, wire_dtype="float32"):
        return _flat_sparse_codec(self, shape, self._k(int(math.prod(shape))),
                                  wire_dtype)

    def encode(self, key, x):
        return TopK(self._k(x.numel())).encode(key, x)

    def decode(self, payload, d):
        return _scatter_decode(payload, d)


@dataclasses.dataclass(frozen=True)
class FracCompKK(Compressor):
    """comp-(k, k') with k = frac * d, k' = fracp * d (size-adaptive
    :class:`CompKK`)."""

    frac: float
    fracp: float

    def _kk(self, d):
        k = max(1, int(round(self.frac * d)))
        kp = max(k, int(round(self.fracp * d)))
        return k, kp

    def eta(self, d):
        _, kp = self._kk(d)
        return math.sqrt((d - kp) / d)

    def omega(self, d):
        k, kp = self._kk(d)
        return (kp - k) / k

    def batch(self, keys, X):
        return CompKK(*self._kk(X[0].numel())).batch(keys, X)

    def batch_parts(self, keys, X):
        return CompKK(*self._kk(X[0].numel())).batch_parts(keys, X)

    def codec(self, shape, *, wire_dtype="float32"):
        return _flat_sparse_codec(self, shape,
                                  self._kk(int(math.prod(shape)))[0],
                                  wire_dtype)

    def encode(self, key, x):
        return CompKK(*self._kk(x.numel())).encode(key, x)

    def decode(self, payload, d):
        return _scatter_decode(payload, d)


@dataclasses.dataclass(frozen=True)
class MNice(Compressor):
    """m-nice sampling (Sect. 2.4): partial participation of m of n workers
    per round.  Jointly defined: every worker takes the SAME subset from the
    round key, so EF-BV calls ``joint_call(round_key, worker_idx, x)``.

    omega = (n - m) / m, omega_av = (n - m) / (m (n - 1)) (0 if n = 1)."""

    n: int
    m: int

    joint = True

    def eta(self, d):
        return 0.0

    def omega(self, d):
        return (self.n - self.m) / self.m

    def omega_av(self, d, n):
        if self.n == 1:
            return 0.0
        return (self.n - self.m) / (self.m * (self.n - 1))

    def members(self, round_key, device) -> torch.Tensor:
        """(n,) bool: worker i is among the first m of
        ``jax.random.permutation(round_key, n)`` (one draw, no host
        sync)."""
        member = random.permutation(round_key, self.n, device)[:self.m]
        keep = torch.zeros(self.n, dtype=torch.bool, device=device)
        return keep.index_fill_(0, member.long(), True)

    def _gate(self, keep, x):
        """(n/m) x where ``keep``, else zeros: ``jnp.where``."""
        return torch.where(keep, _f32(self.n / self.m) * x,
                           torch.zeros_like(x))

    def joint_call(self, round_key, worker_idx: int, x):
        """(n/m) x if worker ``worker_idx`` is among the first m of
        ``jax.random.permutation(round_key, n)``, else zeros."""
        return self._gate(self.members(round_key, x.device)[worker_idx], x)

    def joint_batch(self, round_key, X, keep=None):
        """Every worker's :meth:`joint_call` on the worker-stacked (n, ...)
        X: one permutation of the round key (or the given :meth:`members`
        mask) and a select along the worker axis."""
        if keep is None:
            keep = self.members(round_key, X.device)
        return self._gate(keep.reshape((-1,) + (1,) * (X.dim() - 1)), X)

    def batch(self, keys, X):
        """The marginal law of every worker, (n/m) x with probability m/n
        under ``jax.random.uniform(key, ())``: one row draw of one uniform
        a worker."""
        u = random.uniform_rows(keys, 1, X.device)[:, 0]
        keep = u < _f32(self.m / self.n)
        return self._gate(keep.reshape((-1,) + (1,) * (X.dim() - 1)), X)


def make_compressor(spec: str) -> Compressor:
    """Parse 'name[:a[,b]]' into a Compressor (the JAX package's table)."""
    name, _, args = spec.partition(":")
    argv = [int(a) for a in args.split(",") if a]
    table = {
        "identity": lambda: Identity(),
        "none": lambda: Identity(),
        "topk": lambda: TopK(*argv),
        "randk": lambda: RandK(*argv),
        "scaled_randk": lambda: ScaledRandK(*argv),
        "comp": lambda: CompKK(*argv),
        "mix": lambda: MixKK(*argv),
        "block_topk": lambda: BlockTopK(*argv),
        "sign": lambda: SignNorm(),
        "natural": lambda: Natural(),
        "qsgd": lambda: QSGD(*argv),
        # fraction-style specs use per-mille integers: "frac_topk:50" = 5%
        "frac_topk": lambda: FracTopK(argv[0] / 1000.0),
        "frac_comp": lambda: FracCompKK(argv[0] / 1000.0, argv[1] / 1000.0),
    }
    if name not in table:
        raise ValueError(f"unknown compressor {name!r}; "
                         f"known: {sorted(table)}")
    return table[name]()


def expand_fleet(members: Tuple[Compressor, ...], n: int
                 ) -> Tuple[Compressor, ...]:
    """Assign a fleet of compressors to n workers: a length-n list is kept
    as it is, a shorter one is expanded round-robin (worker i gets
    members[i % len(members)])."""
    if not members:
        raise ValueError("empty compressor fleet")
    if len(members) > n:
        raise ValueError(f"fleet of {len(members)} members for only {n} "
                         "workers")
    if any(getattr(c, "joint", False) for c in members):
        raise ValueError("jointly-defined compressors (m-nice) cannot be "
                         "fleet members: their draws couple all workers")
    return tuple(members[i % len(members)] for i in range(n))


def make_fleet(spec: str, n: int) -> Tuple[Compressor, ...]:
    """Parse a heterogeneous-fleet spec -- ';'-separated compressor specs,
    e.g. 'topk:64;randk:64;qsgd:16' -- and assign it to n workers
    (:func:`parse_fleet`)."""
    return parse_fleet(spec, n)


# ---------------------------------------------------------------------------
# the contract's helpers (repro/core/contract.py)
# ---------------------------------------------------------------------------

def scaled(c: Compressor, lam: float):
    """lam * C  (Prop. 1: eta' = lam*eta + 1 - lam, omega' = lam^2 omega)."""

    def apply(key, x):
        return lam * c(key, x)

    return apply


def bias_variance_estimate(c: Compressor, key, x: torch.Tensor,
                           n_samples: int = 256) -> Tuple[float, float]:
    """Monte-Carlo estimate of (||E C(x) - x|| / ||x||,
    E||C(x) - E C(x)||^2 / ||x||^2) at the point x, over the draws of
    ``split(key, n_samples)``."""
    ys = torch.stack([c(k, x) for k in random.split(key, n_samples)])
    mean = ys.mean(dim=0)
    nx2 = (x * x).sum()
    bias = torch.sqrt(((mean - x) ** 2).sum() / nx2)
    var = ((ys - mean) ** 2).sum(dim=-1).mean() / nx2
    return float(bias), float(var)


# ---------------------------------------------------------------------------
# the spec grammar (repro/core/specgrammar.py): one parser and printer for
# compressor atoms 'name[:a[,b]]', fleets 'a;b', leaf-codec rules
# 'pattern=atom;...', the downlink 'atom[@lam]' and the pipeline 'depth:k'
# ---------------------------------------------------------------------------

def parse_compressor(spec: str) -> Compressor:
    """The atom parser: :func:`make_compressor`."""
    return make_compressor(spec)


def _per_mille(frac: float) -> int:
    return int(round(frac * 1000.0))


def format_compressor(comp: Compressor) -> str:
    """Canonical atom spelling of a zoo compressor, the inverse of
    :func:`parse_compressor` ('none' prints as 'identity'); m-nice has no
    spelling and is refused."""
    if isinstance(comp, Identity):
        return "identity"
    if isinstance(comp, TopK):
        return f"topk:{comp.k}"
    if isinstance(comp, RandK):
        return f"randk:{comp.k}"
    if isinstance(comp, ScaledRandK):
        return f"scaled_randk:{comp.k}"
    if isinstance(comp, CompKK):
        return f"comp:{comp.k},{comp.kp}"
    if isinstance(comp, MixKK):
        return f"mix:{comp.k},{comp.kp}"
    if isinstance(comp, BlockTopK):
        return f"block_topk:{comp.block},{comp.kb}"
    if isinstance(comp, SignNorm):
        return "sign"
    if isinstance(comp, Natural):
        return "natural"
    if isinstance(comp, QSGD):
        return f"qsgd:{comp.s}"
    # fraction-style atoms spell per-mille integers ("frac_topk:50" = 5%)
    if isinstance(comp, FracCompKK):
        return f"frac_comp:{_per_mille(comp.frac)},{_per_mille(comp.fracp)}"
    if isinstance(comp, FracTopK):
        return f"frac_topk:{_per_mille(comp.frac)}"
    raise ValueError(f"compressor {comp!r} has no spec-string spelling")


def parse_fleet(spec: str, n: int) -> Tuple[Compressor, ...]:
    """';'-separated atoms -> length-n worker fleet (round-robin when the
    list is shorter than n, explicit when exactly n)."""
    members = tuple(make_compressor(s.strip())
                    for s in spec.split(";") if s.strip())
    return expand_fleet(members, n)


def format_fleet(members) -> str:
    """Canonical fleet spelling: ``parse_fleet(format_fleet(f), len(f))
    == f``."""
    return ";".join(format_compressor(c) for c in members)


def parse_leaf_rules(spec: str) -> Tuple[Tuple[str, Compressor], ...]:
    """';'-separated ``pattern=compressor_spec`` entries -> (pattern,
    Compressor) rules, first match wins; a bare atom is the catch-all rule
    '*'.  Jointly-defined compressors (m-nice) are refused."""
    rules = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" in entry:
            pat, _, comp_spec = entry.partition("=")
            pat, comp_spec = pat.strip(), comp_spec.strip()
            if not pat or not comp_spec:
                raise ValueError(
                    f"leaf-codec rule {entry!r} needs both a leaf-path "
                    "pattern and a compressor spec around the '='")
        else:
            pat, comp_spec = "*", entry
        comp = make_compressor(comp_spec)
        if getattr(comp, "joint", False):
            raise ValueError(
                "jointly-defined compressors (m-nice) cannot be leaf-codec "
                "rules: their draws couple all workers")
        rules.append((pat, comp))
    return tuple(rules)


def format_leaf_rules(rules) -> str:
    """Canonical rule spelling, every pattern explicit (incl. '*')."""
    return ";".join(f"{pat}={format_compressor(c)}" for pat, c in rules)


def parse_downlink(spec: str):
    """'' | 'none' -> None (dense broadcast); otherwise an atom with an
    optional '@lam' downlink scaling -> (compressor, lam)."""
    if not spec or spec == "none":
        return None
    comp_spec, _, lam_s = spec.partition("@")
    return make_compressor(comp_spec), float(lam_s) if lam_s else 1.0


def format_downlink(downlink) -> str:
    """Canonical spelling of None, a (compressor, lam) pair or a Downlink;
    the default scaling 1.0 is omitted."""
    if downlink is None:
        return "none"
    if isinstance(downlink, tuple):
        comp, lam = downlink
    else:
        comp, lam = downlink.compressor, downlink.lam
    atom = format_compressor(comp)
    return atom if lam == 1.0 else f"{atom}@{lam!r}"


def parse_pipeline(spec: str) -> int:
    """'' | 'off' | 'depth:k' -> the depth k (the Pipeline dataclass
    enforces the implemented range)."""
    if not spec or spec == "off":
        return 0
    name, _, arg = spec.partition(":")
    if name == "depth" and arg:
        try:
            return int(arg)
        except ValueError:
            raise ValueError(f"pipeline spec {spec!r} (want off | "
                             "depth:0 | depth:1)") from None
    raise ValueError(f"pipeline spec {spec!r} (want off | depth:0 | "
                     "depth:1)")


def format_pipeline(pipeline) -> str:
    """Canonical spelling of an int depth or a Pipeline: 0 is 'off'."""
    depth = pipeline if isinstance(pipeline, int) else pipeline.depth
    return "off" if depth == 0 else f"depth:{depth}"
