"""Counter-based threefry2x32 random numbers, bit for bit those of
``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable=True``, 64-bit
types off).

Keys are host-side pairs of uint32, held as a numpy ``(2,) uint32`` array;
deriving them (``key``, ``fold_in``, ``split``) never touches a device.
Draws are counter-based: element i of a draw of n is a function of the key
and i alone,

    (y0, y1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)),  bits_i = y0 ^ y1

so ``bits`` and ``uniform`` run one thread per element on the card
(``kernels/threefry.py``, CUDA) and a plain int64 version on the CPU.
``uniform`` turns the bits into floats in [0, 1) as ``jax.random.uniform``
does: ``bits >> 9 | 0x3F800000`` read as f32, minus 1.0; a range
[minval, maxval) scales them with one fused multiply-add, as XLA contracts
``floats * (maxval - minval) + minval`` inside JAX's jitted ``_uniform``.
``randint`` is JAX's two-draw modulus (bit for bit); ``normal`` is
sqrt(2) * erfinv of the exact uniform on (nextafter(-1, 0), 1), as JAX
computes it, with XLA CPU's own f32 ``erf_inv`` (:func:`erf_inv`: Giles'
polynomial over XLA's ``log1p`` and ``log``, each multiply-add fused as
XLA's compiled code fuses it), so it too is bit for bit.  XLA CPU's f32
``exp``, ``expm1`` and ``log`` (:func:`xla_exp`, :func:`xla_expm1`,
:func:`xla_log`) are emulated the same way, for the inits that compute
with them (mamba2's ``dt_bias`` and ``A_log``); its f32 ``cos`` and ``pow``
(:func:`xla_cos`, :func:`xla_pow`: the C library's ``cosf`` and ``powf``,
which XLA calls) for the learning-rate schedules.

``permutation`` and ``choice(replace=False)`` are ``jax.random``'s shuffle
by repeated sorts (``jax/_src/random.py`` ``_shuffle``): each round splits
the key, draws one 32-bit sort key per position and reorders the values by
a stable sort of those keys as unsigned integers.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rounds(x0, x1, k0, k1, add, rotl):
    """The 20 rounds and 6 key injections of threefry2x32 on any integer
    type, given its wrapping ``add`` and 32-bit ``rotl``."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0, x1 = add(x0, ks[0]), add(x1, ks[1])
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def threefry2x32(key, x0, x1):
    """threefry2x32 of uint32 numpy counters (x0, x1) under ``key``: one
    (2,) key, or an (..., 2) array of keys broadcast against the
    counters (key row i with counter i, or every key with every counter
    when their shapes say so)."""
    key = np.asarray(key, np.uint32)
    k0 = key[..., 0].astype(np.uint64)
    k1 = key[..., 1].astype(np.uint64)
    x0 = np.asarray(x0, np.uint64)
    x1 = np.asarray(x1, np.uint64)
    mask = np.uint64(MASK32)
    with np.errstate(over="ignore"):
        y0, y1 = _rounds(
            x0, x1, k0, k1,
            lambda a, b: (a + np.asarray(b, np.uint64)) & mask,
            lambda a, r: ((a << np.uint64(r)) | (a >> np.uint64(32 - r)))
            & mask)
    return y0.astype(np.uint32), y1.astype(np.uint32)


def _threefry_int(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """threefry2x32 of one counter pair in Python ints: the same rounds as
    :func:`threefry2x32`, for the single counter of ``fold_in``."""
    return _rounds(x0, x1, k0, k1, lambda a, b: (a + b) & MASK32,
                   lambda a, r: ((a << r) | (a >> (32 - r))) & MASK32)


def key(seed: int) -> np.ndarray:
    """The raw threefry key of an integer seed, as ``jax.random.key``
    builds it with 64-bit types off: the seed is cut to its low 32 bits."""
    return np.array([0, int(seed) & MASK32], np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry2x32(k, (0, data)) as the new key.
    ``k`` is one (2,) key, or an (n, 2) array of keys, each folded with the
    same ``data`` (``vmap(fold_in)``), in one vectorised pass."""
    k = np.asarray(k, np.uint32)
    if k.ndim > 1:
        y0, y1 = threefry2x32(k, np.uint32(0), np.uint32(int(data) & MASK32))
        return np.stack([y0, y1], axis=-1)
    k0, k1 = (int(v) for v in k)
    return np.array(_threefry_int(k0, k1, 0, int(data) & MASK32), np.uint32)


def split(k, n: int = 2) -> np.ndarray:
    """``jax.random.split`` (fold-like under partitionable threefry): key i
    is threefry2x32(k, (0, i)).  Returns (n, 2) uint32; for an (r, 2) array
    of keys, (r, n, 2) with row i the split of ``k[i]``
    (``vmap(split)``)."""
    k = np.asarray(k, np.uint32)
    if k.ndim > 1:
        k = k[..., None, :]
    y0, y1 = threefry2x32(k, np.zeros(n, np.uint32), np.arange(n))
    return np.stack([y0, y1], axis=-1)


def bits_plain(k, n: int, device) -> torch.Tensor:
    """The (n,) 32-bit draws of ``jax.random.bits(k, (n,))`` in torch int64
    ops on ``device``, returned as int32 holding the same bits.  Torch has
    no uint32 arithmetic on the CPU, so every add and shift is followed by
    ``& 0xFFFFFFFF``."""
    k0, k1 = (int(v) for v in np.asarray(k, np.uint32))
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _rounds(
        i >> 32, i & MASK32, k0, k1,
        lambda a, b: (a + b) & MASK32,
        lambda a, r: ((a << r) | (a >> (32 - r))) & MASK32)
    return _as_int32(y0 ^ y1)


def bits_rows_plain(keys: torch.Tensor, m: int) -> torch.Tensor:
    """(n, m) draws, row i ``bits(keys[i], m)``, in torch int64 ops on the
    device of the (n, 2) int32 key tensor ``keys`` (each key's two words
    broadcast along its row), returned as int32 holding the same bits."""
    k = keys.to(torch.int64) & MASK32
    k0, k1 = k[:, :1], k[:, 1:]
    c = torch.arange(m, dtype=torch.int64, device=keys.device)
    y0, y1 = _rounds(
        c >> 32, c & MASK32, k0, k1,
        lambda a, b: (a + b) & MASK32,
        lambda a, r: ((a << r) | (a >> (32 - r))) & MASK32)
    return _as_int32(y0 ^ y1)


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from int32 draws, as ``jax.random.uniform``: the top 23
    bits become the mantissa of a float in [1, 2), minus 1.0 (exact)."""
    mant = (bits.to(torch.int64) & MASK32) >> 9
    return (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def bits(k, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.bits(k, (n,))`` (uint32) as an int32 tensor with the same
    bits: the threefry kernel on a CUDA device (the default; raises without
    a GPU), the plain version when the caller asks for the CPU."""
    from repro_torch import resolve_device
    from repro_torch.kernels import threefry
    return threefry.threefry_fill(k, n, resolve_device(device),
                                  as_float=False)


def uniform(k, n: int, device="cuda", *, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, (n,), minval=, maxval=)``: (n,) f32, bit for
    bit, on ``device`` as :func:`bits`.  Off the default [0, 1) range the
    floats are ``max(minval, fma(floats, maxval - minval, minval))`` with
    both ends rounded to f32 first (two roundings differed from JAX on
    175,018 of 2**20 draws on [-1.5, 1.5), the fused form on none)."""
    from repro_torch import resolve_device
    from repro_torch.kernels import threefry
    u = threefry.threefry_fill(k, n, resolve_device(device), as_float=True)
    if (minval, maxval) == (0.0, 1.0):
        return u
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.add(torch.full_like(u, lo), u, alpha=span).clamp_(min=lo)


def randint(k, n: int, minval: int, maxval: int,
            device="cuda") -> torch.Tensor:
    """``jax.random.randint(k, (n,), minval, maxval)`` (int32), bit for bit:
    two 32-bit draws under ``split(k)``, ``(hi % span) * (2**32 % span) +
    lo % span`` taken mod span in uint32 arithmetic (held in int64 here),
    plus minval; span = 1 when maxval <= minval."""
    lim = 2**31
    if not (-lim <= minval < lim and -lim <= maxval < lim):
        raise ValueError(f"randint bounds ({minval}, {maxval}) outside int32")
    k1, k2 = split(k)
    hi = bits(k1, n, device).to(torch.int64) & MASK32
    lo = bits(k2, n, device).to(torch.int64) & MASK32
    span = maxval - minval if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & MASK32) % span
    off = (((hi % span) * mult + lo % span) & MASK32) % span
    return (off + minval).to(torch.int32)


#: sqrt(2) rounded to f32, the factor of ``jax.random.normal``
_SQRT2 = float(np.float32(np.sqrt(2)))


def _f32(bits_hex: str) -> float:
    """An f32 constant from the hex of its double, as LLVM IR prints it."""
    return float(np.frombuffer(bytes.fromhex(bits_hex)[::-1], np.float64)[0])


# The constants of XLA CPU's compiled ``erf_inv`` (jax 0.9.0), read from its
# LLVM IR: the Cephes polynomial of its f32 ``log``, the rational
# approximation of its ``log1p`` below |x| = sqrt(2) - 1, and Giles'
# coefficients of ``ErfInv32`` for w < 5 and w >= 5 (highest degree first).
_LOG_P = tuple(map(_f32, (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")))
_LOG_Q1, _LOG_Q2 = _f32("BF2BD01060000000"), _f32("3FE6300000000000")
_LOG_SQRTHF = _f32("3FE6A09E60000000")
_LOG1P_DEN = tuple(map(_f32, (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")))
_LOG1P_NUM = tuple(map(_f32, (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")))
_LOG1P_SMALL = _f32("3FDA8279A0000000")
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
#: values an ``erf_inv`` pass takes at a time (its f64 temporaries)
_ERFINV_CHUNK = 1 << 22


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add, round(a * b + c) once, on any device, for
    results in f32's normal range: the product is exact in f64 and the sum
    is rounded to f64, whose rounding to f32 is then the correct one unless
    the f64 sum fell exactly on a midpoint between two f32 values (its low
    29 mantissa bits 1 followed by zeros); there, and only there, the
    error of the f64 sum (TwoSum) says which way the exact value lies."""
    p = a.double() * b
    s = p + c
    out = s.float()
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool(mid.any()):
        pm, sm = p.expand_as(s)[mid], s[mid]
        cm = torch.as_tensor(c, dtype=torch.float64,
                             device=s.device).expand_as(s)[mid]
        bb = sm - pm
        err = (pm - (sm - bb)) + (cm - bb)
        inf = torch.full_like(sm, float("inf"))
        toward = torch.nextafter(sm, torch.where(err > 0, inf, -inf))
        out[mid] = torch.where(err != 0, toward, sm).float()
    return out


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt (torch's CPU sqrt is not, on 0.7% of
    values): through f64, where one rounding to f32 is exact."""
    return torch.sqrt(x.double()).float()


def xla_log(y: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 ``log``: split y into a mantissa in [sqrt(1/2),
    sqrt(2)) and an exponent e, then the Cephes polynomial in Estrin form
    and e * ln 2 in two parts, fused as its compiled code fuses them."""
    tiny = float(np.finfo(np.float32).tiny)
    bits = torch.clamp(y, min=tiny).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _LOG_SQRTHF
    e = ((bits >> 23) - 127).float() + 1.0 - small.float()
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z = x * x
    x3 = z * x
    a = fma(fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[2])
    b = fma(fma(x, _LOG_P[3], _LOG_P[4]), x, _LOG_P[5])
    c = fma(fma(x, _LOG_P[6], _LOG_P[7]), x, _LOG_P[8])
    r = (x - z * 0.5) + fma(fma(fma(a, x3, b), x3, c), x3, e * _LOG_Q1)
    r = r + e * _LOG_Q2
    r = torch.where((y < 0) | torch.isnan(y), torch.full_like(r, float("nan")),
                    r)
    r = torch.where(y == 0, torch.full_like(r, -float("inf")), r)
    return torch.where(torch.isposinf(y), y, r)


# The constants of XLA CPU's compiled f32 ``exp`` and ``expm1`` (jax 0.9.0),
# read from their LLVM IR: the input clamp, log2(e), the Cephes polynomial
# of ``expf`` (highest degree first, then 0.5), and the rational
# approximation of ``tanh`` that ``expm1`` runs below |x| = 0.5 (its clamp,
# numerator and denominator, highest degree first).
_EXP_LO, _EXP_HI = _f32("C055F33340000000"), _f32("4056333340000000")
_LOG2E = _f32("3FF7154760000000")
_EXP_P = tuple(map(_f32, (
    "3F2A0D2CE0000000", "3F56E879C0000000", "3F81112100000000",
    "3FA5553820000000", "3FC5555540000000"))) + (0.5,)
_TINY = float(np.finfo(np.float32).tiny)
_TANH_CLAMP = _f32("401FFEC880000000")
_TANH_SMALL = _f32("3F3A36E2E0000000")
_TANH_NUM = tuple(map(_f32, (
    "BCB3E4B800000000", "3D4C266FC0000000", "BDD7A6FFE0000000",
    "3E6B800820000000", "3EEF286940000000", "3F44E1BDA0000000",
    "3F740B3B80000000")))
_TANH_DEN = tuple(map(_f32, (
    "3EB41A7B00000000", "3F1F12BAC0000000", "3F629540A0000000",
    "3F740B3BA0000000")))


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 division on any device: through f64, where one
    rounding to f32 is exact (53 >= 2 * 24 + 2 bits)."""
    return (a.double() / b.double()).float()


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 ``exp`` (Cephes ``expf``): x clamped to [-87.8, 88.7],
    n = floor(x log2(e) + 1/2) clamped to [-127, 127], r = x - n ln 2 in
    two parts, 1 + r + r^2 p(r), times 2^n built from its bits; every
    multiply-add that LLVM fuses is one FMA (``fma``); a subnormal result
    is flushed to zero."""
    xc = torch.where(x < _EXP_LO, torch.full_like(x, _EXP_LO), x)
    xc = torch.where(xc > _EXP_HI, torch.full_like(x, _EXP_HI), xc)
    n = torch.floor(fma(xc, _LOG2E, 0.5)).clamp_(-127.0, 127.0)
    r = fma(-n, _LOG_Q2, xc)
    r = fma(-n, _LOG_Q1, r)
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fma(p, r, c)
    y = fma(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    # XLA's CPU code runs with subnormals flushed to zero
    return torch.where(out < _TINY, torch.zeros_like(out), out)


def xla_expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 ``expm1``: ``exp(x) - 1`` above |x| = 0.5, else
    ``tanh(x / 2) * (exp(x) + 1)`` with XLA's rational ``tanh`` (the
    argument itself below 4e-4, +-1 from 20 up); x where x / 2 is zero."""
    e = xla_exp(x)
    h = x * 0.5
    ah = h.abs()
    hc = torch.clamp(h, -_TANH_CLAMP, _TANH_CLAMP)
    h2 = hc * hc
    p = fma(h2, _TANH_NUM[0], _TANH_NUM[1])
    for c in _TANH_NUM[2:]:
        p = fma(h2, p, c)
    q = fma(h2, _TANH_DEN[0], _TANH_DEN[1])
    for c in _TANH_DEN[2:]:
        q = fma(h2, q, c)
    t = _div(hc * p, q)
    t = torch.where(ah < _TANH_SMALL, h, t)
    t = torch.where(ah >= 20.0, torch.copysign(torch.ones_like(h), h), t)
    out = torch.where(x.abs() > 0.5, e - 1.0, t * (e + 1.0))
    return torch.where(h == 0, x, out)


def _xla_log1p(t: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 ``log1p``: a rational approximation for |t| below
    sqrt(2) - 1, else ``log(1 + t)``."""
    t2 = t * t
    den = t + _LOG1P_DEN[0]
    for d in _LOG1P_DEN[1:]:
        den = fma(den, t, d)
    num = fma(torch.full_like(t, _LOG1P_NUM[0]), t, _LOG1P_NUM[1])
    for c in _LOG1P_NUM[2:]:
        num = fma(num, t, c)
    q = _div(num, den)
    near = t + fma(t2, -0.5, (t * t2) * q)
    return torch.where(t.abs() < _LOG1P_SMALL, near, xla_log(1.0 + t))


def erf_inv(x: torch.Tensor, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """XLA CPU's f32 ``erf_inv`` (``jax.lax.erf_inv`` jitted), bit for bit:
    w = -log1p(-x * x); Giles' degree-8 polynomial in w - 2.5 (w < 5) or
    sqrt(w) - 3, each step one fused multiply-add; times x; +-inf at
    |x| = 1.  Runs in chunks of :data:`_ERFINV_CHUNK` values, into ``out``
    (which may be ``x``) when given."""
    flat = x.reshape(-1)
    out = torch.empty_like(flat) if out is None else out.reshape(-1)
    for i in range(0, flat.numel(), _ERFINV_CHUNK):
        xs = flat[i:i + _ERFINV_CHUNK]
        lw = _xla_log1p(xs * -xs)
        lt = lw > -5.0
        w = torch.where(lt, -2.5 - lw, _sqrt(-lw) - 3.0)

        def coef(j):
            return torch.where(lt, torch.full_like(xs, _ERFINV_LT5[j]),
                               torch.full_like(xs, _ERFINV_GE5[j]))
        p = coef(0)
        for j in range(1, 9):
            p = fma(p, w, coef(j))
        p = torch.where(xs.abs() == 1.0, torch.full_like(p, float("inf")),
                        p)
        out[i:i + _ERFINV_CHUNK] = xs * p
    return out.reshape(x.shape)


# XLA CPU compiles an f32 ``cos`` or ``pow`` to a call of the C library's
# ``cosf`` or ``powf`` (``llvm.cos.f32`` and ``llvm.pow.f32`` in its LLVM IR,
# calls of the symbols in its object code, jax 0.9.0 on x86-64): glibc
# 2.36's, in the build it picks on a CPU with FMA and AVX2, which evaluates
# in f64 with fused multiply-adds.  The tables and the order of the fused
# steps below are read from that build's object code (libm.so.6).

#: glibc's ``__sincosf_table``: per row (the second for quadrants 2 and 3)
#: c0..c4 of the cos polynomial, then s1..s3 of the sin polynomial
_SINCOSF = tuple(tuple(map(float.fromhex, row)) for row in (
    ("0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
     "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16",
     "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
     "-0x1.994eb3774cf24p-13"),
    ("-0x1p+0", "0x1.ffffffd0c621cp-2", "-0x1.55553e1068f19p-5",
     "0x1.6c087e89a359dp-10", "-0x1.99343027bf8c3p-16",
     "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
     "-0x1.994eb3774cf24p-13")))
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")   # 2 / pi * 2**24
_HPI = float.fromhex("0x1.921fb54442d18p+0")        # pi / 2
_PI63 = float.fromhex("0x1.921fb54442d18p-62")      # pi / 2**63
#: glibc's ``__inv_pio4``: 4 / pi in a sliding window of 32 bits a byte
_INV_PIO4 = bytes.fromhex("a2f9836e4e441529fc2757d1f534ddc0db6295993c439041")
#: glibc's ``__powf_log2_data``: (1/c, log2 c) of 16 subintervals, then the
#: log2(1 + r) polynomial
_POWF_LOG2 = tuple((float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010bp+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8eap+0", "-0x1.97c1d1b3b7afp-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1p+0", "0x0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aap-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POWF_POLY = tuple(map(float.fromhex, (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")))
#: glibc's ``__exp2f_data``: the bits of 2**(i/32) less i << 47, the shift
#: that rounds to a multiple of 1/32, and the 2**r polynomial
_EXP2F_TAB = (
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F,
    0x3FEF9301D0125B51, 0x3FEF72B83C7D517B, 0x3FEF54873168B9AA,
    0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1, 0x3FEF06FE0A31B715,
    0x3FEEF1A7373AA9CB, 0x3FEEDEA64C123422, 0x3FEECE086061892D,
    0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429,
    0x3FEEA47EB03A5585, 0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74,
    0x3FEEA11473EB0187, 0x3FEEA589994CCE13, 0x3FEEACE5422AA0DB,
    0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D,
    0x3FEEE89F995AD3AD, 0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C,
    0x3FEF3720DCEF9069, 0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F,
    0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")
_EXP2F_POLY = tuple(map(float.fromhex, (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")))


def _two_sum(a: np.ndarray, b: np.ndarray):
    """(a + b rounded, its error), exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split64(a: np.ndarray):
    """a as hi + lo, each of at most 26 significant bits (Veltkamp)."""
    t = a * 134217729.0
    hi = t - (t - a)
    return hi, a - hi


def _fma64(a: np.ndarray, b, c) -> np.ndarray:
    """f64 fused multiply-add, round(a * b + c) once, for values far from
    f64's overflow and underflow (Boldo and Melquiond's emulation): the
    product exact as a pair (Dekker), its sum with c exact as a pair, the
    two low parts added rounding to odd, then one rounding to nearest."""
    b = np.broadcast_to(np.asarray(b, np.float64), a.shape)
    c = np.broadcast_to(np.asarray(c, np.float64), a.shape)
    p = a * b
    ah, al = _split64(a)
    bh, bl = _split64(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, err = _two_sum(tl, e)
    odd = (v.view(np.uint64) & np.uint64(1)) == 1
    toward = np.nextafter(v, np.where(err > 0, np.inf, -np.inf))
    return th + np.where((err != 0) & ~odd, toward, v)


def _sincosf_poly(x: np.ndarray, q: np.ndarray, row: np.ndarray
                  ) -> np.ndarray:
    """glibc's ``sinf_poly`` for ``cosf`` on x, the remainder of quadrant q
    times the quadrant's sign: the cos polynomial in x**2 where q is even,
    the sin polynomial of x where q is odd, with the constants of table
    row ``row``; each step fused as its FMA build fuses it."""
    out = np.empty_like(x)
    tab = np.asarray(_SINCOSF)[row]
    x2 = x * x
    ev = (q & 1) == 0
    if ev.any():
        c0, c1, c2, c3, c4 = (tab[ev, j] for j in range(5))
        y2 = x2[ev]
        y4 = y2 * y2
        out[ev] = _fma64(_fma64(y2, c4, c3), y2 * y4,
                         _fma64(y4, c2, _fma64(y2, c1, c0)))
    od = ~ev
    if od.any():
        s1, s2, s3 = (tab[od, j] for j in range(5, 8))
        y2, xs = x2[od], x[od]
        x3 = y2 * xs
        out[od] = _fma64(_fma64(y2, s3, s2), y2 * x3, _fma64(x3, s1, xs))
    return out


def _quadrant_sign(q: np.ndarray) -> np.ndarray:
    """glibc's ``sign[q & 3]``: +1, -1, -1, +1."""
    return np.where(((q ^ (q >> 1)) & 1) == 1, -1.0, 1.0)


def xla_cos(x) -> np.ndarray:
    """XLA CPU's f32 ``cos``, glibc 2.36's ``cosf`` (FMA build), on an f32
    array, in numpy: 1 below 2**-12; the cos polynomial below about 0.75;
    up to 120, x - n pi / 2 by one FMA, n the nearest quadrant; beyond,
    the quadrant and remainder from 4 / pi in fixed point
    (``reduce_large``); then the sin or cos polynomial of the remainder, in
    f64, rounded once to f32; NaN for inf and NaN."""
    x = np.asarray(x, np.float32)
    xi = x.view(np.uint32).astype(np.uint64)
    top = (xi >> np.uint64(20)) & np.uint64(0x7FF)
    out = np.full(x.shape, np.nan)
    out[top < 0x398] = 1.0
    with np.errstate(all="ignore"):
        m = (top >= 0x398) & (top < 0x3F4)
        if m.any():
            xd = x[m].astype(np.float64)
            out[m] = _sincosf_poly(xd, np.zeros(xd.shape, np.int64),
                                   np.zeros(xd.shape, np.int64))
        m = (top >= 0x3F4) & (top < 0x42F)
        if m.any():
            # up to 120: n = round(x * 2 / pi), r = fma(-n, pi / 2, x)
            xd = x[m].astype(np.float64)
            n = (np.trunc(xd * _HPI_INV).astype(np.int64) + 0x800000) >> 24
            r = _fma64(-n.astype(np.float64), _HPI, xd)
            out[m] = _sincosf_poly(r * _quadrant_sign(n), n,
                                   (n & 2) >> 1)
        m = (top >= 0x42F) & (top <= 0x7F7)
        if m.any():
            # beyond 120: 62 fraction bits of x * 4 / pi, by three 32-bit
            # products with windows of glibc's __inv_pio4
            u = np.uint64
            win = np.array([int.from_bytes(_INV_PIO4[max(0, i - 3):i + 1],
                                           "big") for i in range(24)], u)
            xm = xi[m]
            j = (xm >> u(26)) & u(15)
            mant = ((xm & u(0x7FFFFF)) | u(0x800000)) << ((xm >> u(23))
                                                          & u(7))
            res0 = (mant * win[j]) & u(MASK32)
            res1 = mant * win[j + u(4)]
            res2 = mant * win[j + u(8)]
            res0 = ((res2 >> u(32)) | (res0 << u(32))) + res1
            q = (res0 + u(1 << 61)) >> u(62)
            res0 = res0 - (q << u(62))
            rl = res0.view(np.int64).astype(np.float64) * _PI63
            q = q.astype(np.int64)
            qs = q + (xm >> u(31)).astype(np.int64)
            out[m] = _sincosf_poly(rl * _quadrant_sign(qs), q,
                                   (qs & 2) >> 1)
    return out.astype(np.float32)


def xla_pow(x, y) -> np.ndarray:
    """XLA CPU's f32 ``pow``, glibc 2.36's ``powf`` (FMA build), on f32
    arrays, in numpy, for x positive and normal (or 0) and y finite:
    log2(x) from a 16-entry table and a degree-5 polynomial, times y, then
    2**(y log2 x) from a 32-entry table and a cubic, all in f64, rounded
    once to f32; pow(x, 0) = 1, pow(0, y) = 0 for y > 0.  Raises outside
    that domain, and where |y log2 x| >= 126 (glibc's overflow and
    underflow paths)."""
    x, y = np.broadcast_arrays(np.asarray(x, np.float32),
                               np.asarray(y, np.float32))
    ix = x.view(np.uint32).astype(np.int64)
    if ((ix != 0) & ((ix < 0x800000) | (ix >= 0x7F800000))).any() \
            or not np.isfinite(y).all() or ((ix == 0) & (y < 0)).any():
        raise ValueError("xla_pow: x must be 0 or positive and normal, y "
                         "finite (and y >= 0 where x = 0)")
    with np.errstate(all="ignore"):
        # log2 x = k + log2 c + log2(z / c), z in [0.7, 1.4), c the centre
        # of z's subinterval
        tmp = (ix - 0x3F330000) & MASK32
        top = tmp & 0xFF800000
        k = ((top >> 23) ^ 0x100) - 0x100   # int32's arithmetic shift
        z = ((ix - top) & MASK32).astype(np.uint32).view(np.float32)
        tab = np.asarray(_POWF_LOG2)[(tmp >> 19) & 15]
        a = _POWF_POLY
        r = _fma64(z.astype(np.float64), tab[..., 0], -1.0)
        r2 = r * r
        q = _fma64(r2, _fma64(r, a[2], a[3]),
                   _fma64(r, a[4], k + tab[..., 1]))
        logx = _fma64(_fma64(r, a[0], a[1]), r2 * r2, q)
        ylogx = y * logx
        big = ((ylogx.view(np.uint64) >> np.uint64(47)) & np.uint64(0xFFFF)
               ) >= 0x80BF
        if (big & (ix != 0) & (y != 0)).any():
            raise ValueError("xla_pow: |y log2 x| >= 126 (glibc's overflow "
                             "and underflow paths are not emulated)")
        # 2**ylogx = 2**(i/32) * 2**rr, i the nearest multiple of 1/32
        kd = ylogx + _EXP2F_SHIFT
        ki = kd.view(np.uint64)
        rr = ylogx - (kd - _EXP2F_SHIFT)
        s = (np.array(_EXP2F_TAB, np.uint64)[ki & np.uint64(31)]
             + (ki << np.uint64(47))).view(np.float64)
        c = _EXP2F_POLY
        out = np.array(_fma64(_fma64(rr, c[0], c[1]), rr * rr,
                              _fma64(rr, c[2], 1.0)) * s, np.float32)
    out[ix == 0] = 0.0
    out[y == 0] = 1.0
    return out


@contextlib.contextmanager
def _serial(device: torch.device):
    """One intra-op thread while the CPU runs the plain versions' hundreds
    of elementwise ops: beside other busy processes, OpenMP's barriers cost
    far more than the work (a smoke model's init took 35 s on 8 threads
    next to 5 busy processes, 1.5 s on one).  No effect on the card."""
    if device.type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def normal_many(keys, sizes, device="cuda") -> torch.Tensor:
    """``jax.random.normal(keys[i], (sizes[i],))`` for every i, bit for bit,
    concatenated into one flat f32 tensor: one uniform draw per key, then
    one :func:`erf_inv` pass over them all (many small draws, such as a
    model's init, cost one pass)."""
    dev = torch.device(device)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    with _serial(dev):
        u = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        off = 0
        for k, n in zip(keys, sizes):
            u[off:off + n] = uniform(k, n, device, minval=lo)
            off += n
        return erf_inv(u, out=u).mul_(_SQRT2)


def normal(k, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.normal(k, (n,))``, bit for bit: sqrt(2) * erf_inv(u),
    u uniform on (nextafter(-1, 0), 1) (JAX's u), with XLA's f32
    :func:`erf_inv`.  A draw of shape s is this draw of prod(s) values
    reshaped (threefry's counters run over the flat index)."""
    return normal_many([k], [n], device)


def bernoulli(k, p: float, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.bernoulli(k, p, (n,))``: (n,) bool, ``uniform(k, n) <
    p`` with p rounded to f32 first, as JAX converts it to the uniforms'
    dtype."""
    return uniform(k, n, device) < float(np.float32(p))


#: XOR with the sign bit maps the uint32 order of 32 bits onto int32 order
_UINT32_ORDER = -2**31


def shuffle_rounds(n: int) -> int:
    """Sort rounds of ``jax.random``'s shuffle of n values, computed as JAX
    computes it (numpy float64): 0 for n = 1, 1 up to n = 1625, 2 up to
    n = 2,642,245, then 3."""
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def permutation(k, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.permutation(k, n)``: a (n,) int32 permutation of
    ``arange(n)``, bit for bit.  Each of the :func:`shuffle_rounds` rounds
    does ``k, sub = split(k)``, draws ``bits(sub, n)`` (the threefry kernel
    on the card) and reorders x by a stable sort of the draws as uint32,
    as ``lax.sort_key_val`` sorts them; equal draws keep their order."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    x = torch.arange(n, dtype=torch.int32, device=dev)
    for _ in range(shuffle_rounds(n)):
        k, sub = split(k)
        keys = bits(sub, n, dev).bitwise_xor_(_UINT32_ORDER)
        order = torch.sort(keys, stable=True).indices
        del keys
        x = x[order]
    return x


def choice(k, n: int, m: int, device="cuda") -> torch.Tensor:
    """``jax.random.choice(k, n, shape=(m,), replace=False)``: the first m
    values of :func:`permutation`, as (m,) int32 (a copy, so the
    permutation's memory is freed)."""
    if m > n:
        raise ValueError(f"cannot take a larger sample ({m}) than the "
                         f"population ({n}) without replacement")
    return permutation(k, n, device)[:m].clone()


# ---------------------------------------------------------------------------
# many keys at once: the draws of ``vmap`` over a worker axis
# ---------------------------------------------------------------------------

def key_tensor(keys, device) -> torch.Tensor:
    """An (n, 2) uint32 key array as an (n, 2) int32 tensor holding the same
    bits on ``device``: the one host-to-device copy of a batched draw
    (staged through pinned memory and not waited for on the card: the
    caching host allocator keeps the staging buffer until the copy is
    done)."""
    t = torch.from_numpy(np.ascontiguousarray(
        np.asarray(keys, np.uint32).reshape(-1, 2)).view(np.int32))
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _rows(keys_t: torch.Tensor, m: int, as_float: bool) -> torch.Tensor:
    from repro_torch.kernels import threefry
    return threefry.threefry_rows(keys_t, m, as_float)


def bits_rows(keys, m: int, device="cuda") -> torch.Tensor:
    """``vmap(lambda k: jax.random.bits(k, (m,)))(keys)`` for an (n, 2)
    key array: (n, m) int32 with row i equal to ``bits(keys[i], m)``, in
    one launch of the row draw kernel on the card (the plain version on
    the CPU) and one copy of the keys, whatever n is."""
    from repro_torch import resolve_device
    return _rows(key_tensor(keys, resolve_device(device)), m, False)


def uniform_rows(keys, m: int, device="cuda") -> torch.Tensor:
    """(n, m) f32 with row i equal to ``uniform(keys[i], m)``, as
    :func:`bits_rows`."""
    from repro_torch import resolve_device
    return _rows(key_tensor(keys, resolve_device(device)), m, True)


def randint_rows(keys, m: int, minval: int, maxval: int,
                 device="cuda") -> torch.Tensor:
    """(n, m) int32 with row i equal to ``randint(keys[i], m, minval,
    maxval)``: both halves of every key's split drawn in one launch (rows
    0..n-1 the high words, n..2n-1 the low)."""
    lim = 2**31
    if not (-lim <= minval < lim and -lim <= maxval < lim):
        raise ValueError(f"randint bounds ({minval}, {maxval}) outside int32")
    pair = split(np.asarray(keys, np.uint32).reshape(-1, 2))
    n = pair.shape[0]
    both = bits_rows(np.concatenate([pair[:, 0], pair[:, 1]]), m,
                     device).to(torch.int64) & MASK32
    hi, lo = both[:n], both[n:]
    span = maxval - minval if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & MASK32) % span
    off = (((hi % span) * mult + lo % span) & MASK32) % span
    return (off + minval).to(torch.int32)


def stable_order(sort_keys: torch.Tensor) -> torch.Tensor:
    """int64 order of a stable ascending sort of each row of the (n, m)
    int32 ``sort_keys`` read as uint32 (``lax.sort_key_val`` along the last
    axis): equal keys keep their column order, on the CPU and the card."""
    flipped = sort_keys.bitwise_xor(_UINT32_ORDER)
    return torch.sort(flipped, dim=1, stable=True).indices


def shuffle_by_sorts(keys_t: torch.Tensor, n: int, m: int, k: int,
                     draw) -> torch.Tensor:
    """The row shuffle as rounds of sorts: x = ``arange(m)`` on every row,
    then for round r, ``draw(keys_t[r n:(r + 1) n], m, False)`` (n rows of
    words), their :func:`stable_order` and ``torch.gather`` of x; the
    first k columns.  ``draw`` is the row draw's wrapper or its plain
    version."""
    rounds = keys_t.shape[0] // n if n else 0
    x = torch.arange(m, dtype=torch.int32, device=keys_t.device).repeat(n, 1)
    for r in range(rounds):
        x = torch.gather(x, 1, stable_order(
            draw(keys_t[r * n:(r + 1) * n], m, False)))
    return x if k == m else x[:, :k].contiguous()


def _shuffle(keys_t: torch.Tensor, n: int, m: int, k: int) -> torch.Tensor:
    from repro_torch.kernels import threefry
    return threefry.shuffle_rows(keys_t, n, m, k)


def _shuffle_keys(keys, m: int, dev) -> Tuple[torch.Tensor, int]:
    """Every round's subkeys of a row shuffle of m values under the (n, 2)
    keys, derived on the host (``k, sub = split(k)`` for all rows at once)
    and copied to ``dev`` in one go, round-major; and n."""
    k = np.asarray(keys, np.uint32).reshape(-1, 2)
    n = k.shape[0]
    subs = []
    for _ in range(shuffle_rounds(m)):
        pair = split(k)
        k = pair[:, 0]
        subs.append(pair[:, 1])
    if not subs:
        return torch.empty((0, 2), dtype=torch.int32, device=dev), n
    return key_tensor(np.concatenate(subs), dev), n


def permutation_rows(keys, m: int, device="cuda") -> torch.Tensor:
    """``vmap(lambda k: jax.random.permutation(k, m))(keys)``: (n, m) int32,
    row i equal to ``permutation(keys[i], m)``.  Every round's subkeys are
    copied in one go; the shuffle is one launch of the row-shuffle kernel
    on the card (``threefry.shuffle_rows``: every round; wider rows than
    its plan takes, a row draw and a stable sort a round), its plain
    version on the CPU."""
    return choice_rows(keys, m, m, device)


def choice_rows(keys, m: int, k: int, device="cuda") -> torch.Tensor:
    """(n, k) int32, row i equal to ``choice(keys[i], m, k)``: the first k
    columns of :func:`permutation_rows`, the only ones the shuffle
    writes."""
    if k > m:
        raise ValueError(f"cannot take a larger sample ({k}) than the "
                         f"population ({m}) without replacement")
    from repro_torch import resolve_device
    sub_t, n = _shuffle_keys(keys, m, resolve_device(device))
    return _shuffle(sub_t, n, m, k)
