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
does: ``bits >> 9 | 0x3F800000`` read as f32, minus 1.0.

``permutation`` and ``choice(replace=False)`` are ``jax.random``'s shuffle
by repeated sorts (``jax/_src/random.py`` ``_shuffle``): each round splits
the key, draws one 32-bit sort key per position and reorders the values by
a stable sort of those keys as unsigned integers.
"""

from __future__ import annotations

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
    """threefry2x32 of uint32 numpy counters (x0, x1) under ``key``."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32))
    x0 = np.asarray(x0, np.uint64)
    x1 = np.asarray(x1, np.uint64)
    with np.errstate(over="ignore"):
        y0, y1 = _rounds(
            x0, x1, np.uint64(k0), np.uint64(k1),
            lambda a, b: (a + np.uint64(b)) & np.uint64(MASK32),
            lambda a, r: ((a << np.uint64(r)) | (a >> np.uint64(32 - r)))
            & np.uint64(MASK32))
    return y0.astype(np.uint32), y1.astype(np.uint32)


def key(seed: int) -> np.ndarray:
    """The raw threefry key of an integer seed, as ``jax.random.key``
    builds it with 64-bit types off: the seed is cut to its low 32 bits."""
    return np.array([0, int(seed) & MASK32], np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry2x32(k, (0, data)) as the new key."""
    y0, y1 = threefry2x32(k, [0], [int(data) & MASK32])
    return np.array([y0[0], y1[0]], np.uint32)


def split(k, n: int = 2) -> np.ndarray:
    """``jax.random.split`` (fold-like under partitionable threefry): key i
    is threefry2x32(k, (0, i)).  Returns (n, 2) uint32."""
    y0, y1 = threefry2x32(k, np.zeros(n, np.uint32), np.arange(n))
    return np.stack([y0, y1], axis=1)


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


def uniform(k, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.uniform(k, (n,))``: (n,) f32 in [0, 1), bit for bit, on
    ``device`` as :func:`bits`."""
    from repro_torch import resolve_device
    from repro_torch.kernels import threefry
    return threefry.threefry_fill(k, n, resolve_device(device),
                                  as_float=True)


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
