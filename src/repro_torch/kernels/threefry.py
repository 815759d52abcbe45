"""Threefry2x32 draw kernel wrappers: (n,) counter-based random words or
f32 uniforms under a key, or (n, m) of them under n keys (row i under key
i, as ``vmap`` over a worker axis draws them), bit for bit those of
``jax.random``.

Not the port of a TPU kernel: the JAX package draws its QSGD uniforms with
``jax.random.uniform`` (XLA), and the port draws them here, on the card,
with the CUDA kernel ``csrc/threefry.cu`` (one thread per element; the row draw
``threefry_rows_kernel`` reads each row's key from device memory).  The
plain versions (``ref.threefry_ref``, ``ref.threefry_rows_ref``) need
about 170 int64 elementwise passes per draw.

The row shuffle (:func:`shuffle_rows`, ``threefry_shuffle_rows_kernel``)
is ``random.permutation_rows`` and ``choice_rows`` in one launch: every
sort round of JAX's shuffle under n keys and the cut to k columns, the
row in shared memory (plain version ``ref.shuffle_rows_ref``: the row
draw, ``random.stable_order`` and ``torch.gather`` a round).

On a CPU device a wrapper runs the plain version; on a CUDA device it
launches the kernel or raises (in sanitize mode it runs the plain version
there too); on ``meta`` inside ``kernels.dry_run`` it allocates the draw.  ``LAUNCHES["threefry_uniform"]``,
``LAUNCHES["threefry_rows"]`` and ``LAUNCHES["shuffle_rows"]`` count
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import (LAUNCHES, build, check_device,
                                 plain_route, ref)


def threefry_fill(key, n: int, device: torch.device,
                  as_float: bool) -> torch.Tensor:
    """(n,) draws under the (2,) uint32 ``key`` on ``device``: f32 uniforms
    in [0, 1) when ``as_float``, else the 32-bit words as int32."""
    n = int(n)
    if n < 0:
        raise ValueError(f"draw of {n} elements")
    if plain_route(device):
        return ref.threefry_ref(key, n, device, as_float)
    check_device("threefry", device)
    k0, k1 = (int(v) for v in np.asarray(key, np.uint32))
    out = torch.empty(n, dtype=torch.float32 if as_float else torch.int32,
                      device=device)
    if n == 0 or device.type == "meta":
        return out
    err = build.launch(build.load("threefry").threefry_fill, out.device,
                       k0, k1, out.data_ptr(), n, int(as_float))
    if err != 0:
        raise RuntimeError(f"threefry launch failed: cudaError {err}")
    LAUNCHES["threefry_uniform"] += 1
    return out


def threefry_rows(keys: torch.Tensor, m: int, as_float: bool
                  ) -> torch.Tensor:
    """(n, m) draws on the device of the (n, 2) int32 key tensor ``keys``:
    element (i, c) is threefry2x32(keys[i], (0, c)), the words as int32 or,
    when ``as_float``, f32 uniforms in [0, 1)."""
    m = int(m)
    if not 0 <= m < 2**31:
        raise ValueError(f"row draw of {m} elements")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (n, 2) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    device = keys.device
    if plain_route(device):
        return ref.threefry_rows_ref(keys, m, as_float)
    check_device("threefry", device)
    keys = keys.contiguous()
    n = keys.shape[0]
    out = torch.empty((n, m), dtype=torch.float32 if as_float
                      else torch.int32, device=device)
    if n == 0 or m == 0 or device.type == "meta":
        return out
    err = build.launch(build.load("threefry").threefry_rows, device,
                       keys.data_ptr(), n, m, out.data_ptr(), int(as_float))
    if err != 0:
        raise RuntimeError(f"threefry_rows launch failed: cudaError {err}")
    LAUNCHES["threefry_rows"] += 1
    return out


#: the widest row the fused shuffle sorts in shared memory (8 B of sort key
#: a slot over the next power of two, 4 B of x a column: 196,608 B at
#: 16384, of the 232,448 B an H100 block may hold; 16385 pads to 32768
#: slots, 262,148 B).  The route's one owner: the C launcher checks only
#: that a row fits the card's shared memory, and refuses it otherwise
SHUFFLE_MAX_M = 16384


def shuffle_plan(m: int) -> str:
    """How :func:`shuffle_rows` runs a shuffle of rows of m values on the
    card, by m alone: ``"fused"`` (one launch of the row-shuffle kernel)
    up to :data:`SHUFFLE_MAX_M`, ``"sorts"`` above (a round of row draw,
    ``random.stable_order`` and ``torch.gather``, as before the kernel)."""
    return "fused" if m <= SHUFFLE_MAX_M else "sorts"


def shuffle_rows(keys: torch.Tensor, n: int, m: int, k: int
                 ) -> torch.Tensor:
    """(n, k) int32 on the device of ``keys``: row i is the first k values
    of JAX's shuffle of ``arange(m)`` by rounds of stable sorts of threefry
    words, round r under ``keys[r * n + i]`` (``keys``: the (rounds * n,
    2) int32 subkeys of every round, rounds = ``keys.shape[0] // n``).
    On the card the route is :func:`shuffle_plan`'s: ``"fused"`` launches
    the row-shuffle kernel once whatever the rounds (counted in
    ``LAUNCHES["shuffle_rows"]``), ``"sorts"`` launches the row draw a
    round (``LAUNCHES["threefry_rows"]``) around torch's sort; a refused
    launch raises."""
    n, m, k = int(n), int(m), int(k)
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (rounds * n, 2) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if not (0 <= k <= m < 2**31 and n >= 0):
        raise ValueError(f"shuffle of (n, m) = ({n}, {m}) cut to {k}")
    rounds = keys.shape[0] // n if n else 0
    if keys.shape[0] != rounds * n:
        raise ValueError(f"{keys.shape[0]} keys for {n} rows")
    device = keys.device
    if plain_route(device):
        return ref.shuffle_rows_ref(keys, n, m, k)
    check_device("shuffle_rows", device)
    if shuffle_plan(m) == "sorts":
        from repro_torch import random
        return random.shuffle_by_sorts(keys, n, m, k, threefry_rows)
    keys = keys.contiguous()
    out = torch.empty((n, k), dtype=torch.int32, device=device)
    if n == 0 or k == 0 or device.type == "meta":
        return out
    err = build.launch(build.load("threefry").threefry_shuffle_rows,
                       device, keys.data_ptr(), n, m, k, rounds,
                       out.data_ptr())
    if err != 0:
        raise RuntimeError(f"shuffle_rows launch failed: cudaError {err}")
    LAUNCHES["shuffle_rows"] += 1
    return out
