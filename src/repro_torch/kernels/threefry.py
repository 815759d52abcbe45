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

On a CPU device a wrapper runs the plain version; on a CUDA device it
launches the kernel or raises (in sanitize mode it runs the plain version
there too); on ``meta`` inside ``kernels.dry_run`` it allocates the draw.  ``LAUNCHES["threefry_uniform"]`` and
``LAUNCHES["threefry_rows"]`` count launches.
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
