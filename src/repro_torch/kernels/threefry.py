"""Threefry2x32 draw kernel wrapper: (n,) counter-based random words or
f32 uniforms under a key, bit for bit those of ``jax.random``.

Not the port of a TPU kernel: the JAX package draws its QSGD uniforms with
``jax.random.uniform`` (XLA), and the port draws them here, on the card,
with the CUDA kernel ``csrc/threefry.cu`` (one thread per element).  The
plain version (``ref.threefry_ref``) needs about 170 int64 elementwise
passes per draw.

On a CPU device the wrapper runs the plain version; on a CUDA device it
launches the kernel or raises.  ``LAUNCHES["threefry_uniform"]`` counts
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, ref


def threefry_fill(key, n: int, device: torch.device,
                  as_float: bool) -> torch.Tensor:
    """(n,) draws under the (2,) uint32 ``key`` on ``device``: f32 uniforms
    in [0, 1) when ``as_float``, else the 32-bit words as int32."""
    n = int(n)
    if n < 0:
        raise ValueError(f"draw of {n} elements")
    if device.type == "cpu":
        return ref.threefry_ref(key, n, device, as_float)
    if device.type != "cuda":
        raise ValueError(f"threefry runs on cpu or cuda, not {device}")
    from repro_torch.kernels import build

    k0, k1 = (int(v) for v in np.asarray(key, np.uint32))
    out = torch.empty(n, dtype=torch.float32 if as_float else torch.int32,
                      device=device)
    if n == 0:
        return out
    fn = build.load("threefry").threefry_fill
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(k0, k1, out.data_ptr(), n, int(as_float), stream)
    if err != 0:
        raise RuntimeError(f"threefry launch failed: cudaError {err}")
    LAUNCHES["threefry_uniform"] += 1
    return out
