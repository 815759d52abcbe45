"""Fused compress-and-pack kernel wrapper (block-top-k + h update).

Port of ``repro/kernels/pack.py::pack_update_pallas``: one pass over
(g, h) rows emitting the (values, block-local indices) payload and
h_out = h + lam * d, with the dense compressed d never in device memory.
The kernel is CUDA C++ for Hopper (``csrc/pack_update.cu``).

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref

#: block sizes the CUDA kernel is instantiated for (one warp per row,
#: BLOCK / 32 values per lane)
CUDA_BLOCKS = (128, 256, 512, 1024)

#: kernel launches per wrapper, incremented only where a kernel launches
LAUNCHES: Dict[str, int] = {"pack_update": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(g2d: torch.Tensor, h2d: torch.Tensor, kb: int) -> None:
    if g2d.dim() != 2 or g2d.shape != h2d.shape:
        raise ValueError(f"g and h must be equal (nb, block) matrices, got "
                         f"{tuple(g2d.shape)} and {tuple(h2d.shape)}")
    if g2d.dtype != torch.float32 or h2d.dtype != torch.float32:
        raise TypeError(f"pack_update takes f32 g and h, got {g2d.dtype} "
                        f"and {h2d.dtype}")
    if g2d.device != h2d.device:
        raise ValueError(f"g on {g2d.device}, h on {h2d.device}")
    if not 0 < kb <= g2d.shape[1]:
        raise ValueError(f"need 0 < kb <= block, got kb={kb}, "
                         f"block={g2d.shape[1]}")


def pack_update(g2d: torch.Tensor, h2d: torch.Tensor, lam: float, kb: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nb, block) f32 g and h -> (vals (nb, kb) f32, idx (nb, kb) int32,
    h_out (nb, block) f32).  See ``csrc/pack_update.cu`` for the layout."""
    _check(g2d, h2d, kb)
    if g2d.device.type == "cpu":
        return ref.pack_update_ref(g2d, h2d, lam, kb)
    if g2d.device.type != "cuda":
        raise ValueError(f"pack_update runs on cpu or cuda, not {g2d.device}")
    nb, block = g2d.shape
    if block not in CUDA_BLOCKS:
        raise ValueError(f"the CUDA pack kernel takes block in {CUDA_BLOCKS}, "
                         f"got {block}")
    if not (g2d.is_contiguous() and h2d.is_contiguous()):
        raise ValueError("pack_update needs contiguous g and h")
    from repro_torch.kernels import build

    fn = build.load("pack_update").pack_update_f32
    vals = torch.empty((nb, kb), dtype=torch.float32, device=g2d.device)
    idx = torch.empty((nb, kb), dtype=torch.int32, device=g2d.device)
    h_out = torch.empty_like(h2d)
    with torch.cuda.device(g2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g2d.data_ptr(), h2d.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), h_out.data_ptr(), nb, block, kb, float(lam),
                 stream)
    if err != 0:
        raise RuntimeError(f"pack_update launch failed: cudaError {err}")
    LAUNCHES["pack_update"] += 1
    return vals, idx, h_out
