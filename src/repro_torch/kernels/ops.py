"""Public wrappers around the port's kernels: any tensor shape in, padded
to (nb, block) rows for the block kernel, outputs unpadded.

Unlike the TPU wrappers, rows are padded only to nb * block, and the QSGD
and rand-k kernels take flat leaves unpadded: a CUDA kernel has no (8, 128)
tile to fill.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import pack


def to_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """x flattened and zero-padded to whole (nb, block) rows (a view when
    no padding is needed)."""
    xf = x.reshape(-1)
    pad = -xf.numel() % block
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    return xf.reshape(-1, block)


def efbv_pack_update(g: torch.Tensor, h: torch.Tensor, lam: float,
                     block: int = 1024, kb: int = 64
                     ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                torch.Tensor]:
    """Fused compress-and-pack worker update: d = block_topk(g - h),
    h' = h + lam d, and the wire payload, in one pass.

    Returns ((values, indices), h') with values/indices of shape (nb, kb),
    nb = ceil(g.numel() / block), and h' shaped like h."""
    vals, idx, h_out = pack.pack_update(
        to_rows(g, block), to_rows(h, block), lam, kb)
    return (vals, idx), h_out.reshape(-1)[:h.numel()].reshape(h.shape)


def qsgd_pack_update(g: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                     norm, lam: float, s: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused QSGD quantize-and-pack (JAX's ``ops.qsgd_pack_update``
    signature): returns the flat (g.numel(),) signed level stream (int8 for
    s <= 127, int16 above) and h' = h + lam * dequant(levels) shaped like
    h.  ``u``: the (g.numel(),) uniform draws; ``norm``: ||g - h||_2 (a
    tensor or a float)."""
    norm = torch.as_tensor(norm, dtype=torch.float32,
                           device=g.device).reshape(1)
    levels, h_out = pack.qsgd_pack_update(
        g.reshape(-1), h.reshape(-1), u.reshape(-1), norm, lam, s)
    return levels, h_out.reshape(h.shape)


def randk_update(g: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                 lam: float, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused rand-k worker update (JAX's ``ops.randk_update`` signature):
    h' = h + lam * d with d = (g - h) * scale at the (k,) int32 flat
    positions ``idx`` and 0 elsewhere.  Returns (the (k,) payload values
    d[idx], h' shaped like h): the kernel emits the values that JAX gathers
    outside its kernel, bit for bit the same."""
    vals, h_out = pack.randk_update(g.reshape(-1), h.reshape(-1), idx,
                                    scale, lam)
    return vals, h_out.reshape(h.shape)
