"""Plain PyTorch versions of the port's CUDA kernels.

The CPU path of every kernel wrapper, and what ``chip_smoke.py`` holds each
kernel against on the card.  They repeat the kernel's arithmetic op for op
(and so the Pallas kernel's): they are references, not yardsticks of speed.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_rows(mag: torch.Tensor, kb: int) -> torch.Tensor:
    """(rows, block) magnitudes -> (rows, kb) int64 columns of the kb largest
    per row, in descending order with ties to the lowest column: the order
    of ``jax.lax.top_k``.  ``torch.topk`` breaks ties differently; a stable
    descending sort keeps equal keys in column order."""
    return torch.sort(mag, dim=1, descending=True, stable=True)[1][:, :kb]


def pack_update_ref(g2d: torch.Tensor, h2d: torch.Tensor, lam: float,
                    kb: int) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Block-top-k pack with the control-variate update, per (nb, block) row
    of f32 g and h.  Returns (vals (nb, kb) f32, idx (nb, kb) int32,
    h_out (nb, block) f32).

    ``h_out = h + lam * d`` is two ops, each rounded on its own, as in the
    Pallas kernel; ``vals + 0.0`` turns a selected -0.0 into +0.0, as the
    Pallas kernel's masked row sum does.  A row whose delta holds a NaN
    selects nothing and sends (0.0, 0) in every slot: the Pallas kernel's
    row max is then NaN and matches no column."""
    delta = g2d - h2d
    idx = topk_rows(delta.abs(), kb)
    picked = torch.gather(delta, 1, idx)
    nan_row = delta.isnan().any(dim=1, keepdim=True)
    idx = idx.masked_fill(nan_row, 0)
    picked = picked.masked_fill(nan_row, 0.0)
    d = torch.zeros_like(delta).scatter(1, idx, picked)
    h_out = h2d + lam * d
    return picked + 0.0, idx.to(torch.int32), h_out
