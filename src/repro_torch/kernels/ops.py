"""Public wrappers around the port's kernels: any tensor shape in, padded
to (nb, block) rows for the block kernel, outputs unpadded.

Unlike the TPU wrappers, rows are padded only to nb * block, and the QSGD
and rand-k kernels take flat leaves unpadded: a CUDA kernel has no (8, 128)
tile to fill.

The least times of the block kernels (:func:`dense_bound_ms`) live here too,
so that every script that times them holds them to the same bound.
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


def _unpad(x2d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x2d.reshape(-1)[:like.numel()].reshape(like.shape)


def block_topk(x: torch.Tensor, block: int = 1024, kb: int = 64
               ) -> torch.Tensor:
    """Dense block-top-k compression of a tensor of any shape (JAX's
    ``ops.block_topk``): each block of ``block`` values keeps its kb
    largest |x|, in x's type (f32 or bf16)."""
    return _unpad(pack.block_topk(to_rows(x, block), kb), x)


def efbv_update(g: torch.Tensor, h: torch.Tensor, lam: float,
                block: int = 1024, kb: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dense worker update (JAX's ``ops.efbv_update``):
    d = C(g - h), h' = h + lam d.  Returns (d, h'), both shaped like g, d
    in g's type and h' in h's.  As JAX's wrapper does, h is rounded to g's
    type before the kernel and h' converted back after it (ROADMAP
    fault h).  f32 at kb = 1 rounds h' twice, except on exactly one
    unreshaped (8, block) tile of g, where JAX's kernel rounds once
    (fault m)."""
    fused = (kb == 1 and g.dtype == torch.float32
             and tuple(g.shape) == (8, block))
    d, h_out = pack.efbv_update(to_rows(g, block),
                                to_rows(h.to(g.dtype), block), lam, kb,
                                fused)
    return _unpad(d, g), _unpad(h_out, g).to(h.dtype)


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


# ---------------------------------------------------------------------------
# least times of the block kernels on an H100 SXM
# ---------------------------------------------------------------------------

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
#: thread instructions per second at one warp instruction per scheduler and
#: clock: 132 SMs x 4 x 32 lanes x 1.98 GHz (half the f32 rate of 67e12,
#: which counts an FMA as two)
H100_ISSUE_PER_S = 33.5e12
#: per kernel: (values read or written per input value, elementwise ops per
#: value besides the selection's compares)
DENSE_WORK = {"block_topk": (2, 2),     # read x, write out; |x|, x * keep
              "efbv_update": (4, 4),    # g, h, d, h'; -, |.|, *, fma
              "pack_update": (3, 3)}    # g, h, h' (+ payload); -, |.|, fma
#: the most steps the selection's threshold search takes: one per bit of a
#: 31-bit magnitude key (``csrc/block_select.cuh``)
SEARCH_STEPS = 31


def dense_bound_ms(kernel: str, values: int, elem: int = 4, payload: int = 0
                   ) -> Tuple[float, str]:
    """(least ms, what sets it) of ``kernel`` over ``values`` values: each
    input read once and each output written once (``payload`` bytes
    besides the dense tensors) at the memory rate, or the elementwise ops
    plus one compare per value in each step of the threshold search, at
    most SEARCH_STEPS, at the issue rate.  That is at most 35 operations
    per value, below the bytes of f32 and bf16 rows (80 and 40 per value
    for block_topk), so the bound is the bytes."""
    tensors, n_ops = DENSE_WORK[kernel]
    t_bytes = (tensors * elem * values + payload) / H100_BYTES_PER_S
    t_ops = (n_ops + SEARCH_STEPS) * values / H100_ISSUE_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"
