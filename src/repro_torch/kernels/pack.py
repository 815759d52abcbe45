"""Fused compress-and-pack kernel wrappers.

* :func:`pack_update`, the port of ``repro/kernels/pack.py::
  pack_update_pallas``: one pass over (g, h) rows emitting the block-top-k
  (values, block-local indices) payload and h_out = h + lam * d, with the
  dense compressed d never in device memory (``csrc/pack_update.cu``; the
  payload leaves by TMA bulk stores while h_out is computed).
* :func:`qsgd_pack_update`, the port of ``qsgd_pack_update_pallas``: one
  pass over flat (g, h, u) emitting the QSGD level stream and
  h_out = h + lam * dequant(levels) (``csrc/qsgd_pack_update.cu``).
* :func:`randk_update`, the port of ``randk_update_pallas``: the rand-k
  payload values at k given positions and h_out = h + lam * d, the dense
  d never in device memory: one pass over h in tiles, the positions
  bucketed by tile first (``randk_plan``, ``csrc/randk_update.cu``).
* :func:`block_topk` and :func:`efbv_update`, the ports of
  ``repro/kernels/block_topk.py``'s ``block_topk_pallas`` (out = x * keep
  per (nb, block) row, keep the kb largest |x|) and ``efbv_update_pallas``
  (d = block_topk(g - h), h_out = h + lam * d in one pass), on f32 or bf16
  rows (``csrc/block_topk.cu``).  Unlike the packs, their dense outputs are
  the functions' results.

On a CPU tensor a wrapper runs its plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises, except in sanitize mode
(``kernels.enable``), where it runs the plain version there too; on a
``meta`` tensor inside ``kernels.dry_run`` it allocates the kernel's
outputs.  ``LAUNCHES`` counts kernel
launches, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import (LAUNCHES, build, check_device,
                                 plain_route, ref)

# The CUDA block-top-k kernels (the pack and the dense two) take every
# block % 128 == 0, as the TPU kernels do: a warp per row up to 1024 and a
# CTA per row above, the row in registers up to 4096 and read again from
# shared or device memory at each step of the search above that.

#: the types of the dense kernels' entries
DENSE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: rows per CTA of the CUDA pack kernel: it stores whole CTAs' payload
#: slabs, so its vals and idx are padded to a multiple of this
CTA_ROWS = 8


def _block_message(name: str, block: int) -> str:
    return (f"the CUDA {name} kernel takes block % 128 == 0 (the TPU "
            f"kernel's lane tiling), got {block}")


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
    h_out (nb, block) f32).  See ``csrc/pack_update.cu`` for the layout.
    On the card vals and idx are the first nb rows of buffers padded to
    whole CTAs (multiples of ``CTA_ROWS`` rows), the kernel's bulk stores
    being whole CTA slabs."""
    _check(g2d, h2d, kb)
    if plain_route(g2d.device):
        return ref.pack_update_ref(g2d, h2d, lam, kb)
    check_device("pack_update", g2d.device)
    nb, block = g2d.shape
    if block % 128:
        raise ValueError(_block_message("pack_update", block))
    if not (g2d.is_contiguous() and h2d.is_contiguous()):
        raise ValueError("pack_update needs contiguous g and h")
    rows = -(-nb // CTA_ROWS) * CTA_ROWS
    vals = torch.empty((rows, kb), dtype=torch.float32, device=g2d.device)
    idx = torch.empty((rows, kb), dtype=torch.int32, device=g2d.device)
    if g2d.device.type == "meta":
        return vals[:nb], idx[:nb], torch.empty_like(h2d)
    lib = build.load("pack_update")
    fn = lib.pack_update_f32
    # blocks above 4096 whose kb slots do not fit in shared memory rank
    # their winners in device memory
    nbytes = lib.pack_update_scratch_bytes(nb, block, kb)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=g2d.device) \
        if nbytes else None
    if vals.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError("the pack kernel's bulk stores need 16-byte aligned "
                         "vals and idx")
    h_out = torch.empty_like(h2d)
    err = build.launch(fn, g2d.device, g2d.data_ptr(), h2d.data_ptr(),
                       vals.data_ptr(), idx.data_ptr(), h_out.data_ptr(),
                       scratch.data_ptr() if nbytes else None, nb, block, kb,
                       float(lam))
    if err != 0:
        raise RuntimeError(f"pack_update launch failed: cudaError {err}")
    LAUNCHES["pack_update"] += 1
    return vals[:nb], idx[:nb], h_out


def _check_qsgd(g, h, u, norm, s) -> None:
    if g.dim() != 1 or g.shape != h.shape or g.shape != u.shape:
        raise ValueError(f"g, h and u must be equal flat vectors, got "
                         f"{tuple(g.shape)}, {tuple(h.shape)} and "
                         f"{tuple(u.shape)}")
    for name, x in (("g", g), ("h", h), ("u", u), ("norm", norm)):
        if x.dtype != torch.float32:
            raise TypeError(f"qsgd_pack_update takes f32 {name}, got "
                            f"{x.dtype}")
        if x.device != g.device:
            raise ValueError(f"{name} on {x.device}, g on {g.device}")
    if norm.numel() != 1:
        raise ValueError(f"norm must hold one value, got {norm.numel()}")
    if not 1 <= s <= 32767:
        raise ValueError(f"QSGD levels take 1 <= s <= 32767, got s={s}")


def qsgd_pack_update(g: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                     norm: torch.Tensor, lam: float, s: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (size,) f32 g, h, u and the one-value f32 norm ||g - h||_2 ->
    (levels (size,) int8 for s <= 127 else int16, h_out (size,) f32).  See
    ``csrc/qsgd_pack_update.cu`` for the arithmetic."""
    _check_qsgd(g, h, u, norm, s)
    if plain_route(g.device):
        return ref.qsgd_pack_update_ref(g, h, u, norm, lam, s)
    check_device("qsgd_pack_update", g.device)
    if not all(x.is_contiguous() for x in (g, h, u, norm)):
        raise ValueError("qsgd_pack_update needs contiguous g, h, u, norm")
    dtype = ref.level_dtype(s)
    levels = torch.empty(g.shape, dtype=dtype, device=g.device)
    h_out = torch.empty_like(h)
    if g.device.type == "meta":
        return levels, h_out
    fn = build.load("qsgd_pack_update").qsgd_pack_update_f32
    inv_s = float(np.float32(1.0 / s))
    err = build.launch(fn, g.device, g.data_ptr(), h.data_ptr(),
                       u.data_ptr(), norm.data_ptr(), levels.data_ptr(),
                       h_out.data_ptr(), g.numel(), s, inv_s, float(lam),
                       levels.element_size())
    if err != 0:
        raise RuntimeError(f"qsgd_pack_update launch failed: cudaError {err}")
    LAUNCHES["qsgd_pack_update"] += 1
    return levels, h_out


def _check_randk(g, h, idx) -> None:
    if g.dim() != 1 or g.shape != h.shape:
        raise ValueError(f"g and h must be equal flat vectors, got "
                         f"{tuple(g.shape)} and {tuple(h.shape)}")
    if g.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"randk_update takes f32 g and h, got {g.dtype} and "
                        f"{h.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"randk_update takes (k,) int32 positions, got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    for name, x in (("h", h), ("idx", idx)):
        if x.device != g.device:
            raise ValueError(f"{name} on {x.device}, g on {g.device}")
    if g.numel() >= 2**31:
        raise ValueError(f"int32 positions address < 2**31 values, got "
                         f"{g.numel()}")


#: rand-k tiles: 2**RANDK_TILE_LOG2 values of h (32 KiB) a tile; a CTA of
#: the kernel holds two (the next one arrives while one is patched)
RANDK_TILE_LOG2 = 13
#: a leaf whose tiles times k is at most this skips the bucketing: each
#: tile's CTA reads all of idx (4 MiB of L2 reads in all at most)
RANDK_SCAN_LIMIT = 1 << 20
#: the most tiles whose counts a CTA holds in shared memory (224 KiB);
#: a leaf of more tiles is bucketed with global atomics
RANDK_SMEM_BINS = 56 * 1024
#: streaming multiprocessors of an H100 SXM
SMS = 132


def randk_plan(size: int, k: int) -> Tuple[int, bool, int, int]:
    """(tiles, bucketed, scratch int32 words, histogram CTAs) of the rand-k
    kernel on a leaf of ``size`` values and k positions
    (``csrc/randk_update.cu``).  The positions are bucketed by tile (a
    counting sort into k int2 pairs) unless tiles x k <= RANDK_SCAN_LIMIT,
    where each tile's CTA reads all of idx instead.  Up to RANDK_SMEM_BINS tiles
    the histogram's CTAs count in shared memory, few enough (k / 4 tiles,
    at most one an SM) that their per-tile atomics stay near k / 4, and the
    scratch holds each position's rank and each CTA's offsets; above, one
    cursor per tile (and no histogram CTA count: 0)."""
    tiles = -(-size >> RANDK_TILE_LOG2)
    if tiles * k <= RANDK_SCAN_LIMIT:
        return tiles, False, 0, 0
    if tiles > RANDK_SMEM_BINS:
        return tiles, True, 2 * k + 2 * tiles, 0
    ctas = min(SMS, max(1, k // (4 * tiles)))
    return tiles, True, -(-(2 * k + tiles) // 4) * 4 + k + ctas * tiles, ctas


def randk_update(g: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                 scale: float, lam: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (size,) f32 g and h and the (k,) int32 selected positions ->
    (vals (k,) f32, h_out (size,) f32).  On the card one pass over h in
    tiles, the positions bucketed by tile first (``randk_plan``,
    ``csrc/randk_update.cu``); a position outside [0, size) makes the
    kernel trap (the plain version, and so sanitize mode, raises
    IndexError)."""
    _check_randk(g, h, idx)
    if plain_route(g.device):
        return ref.randk_update_ref(g, h, idx, scale, lam)
    check_device("randk_update", g.device)
    if not (g.is_contiguous() and h.is_contiguous() and idx.is_contiguous()):
        raise ValueError("randk_update needs contiguous g, h and idx")
    size, k = g.numel(), idx.numel()
    _, bucketed, words, hist_ctas = randk_plan(size, k)
    vals = torch.empty(k, dtype=torch.float32, device=g.device)
    h_out = torch.empty_like(h)
    if g.device.type == "meta":
        return vals, h_out
    fn = build.load("randk_update").randk_update_f32
    scratch = torch.empty(words, dtype=torch.int32, device=g.device) \
        if bucketed else None
    err = build.launch(fn, g.device, g.data_ptr(), h.data_ptr(),
                       idx.data_ptr(), vals.data_ptr(), h_out.data_ptr(),
                       scratch.data_ptr() if bucketed else None, size, k,
                       RANDK_TILE_LOG2, int(bucketed), hist_ctas,
                       float(scale), float(lam))
    if err != 0:
        raise RuntimeError(f"randk_update launch failed: cudaError {err}")
    LAUNCHES["randk_update"] += 1
    return vals, h_out


def _check_dense(name: str, x2d: torch.Tensor, kb: int, *others) -> None:
    if x2d.dim() != 2 or any(o.shape != x2d.shape for o in others):
        raise ValueError(f"{name} takes equal (nb, block) matrices, got "
                         + ", ".join(str(tuple(t.shape))
                                     for t in (x2d, *others)))
    for t in (x2d, *others):
        if t.dtype not in DENSE_DTYPES or t.dtype != x2d.dtype:
            raise TypeError(f"{name} takes f32 or bf16 rows of one type, got "
                            + ", ".join(str(o.dtype) for o in (x2d, *others)))
        if t.device != x2d.device:
            raise ValueError(f"{name}: tensors on {x2d.device} and "
                             f"{t.device}")
    block = x2d.shape[1]
    if block % 128:
        raise ValueError(f"{name} takes block % 128 == 0 (the TPU kernel's "
                         f"lane tiling), got {block}")
    if not 0 < kb <= block:
        raise ValueError(f"need 0 < kb <= block, got kb={kb}, block={block}")


def _dense_entry(name: str, x2d: torch.Tensor, *tensors: torch.Tensor):
    """The CUDA entry of ``name`` for x2d's type, after the checks that
    only the card needs."""
    if not all(t.is_contiguous() for t in (x2d, *tensors)):
        raise ValueError(f"{name} needs contiguous rows")
    return getattr(build.load("block_topk"),
                   f"{name}_{DENSE_DTYPES[x2d.dtype]}")


def block_topk(x2d: torch.Tensor, kb: int) -> torch.Tensor:
    """(nb, block) f32 or bf16 -> (nb, block) of the same type: each row
    with all but its kb largest |x| zeroed (``ref.block_topk_ref``)."""
    _check_dense("block_topk", x2d, kb)
    if plain_route(x2d.device):
        return ref.block_topk_ref(x2d, kb)
    check_device("block_topk", x2d.device)
    out = torch.empty_like(x2d)
    if x2d.device.type == "meta":
        return out
    fn = _dense_entry("block_topk", x2d)
    err = build.launch(fn, x2d.device, x2d.data_ptr(), out.data_ptr(),
                       x2d.shape[0], x2d.shape[1], kb)
    if err != 0:
        raise RuntimeError(f"block_topk launch failed: cudaError {err}")
    LAUNCHES["block_topk"] += 1
    return out


def efbv_update(g2d: torch.Tensor, h2d: torch.Tensor, lam: float, kb: int,
                fused: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nb, block) g and h of one type (f32 or bf16) -> (d, h_out) of that
    type: d = block_topk(f32(g) - f32(h)), h_out = h + lam * d
    (``ref.efbv_update_ref``; ``fused``: one rounding at f32 kb = 1 too)."""
    _check_dense("efbv_update", g2d, kb, h2d)
    if plain_route(g2d.device):
        return ref.efbv_update_ref(g2d, h2d, lam, kb, fused)
    check_device("efbv_update", g2d.device)
    d = torch.empty_like(g2d)
    h_out = torch.empty_like(h2d)
    if g2d.device.type == "meta":
        return d, h_out
    fn = _dense_entry("efbv_update", g2d, h2d)
    err = build.launch(fn, g2d.device, g2d.data_ptr(), h2d.data_ptr(),
                       d.data_ptr(), h_out.data_ptr(), g2d.shape[0],
                       g2d.shape[1], kb, float(lam), int(fused))
    if err != 0:
        raise RuntimeError(f"efbv_update launch failed: cudaError {err}")
    LAUNCHES["efbv_update"] += 1
    return d, h_out
