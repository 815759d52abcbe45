"""Plain PyTorch versions of the port's CUDA kernels.

The CPU path of every kernel wrapper, and what ``chip_smoke.py`` holds each
kernel against on the card.  They repeat the kernel's arithmetic op for op
(and so the Pallas kernel's): they are references, not yardsticks of speed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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
    Pallas kernel, except at kb = 1, where XLA contracts the Pallas
    kernel's h update into one fused multiply-add (``torch.add`` with
    ``alpha``: one rounding; ROADMAP fault l); ``vals + 0.0`` turns a
    selected -0.0 into +0.0, as the
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
    h_out = torch.add(h2d, d, alpha=lam) if kb == 1 else h2d + lam * d
    return picked + 0.0, idx.to(torch.int32), h_out


def select_rows(mag: torch.Tensor, kb: int) -> torch.Tensor:
    """(rows, block) f32 magnitudes -> bool keep-mask of the dense
    block-top-k Pallas kernel (``_select_mask``): the kb largest per row,
    ties to the lowest column (:func:`topk_rows`), a +inf selected like any
    value (the kernel's guard is ``m != -inf``, ROADMAP fault g), and
    nothing kept in a row holding a NaN (its row max is NaN and matches no
    column)."""
    keep = torch.zeros(mag.shape, dtype=torch.bool, device=mag.device)
    keep.scatter_(1, topk_rows(mag, kb), True)
    return keep & ~mag.isnan().any(dim=1, keepdim=True)


def apply_mask(x: torch.Tensor, keep: torch.Tensor, kb: int) -> torch.Tensor:
    """``x * keep`` as the Pallas kernel in interpret mode computes it, in
    x's type: a real multiply by 1 or 0 (an unselected -0.0 or negative
    value gives -0.0, an unselected NaN or inf gives NaN), except for f32 x
    at kb = 1, where XLA folds the one-round f32 mask into a select that
    writes +0.0 (ROADMAP fault i; a bf16 multiply is not folded)."""
    if kb == 1 and x.dtype == torch.float32:
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
    return x * keep.to(x.dtype)


def block_topk_ref(x2d: torch.Tensor, kb: int) -> torch.Tensor:
    """Dense block-top-k of (nb, block) f32 or bf16 rows: every value but
    the kb largest |x| of its row zeroed, selected on f32(|x|), in x's
    type."""
    return apply_mask(x2d, select_rows(x2d.abs().float(), kb), kb)


def efbv_update_ref(g2d: torch.Tensor, h2d: torch.Tensor, lam: float,
                    kb: int, fused: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused dense worker update of (nb, block) g and h of one type
    (f32 or bf16): delta = f32(g) - f32(h), d = (delta * keep) in g's type
    (the f32 product, so kb = 1 selects), h_out = (f32(h) + lam * f32(d))
    in h's type.  Returns (d, h_out).

    The Pallas kernel runs jitted in interpret mode, and XLA contracts
    ``h + lam * d`` into one fused multiply-add (``torch.add`` with
    ``alpha``: one rounding), except for f32 at kb = 1, where the select
    stands between the two and each op rounds on its own (ROADMAP
    fault i) -- unless ``fused``: given exactly one unreshaped (8, block)
    f32 tile, XLA contracts there too (fault m; the wrapper decides).
    bf16 d and h_out round to nearest even."""
    delta = g2d.float() - h2d.float()
    keep = select_rows(delta.abs(), kb)
    d = apply_mask(delta, keep, kb).to(g2d.dtype)
    if kb == 1 and h2d.dtype == torch.float32 and not fused:
        h_out = h2d + lam * d
    else:
        h_out = torch.add(h2d.float(), d.float(), alpha=lam)
    return d, h_out.to(h2d.dtype)


def level_dtype(s: int) -> torch.dtype:
    """The QSGD level stream's type: int8 for s <= 127, int16 above."""
    return torch.int8 if s <= 127 else torch.int16


def to_levels(lv: torch.Tensor, s: int) -> torch.Tensor:
    """f32 levels -> the level stream's type, as XLA converts: NaN becomes
    0, and values beyond the type saturate."""
    dtype = level_dtype(s)
    info = torch.iinfo(dtype)
    lv = torch.where(lv.isnan(), torch.zeros_like(lv), lv)
    return lv.clamp(info.min, info.max).to(dtype)


def qsgd_pack_update_ref(g: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                         norm: torch.Tensor, lam: float, s: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """QSGD quantize-and-pack with the control-variate update, on flat f32
    g, h, u (the uniform draws) and the (1,) f32 norm ||g - h||_2.  Returns
    (levels int8/int16, h_out f32), both shaped like g.

    The op chain of the Pallas kernel, each op rounded on its own:
    level = (|delta| / safe) * s, lvq = floor(level) + (u < level - floor),
    levels = sign * lvq, and h_out = h + lam * dq with
    dq = (norm * sign) * (lvq * f32(1/s)) where lvq > 0, else 0.  The level
    conversion follows XLA's (:func:`to_levels`).  A NaN in delta makes the
    norm NaN and safe = 1; every lane with lvq > 0 then gets a NaN h_out,
    every other lane h + lam * 0."""
    delta = g - h
    norm = norm.reshape(())
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    level = delta.abs() / safe * s
    low = torch.floor(level)
    up = (u < level - low).to(torch.float32)
    one = torch.ones_like(delta)
    sgn = torch.where(delta > 0, one,
                      torch.where(delta < 0, -one, torch.zeros_like(delta)))
    lvq = low + up
    levels = to_levels(sgn * lvq, s)
    inv_s = float(np.float32(1.0 / s))
    dq = torch.where(lvq > 0, (norm * sgn) * (lvq * inv_s),
                     torch.zeros_like(lvq))
    return levels, h + lam * dq


def randk_update_ref(g: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                     scale: float, lam: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rand-k payload values and control-variate update on flat f32 g and h
    at the (k,) int32 positions ``idx``.  Returns (vals (k,) f32,
    h_out (size,) f32).

    ``vals = (g[idx] - h[idx]) * scale`` and ``h_out = h + lam * d`` with d
    those values at idx and 0.0 elsewhere, each op rounded on its own, as
    in the Pallas kernel: an unselected -0.0 becomes +0.0.  A position
    outside [0, size) raises (torch would take a negative one from the
    end)."""
    if idx.numel() and not (0 <= int(idx.min()) and
                            int(idx.max()) < h.numel()):
        raise IndexError(f"rand-k positions outside [0, {h.numel()})")
    p = idx.long()
    vals = (g[p] - h[p]) * scale
    d = torch.zeros_like(h).index_put_((p,), vals)
    return vals, h + lam * d


def threefry_ref(key, n: int, device, as_float: bool) -> torch.Tensor:
    """(n,) threefry2x32 draws under ``key`` in torch int64 ops: f32
    uniforms in [0, 1) when ``as_float``, else the 32-bit words as int32
    (``repro_torch.random`` holds the arithmetic)."""
    from repro_torch import random

    b = random.bits_plain(key, n, device)
    return random.uniform_from_bits(b) if as_float else b


#: values a plain row draw computes at a time (its int64 temporaries)
_ROWS_CHUNK = 1 << 24


def threefry_rows_ref(keys: torch.Tensor, m: int,
                      as_float: bool) -> torch.Tensor:
    """(n, m) threefry2x32 draws, row i under the i-th key of the (n, 2)
    int32 tensor ``keys`` (the int64 rounds of :func:`threefry_ref` with
    each key broadcast along its row), a block of rows at a time."""
    from repro_torch import random

    n = keys.shape[0]
    out = torch.empty((n, m), dtype=torch.float32 if as_float
                      else torch.int32, device=keys.device)
    step = max(1, _ROWS_CHUNK // max(m, 1))
    for r in range(0, n, step):
        b = random.bits_rows_plain(keys[r:r + step], m)
        out[r:r + step] = random.uniform_from_bits(b) if as_float else b
    return out


def shuffle_rows_ref(keys: torch.Tensor, n: int, m: int,
                     k: int) -> torch.Tensor:
    """The row shuffle (``threefry.shuffle_rows``): (n, k) int32, each row
    the first k values of ``arange(m)`` reordered, a round at a time, by
    the plain row draw under that round's n keys, ``random.stable_order``
    of the words and ``torch.gather``."""
    from repro_torch import random

    return random.shuffle_by_sorts(keys, n, m, k, threefry_rows_ref)


#: rows of one window of XLA's CPU tree reduction (its
#: TreeReductionRewriter): a reduce over more rows sums windows of this many
REDUCE_WINDOW = 32


def reduce_windows(n: int):
    """[(start, stop)] row ranges of the windows XLA's CPU rewriter cuts a
    reduce over n > REDUCE_WINDOW rows into: the rows padded by -n % 32
    zeros, pad // 2 of them in front, then windows of 32."""
    lo = (-n % REDUCE_WINDOW) // 2
    return [(max(0, s - lo), min(n, s - lo + REDUCE_WINDOW))
            for s in range(0, n + lo, REDUCE_WINDOW)]


def _in_order(rows, weights, span):
    """sum over ``span`` of ``rows`` (the worker rows of d, ``unbind``-ed)
    in order from +0.0, each step fma(d_i, w_i, acc) under ``weights`` (a
    list of floats, or one float)."""
    acc = torch.zeros_like(rows[0])
    for i in span:
        if weights is None:
            acc = acc + rows[i]
        else:
            w = weights[i] if isinstance(weights, list) else weights
            acc = torch.add(acc, rows[i], alpha=w)
    return acc


def _rows(d, weights):
    """(d's rows, the weights as python floats): unbound and listed once,
    not indexed a row at a time (the windowed sum's loop at 95,232 rows)."""
    if isinstance(weights, torch.Tensor):
        weights = weights.tolist()
    elif weights is not None:
        weights = float(weights)
    return d.unbind(0), weights


def worker_sum_ref(d: torch.Tensor, weights=None, h=None, c_g: float = 0.0,
                   c_h: float = 0.0, order: str = "reduce"):
    """The ordered worker sum of the worker-stacked (n, ...) f32 ``d``, with
    ``weights`` (an (n,) tensor, or one float for every row) each step
    fma(d_i, w_i, acc) (``torch.add`` with ``alpha``: one rounding, as
    XLA's fused reduce contracts it; with a 0/1 mask the product is exact,
    so these are the bits of m_i * d_i then the add, and 0 * NaN is NaN).
    ``order``: "reduce", XLA's CPU reduce of a vmapped stack: up to 32
    rows in worker order from +0.0, beyond that the windows of
    :func:`reduce_windows`, each in order from +0.0, their partials
    reduced the same way; "unrolled", XLA's sum of a fleet's stacked
    workers, in worker order at every n; "pair", unrolled with the first
    two steps fma(d_0, w_0, d_1 * w_1).  With ``h`` the master's two
    updates of the same pass, (fma(sum, c_g, h), fma(sum, c_h, h)), as
    ``torch.add(h, sum, alpha=c)`` rounds them."""
    n = d.shape[0]
    if order == "pair":
        w0 = float(weights[0])
        acc = d[0] * w0 if n == 1 else torch.add(d[1] * float(weights[1]),
                                                 d[0], alpha=w0)
        for i in range(min(n, 2), n):
            acc = torch.add(acc, d[i], alpha=float(weights[i]))
    elif order == "reduce":
        while n > REDUCE_WINDOW:
            rows, ws = _rows(d, weights)
            d = torch.stack([_in_order(rows, ws, range(a, b))
                             for a, b in reduce_windows(n)])
            weights, n = None, d.shape[0]
        acc = _in_order(*_rows(d, weights), range(n))
    elif order == "unrolled":
        acc = _in_order(*_rows(d, weights), range(n))
    else:
        raise ValueError(f"unknown worker sum order {order!r}")
    if h is None:
        return acc
    return torch.add(h, acc, alpha=c_g), torch.add(h, acc, alpha=c_h)
