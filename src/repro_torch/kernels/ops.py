"""Public wrappers around the port's kernels: any tensor shape in, padded
to (nb, block) rows for the block kernel, outputs unpadded; and the
reference round's ordered worker sum (:func:`worker_sum`, whose launch
lives here).

Unlike the TPU wrappers, rows are padded only to nb * block, and the QSGD
and rand-k kernels take flat leaves unpadded: a CUDA kernel has no (8, 128)
tile to fill.

The least times of the block kernels (:func:`dense_bound_ms`) live here too,
so that every script that times them holds them to the same bound.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import (LAUNCHES, build, check_device, pack,
                                 plain_route, ref)


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


#: the worker sum's launch plan (:func:`worker_sum_plan`): columns a CTA
#: takes in the narrow layout; threads a CTA takes elsewhere (and at most
#: in the narrow layout); the shared memory its partials may take (48 KB, a
#: CTA's without asking for more); the width from which a thread takes 4
#: columns with 16-byte loads; the most CTAs (grid-stride beyond 16 an SM)
SUM_TILE = 4
SUM_THREADS = 256
SUM_SMEM = 48 * 1024
SUM_WIDE_COLS = 132 * 1024
SUM_MAX_GRID = 132 * 16
#: the C entry point's layout codes
SUM_LAYOUTS = {"column": 0, "narrow": 1, "wide": 2}


class SumPlan(NamedTuple):
    """How ``worker_sum.cu`` runs one sum.  ``layout``: "narrow" (a CTA per
    ``tile`` columns, its threads over the first level's windows, the
    partials of every level in ``smem`` bytes of shared memory), "column"
    (a thread per column, the rows in order or the windows streamed) or
    "wide" (the column form with ``tile`` = 4 columns a thread); ``levels``:
    the items at each level of XLA's windowed reduce (the rows, then the
    windows of each level, the last at most 32; one level when the sum is
    in order); ``threads`` a CTA, ``grid`` CTAs."""
    layout: str
    levels: Tuple[int, ...]
    tile: int
    threads: int
    grid: int
    smem: int


def _sum_levels(n: int, order: str) -> Tuple[int, ...]:
    """Items at each level of the sum: n rows, then while more than 32
    remain the windows of ``ref.reduce_windows`` (order "reduce"; the other
    orders sum the rows in order)."""
    levels = [n]
    while order == "reduce" and levels[-1] > ref.REDUCE_WINDOW:
        m = levels[-1]
        lo = (-m % ref.REDUCE_WINDOW) // 2
        levels.append(-(-(m + lo) // ref.REDUCE_WINDOW))
    return tuple(levels)


@functools.lru_cache(maxsize=1024)
def worker_sum_plan(n: int, cols: int, order: str = "reduce",
                    aligned: bool = True) -> SumPlan:
    """The launch plan of an ordered worker sum of (n, cols) f32 in
    ``order`` (``aligned``: every pointer 16-byte aligned).  A windowed
    reduce (order "reduce", n > 32) over fewer than SUM_WIDE_COLS columns
    takes the narrow layout while its partials fit SUM_SMEM
    (:data:`SUM_NARROW_ROWS` rows at most), so the windows run in parallel;
    every other sum takes a thread per column, or per 4 columns from
    SUM_WIDE_COLS on (when cols % 4 == 0 and aligned)."""
    if order not in ("reduce", "unrolled", "pair"):
        raise ValueError(f"unknown worker sum order {order!r}")
    levels = _sum_levels(n, order)
    smem = 4 * SUM_TILE * sum(levels[1:])
    if len(levels) > 1 and cols < SUM_WIDE_COLS and smem <= SUM_SMEM:
        return SumPlan("narrow", levels, SUM_TILE,
                       SUM_TILE * min(levels[1], SUM_THREADS // SUM_TILE),
                       -(-cols // SUM_TILE), smem)
    vec = 4 if cols >= SUM_WIDE_COLS and cols % 4 == 0 and aligned else 1
    return SumPlan("wide" if vec == 4 else "column", levels, vec,
                   SUM_THREADS,
                   min(-(-(cols // vec) // SUM_THREADS), SUM_MAX_GRID), 0)


def _narrow_rows() -> int:
    """The most rows the narrow layout takes: the largest n whose partials
    fit SUM_SMEM (bisection; the levels grow with n)."""
    lo, hi = ref.REDUCE_WINDOW + 1, 2**40
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if 4 * SUM_TILE * sum(_sum_levels(mid, "reduce")[1:]) <= SUM_SMEM:
            lo = mid
        else:
            hi = mid - 1
    return lo


#: the switch of a windowed reduce from the narrow layout to the streamed
#: column form
SUM_NARROW_ROWS = _narrow_rows()


def worker_sum(d: torch.Tensor, weights=None,
               h: Optional[torch.Tensor] = None, c_g: float = 0.0,
               c_h: float = 0.0, order: str = "reduce"):
    """The reference round's ordered worker sum of the worker-stacked (n,
    ...) f32 ``d``, shaped like d[0]: sum_i d_i, or with ``weights`` (the
    (n,) f32 participation mask, f32(m_i * c), or one float c for every
    row) each step one fma(d_i, w_i, acc), as XLA's fused reduce contracts
    acc + w_i * d_i.  ``order`` (``ref.worker_sum_ref``): "reduce", XLA's
    CPU reduce (worker order from +0.0 up to 32 rows, windows of 32
    beyond); "unrolled", worker order at every n, as XLA sums a fleet's
    stacked workers; "pair" (with an (n,) tensor of weights), unrolled
    with the first two terms fma(d_0, w_0, d_1 * w_1).  With ``h`` (shaped
    like d[0]) the master's two updates fused into the same pass: returns
    (fma(sum, c_g, h), fma(sum, c_h, h)).  On the card the ``worker_sum``
    kernel (``csrc/worker_sum.cu``, one launch, laid out by
    :func:`worker_sum_plan`); on the CPU its plain loop
    (``ref.worker_sum_ref``), and on the card too in sanitize mode."""
    if plain_route(d.device):
        return ref.worker_sum_ref(d, weights, h, c_g, c_h, order)
    check_device("worker_sum", d.device)
    if d.device.type == "meta":
        out = torch.empty(d.shape[1:], dtype=torch.float32, device=d.device)
        return out if h is None else (out, torch.empty_like(out))
    if d.dtype != torch.float32 or (h is not None
                                    and h.dtype != torch.float32):
        raise ValueError(f"worker_sum kernel takes f32, got {d.dtype}")
    n = d.shape[0]
    if n == 0:
        raise ValueError("worker_sum over no workers")
    # the host path is part of the reference round's time: no op that the
    # inputs do not need (a reshape, a copy, a device switch)
    d2 = d if d.dim() == 2 else d.reshape(n, -1)
    if not d2.is_contiguous():
        d2 = d2.contiguous()
    cols = d2.shape[1]
    w, scale, mode = None, 0.0, 0
    pair = order == "pair"
    if isinstance(weights, torch.Tensor):
        w, mode = weights, 3 if pair else 1
        if w.dtype != torch.float32 or not w.is_contiguous():
            w = w.to(torch.float32).contiguous()
        if w.numel() != n:
            raise ValueError(f"{w.numel()} weights for {n} workers")
    elif pair:
        raise ValueError("pair needs an (n,) tensor of weights")
    elif weights is not None:
        scale, mode = float(weights), 2
    hf = None
    if h is not None:
        hf = h if h.dim() == 1 else h.reshape(-1)
        if not hf.is_contiguous():
            hf = hf.contiguous()
        if hf.numel() != cols:
            raise ValueError(f"h of {hf.numel()} values for rows of {cols}")
    # one allocation for the sum, or for (g, h_avg') side by side
    shape = d.shape[1:]
    dev = d.device
    buf = torch.empty(shape if h is None else (2,) + shape,
                      dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    aligned = (d2.data_ptr() | (0 if hf is None else hf.data_ptr())
               | ptr) % 16 == 0
    plan = worker_sum_plan(n, cols, order, aligned)
    window = ref.REDUCE_WINDOW if order == "reduce" else 0
    err = build.launch(
        build.load("worker_sum").worker_sum_f32, dev, d2.data_ptr(),
        None if w is None else w.data_ptr(), scale, mode, window,
        None if hf is None else hf.data_ptr(), ptr,
        None if h is None else ptr + 4 * cols, n, cols, float(c_g),
        float(c_h), SUM_LAYOUTS[plan.layout], plan.tile, plan.threads,
        plan.grid, plan.smem)
    if err != 0:
        raise RuntimeError(f"worker_sum launch failed: cudaError {err}")
    LAUNCHES["worker_sum"] += 1
    return buf if h is None else buf.unbind(0)


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


# ---------------------------------------------------------------------------
# the dense-free gate on the card (JAX's ``analysis/hlo.py::dense_free``)
# ---------------------------------------------------------------------------

#: what a pack kernel may allocate beyond its declared outputs
DENSE_FREE_SLACK = 1 << 20
#: the full-width embed leaf of qwen2-0.5b (151,936 x 896 values)
EMBED_VALUES = 136_134_656


class DenseFreeReport(NamedTuple):
    """JAX's ``DenseFreeReport`` on the card: per case (d, the bytes the
    wrapper declares -- h_out, the payload with its CTA padding and the
    kernel's planned scratch --, the device bytes allocated above what was
    held before the call, at the peak), and what broke the gate."""

    kernel: str
    cases: Tuple[Tuple[int, int, int], ...]
    slack: int
    violations: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.violations


def _pack_case(d: int, block: int, kb: int, dev):
    nb = -(-d // block)
    g = torch.randn((nb, block), device=dev)
    h = torch.randn((nb, block), device=dev)
    rows = -(-nb // pack.CTA_ROWS) * pack.CTA_ROWS
    scratch = build.load("pack_update").pack_update_scratch_bytes(
        nb, block, kb)
    declared = 4 * nb * block + 2 * 4 * rows * kb + scratch
    return (lambda: pack.pack_update(g, h, 0.5, kb)), declared, nb * block


def _randk_case(d: int, k: int, dev):
    g = torch.randn(d, device=dev)
    h = torch.randn(d, device=dev)
    idx = (torch.arange(k, device=dev) * (d // k)).to(torch.int32)
    _, bucketed, words, _ = pack.randk_plan(d, k)
    declared = 4 * d + 4 * k + (4 * words if bucketed else 0)
    return (lambda: pack.randk_update(g, h, idx, 2.0, 0.5)), declared, d


def _qsgd_case(d: int, s: int, dev):
    g = torch.randn(d, device=dev)
    h = torch.randn(d, device=dev)
    u = torch.rand(d, device=dev)
    norm = torch.linalg.vector_norm(g - h).reshape(1)
    declared = 4 * d + d * ref.level_dtype(s).itemsize
    return (lambda: pack.qsgd_pack_update(g, h, u, norm, 0.5, s)), \
        declared, d


#: name -> the cases: JAX's shapes (``PACK_KERNELS``) and the embed leaf
#: (block-top-k at the main path's 256/16; rand-k at JAX's k = 16, the
#: scan path, and at the main path's 2**20, the bucketed one)
DENSE_FREE_CASES = {
    "block_topk_pack": lambda dev: [_pack_case(32 * 128, 128, 4, dev),
                                    _pack_case(EMBED_VALUES, 256, 16, dev)],
    "randk_update": lambda dev: [_randk_case(32 * 128, 16, dev),
                                 _randk_case(EMBED_VALUES, 16, dev),
                                 _randk_case(EMBED_VALUES, 1 << 20, dev)],
    "qsgd_pack": lambda dev: [_qsgd_case(64 * 128, 16, dev),
                              _qsgd_case(EMBED_VALUES, 16, dev)],
}


def dense_free(name: str, device) -> DenseFreeReport:
    """Prove on the card that the pack kernel ``name`` (a key of
    :data:`DENSE_FREE_CASES`) allocates no d-sized temporary: for each
    case, ``torch.cuda.max_memory_allocated`` above the bytes held before
    the wrapper call must stay within the bytes it declares plus
    :data:`DENSE_FREE_SLACK`.  Raises on a device other than CUDA (the
    CPU's plain versions are not the kernels)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"dense_free measures the CUDA kernels' device "
                         f"memory; {device} has none")
    cases, violations = [], []
    for fn, declared, d in DENSE_FREE_CASES[name](device):
        fn()  # the first call builds and loads the kernel
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        torch.cuda.synchronize(device)
        above = torch.cuda.max_memory_allocated(device) - held
        del out
        cases.append((d, declared, above))
        if above > declared + DENSE_FREE_SLACK:
            violations.append(
                f"d = {d}: {above} B allocated above the {held} B held, "
                f"{above - declared} B beyond the {declared} B declared")
    return DenseFreeReport(name, tuple(cases), DENSE_FREE_SLACK,
                           tuple(violations))
