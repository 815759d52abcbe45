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

from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES, pack, ref


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
    kernel (``csrc/worker_sum.cu``, one launch); on the CPU its plain
    loop (``ref.worker_sum_ref``)."""
    if d.device.type == "cpu":
        return ref.worker_sum_ref(d, weights, h, c_g, c_h, order)
    if d.device.type != "cuda":
        raise ValueError(f"worker_sum runs on cpu or cuda, not {d.device}")
    if d.dtype != torch.float32 or (h is not None
                                    and h.dtype != torch.float32):
        raise ValueError(f"worker_sum kernel takes f32, got {d.dtype}")
    if order not in ("reduce", "unrolled", "pair"):
        raise ValueError(f"unknown worker sum order {order!r}")
    from repro_torch.kernels import build

    n = d.shape[0]
    if n == 0:
        raise ValueError("worker_sum over no workers")
    d2 = d.reshape(n, -1).contiguous()
    cols = d2.shape[1]
    w, scale, mode = None, 0.0, 0
    pair = order == "pair"
    if isinstance(weights, torch.Tensor):
        w, mode = weights.to(torch.float32).contiguous(), 3 if pair else 1
        if w.numel() != n:
            raise ValueError(f"{w.numel()} weights for {n} workers")
    elif pair:
        raise ValueError("pair needs an (n,) tensor of weights")
    elif weights is not None:
        scale, mode = float(weights), 2
    hf = None if h is None else h.reshape(-1).contiguous()
    if hf is not None and hf.numel() != cols:
        raise ValueError(f"h of {hf.numel()} values for rows of {cols}")
    out = torch.empty(cols, dtype=torch.float32, device=d.device)
    out_h = None if h is None else torch.empty_like(out)
    window = ref.REDUCE_WINDOW if order == "reduce" else 0
    fn = build.load("worker_sum").worker_sum_f32
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(d2.data_ptr(), None if w is None else w.data_ptr(), scale,
                 mode, window, None if hf is None else hf.data_ptr(),
                 out.data_ptr(), None if out_h is None else out_h.data_ptr(),
                 n, cols, float(c_g), float(c_h), stream)
    if err != 0:
        raise RuntimeError(f"worker_sum launch failed: cudaError {err}")
    LAUNCHES["worker_sum"] += 1
    shape = d.shape[1:]
    if h is None:
        return out.reshape(shape)
    return out.reshape(shape), out_h.reshape(shape)


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
