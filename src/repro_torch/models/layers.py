"""Transformer building blocks as plain torch ops (``repro/models/layers.py``):
RMSNorm, RoPE, grouped-query attention with QKV bias, SwiGLU, the
parameter specs and collectives of the mesh's ``model`` axis, the Mamba-2
SSD block (``repro/models/mamba2.py``) and the mixture of experts
(``repro/models/moe.py``).

Parameters are dicts of tensors in the JAX layout (``x @ W`` weights of
shape (in, out)).  Each op keeps the JAX version's dtype casts (norm and
RoPE in f32, matmuls in the activation dtype, softmax in f32), so the two
packages round at the same places.  Ported: what the dense, moe, ssm,
hybrid, encdec and vlm families run in training (sliding windows, M-RoPE,
non-causal and cross-attention included) and in serving (the one-token
decode steps :func:`attention_decode` and :func:`mamba2_decode`, with
:func:`mamba2_cache_init`), the latter batched over lanes that each hold
their own position, as JAX's ``vmap`` of the per-lane step runs them.

Parameter specs (:func:`auto_spec`, :func:`head_spec`) are the JAX
package's PartitionSpecs written as tuples of axis names, one per dim:
``"model"`` on the dim the ``model`` axis shards, ``None`` elsewhere.  As
in JAX, divisibility is tested against :data:`MODEL_AXIS_SIZE` (16, the
production axis), not against the mesh at hand.  :class:`ModelAxis` is a
rank's place on that axis; :func:`to_model` (identity forward, all-reduce
backward) and :func:`from_model` (all-reduce forward, identity backward)
are the two collectives of tensor parallelism, as autograd functions, and
:func:`gather_tree` gathers a layer's sharded leaves for a compute that
runs replicated (all-gather forward, this rank's slice backward).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor
Spec = Tuple[Optional[str], ...]

MODEL_AXIS = "model"
MODEL_AXIS_SIZE = 16  # production 'model' axis; smoke meshes divide it


# --------------------------------------------------------------------------
# sharding specs
# --------------------------------------------------------------------------

def auto_spec(shape: Sequence[int], prefer: Sequence[int],
              axis_size: int = MODEL_AXIS_SIZE) -> Spec:
    """'model' on the first preferred dim divisible by the model-axis size;
    replicated otherwise."""
    for dim in prefer:
        if shape[dim] % axis_size == 0:
            spec = [None] * len(shape)
            spec[dim] = MODEL_AXIS
            return tuple(spec)
    return (None,) * len(shape)


def head_spec(n_heads: int, hd: int, dim: int, policy: str,
              axis_size: int = MODEL_AXIS_SIZE) -> Spec:
    """An attention projection's spec (JAX's ``_head_spec``): the flat
    H * hd dim is sharded when the heads divide the axis, or under the
    'flat' policy when H * hd does; else replicated."""
    if n_heads % axis_size == 0 or policy == "flat":
        if (n_heads * hd) % axis_size == 0:
            return (None, MODEL_AXIS) if dim == 1 else (MODEL_AXIS, None)
    return (None, None)


def attention_specs(d: int, n_heads: int, n_kv: int, hd: int,
                    qkv_bias: bool, policy: str = "flat") -> Dict[str, Spec]:
    """The specs of ``attention_init``'s params (per layer, unstacked)."""
    specs = {"wq": head_spec(n_heads, hd, 1, policy),
             "wk": head_spec(n_kv, hd, 1, policy),
             "wv": head_spec(n_kv, hd, 1, policy),
             "wo": head_spec(n_heads, hd, 0, policy)}
    if qkv_bias:
        for name, nh in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            specs[name] = (MODEL_AXIS,) \
                if head_spec(nh, hd, 1, policy)[1] == MODEL_AXIS else (None,)
    return specs


def mlp_specs(d: int, ff: int) -> Dict[str, Spec]:
    """The specs of ``mlp_init``'s params (per layer, unstacked)."""
    return {"wg": auto_spec((d, ff), prefer=(1,)),
            "wu": auto_spec((d, ff), prefer=(1,)),
            "wd": auto_spec((ff, d), prefer=(0,))}


def is_spec(x) -> bool:
    """A leaf of a spec tree: a tuple whose entries are axis names, tuples
    of them (the worker axes of ``stack_worker_spec``) or None."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str)
        or (isinstance(a, tuple) and all(isinstance(b, str) for b in a))
        for a in x)


def spec_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards over the model axis (None: replicated)."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


# --------------------------------------------------------------------------
# the model axis: collectives with gradients
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ModelAxis:
    """This rank's place on the mesh's ``model`` axis: the axis size, its
    index along it, and the process group of the ``size`` ranks that hold
    one worker's shards.  Its collectives reduce in f32 (a bf16 partial is
    widened first, so M partials sum with one rounding to bf16 after), and
    count their host time, calls and the bytes each rank sends in
    :attr:`stats`."""

    size: int
    rank: int
    pg: Any = None
    stats: dict = dataclasses.field(default_factory=lambda: {
        "model_s": 0.0, "model_calls": 0, "model_bytes": 0})

    def _count(self, t0: float, nbytes: int) -> None:
        self.stats["model_s"] += time.perf_counter() - t0
        self.stats["model_calls"] += 1
        self.stats["model_bytes"] += nbytes

    def all_reduce(self, x: Tensor, op=dist.ReduceOp.SUM) -> Tensor:
        """The sum (or ``op``) of ``x`` over the axis, a new tensor of
        ``x``'s dtype; the reduction runs in f32."""
        y = x.detach().to(torch.float32, copy=True).contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(y, op=op, group=self.pg)
        self._count(t0, y.numel() * y.element_size())
        return y.to(x.dtype)

    def all_gather(self, x: Tensor, dim: int) -> Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in axis order: the
        logical tensor of a shard."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        t0 = time.perf_counter()
        dist.all_gather(parts, x, group=self.pg)
        self._count(t0, x.numel() * x.element_size())
        return torch.cat(parts, dim=dim)

    def shard(self, x: Tensor, dim: int) -> Tensor:
        """This rank's contiguous 1/size of ``x`` along ``dim`` (a copy)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over a model axis of {self.size}")
        step = n // self.size
        return x.narrow(dim, self.rank * step, step).contiguous()


class _ToModel(torch.autograd.Function):
    """Identity forward; backward all-reduces the gradient over the axis
    (each rank's column shard gives a partial input gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _FromModel(torch.autograd.Function):
    """All-reduce forward (the row shards' partial sums); identity
    backward (every rank's output gradient is the whole gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherParam(torch.autograd.Function):
    """A sharded weight gathered for use: all-gather forward; backward
    keeps this rank's slice of the gradient, with no reduction (the compute
    that uses the gathered weight runs replicated over the axis, so every
    rank's gradient is already the whole one)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.shard(g, ctx.dim), None, None


def to_model(x: Tensor, axis: Optional[ModelAxis]) -> Tensor:
    return x if axis is None else _ToModel.apply(x, axis)


def from_model(x: Tensor, axis: Optional[ModelAxis]) -> Tensor:
    return x if axis is None else _FromModel.apply(x, axis)


def gather_tree(p: Dict[str, Any], specs: Dict[str, Any],
                axis: Optional[ModelAxis]) -> Dict[str, Any]:
    """``p`` (a rank's shards of one layer's leaves, specs ``specs``) with
    every sharded leaf gathered on use (:class:`_GatherParam`): the logical
    weights, for a compute that runs replicated over the axis."""
    if axis is None:
        return p
    if isinstance(p, dict):
        return {k: gather_tree(v, specs[k], axis) for k, v in p.items()}
    dim = spec_dim(specs)
    return p if dim is None else _GatherParam.apply(p, axis, dim)


def head_aligned(specs: Dict[str, Spec], n_heads: int, n_kv: int,
                 size: int) -> bool:
    """Whether an attention's shards run Megatron-style on ``size`` ranks:
    q, k and v column-sharded, o row-sharded, and whole query and KV heads
    on every rank.  Otherwise its sharded leaves are gathered on use."""
    return (specs["wq"] == specs["wk"] == specs["wv"] == (None, MODEL_AXIS)
            and specs["wo"] == (MODEL_AXIS, None)
            and n_heads % size == 0 and n_kv % size == 0)


def mlp_aligned(specs: Dict[str, Spec]) -> bool:
    """Whether a SwiGLU's shards run Megatron-style: gate and up
    column-sharded, down row-sharded."""
    return (specs["wg"] == specs["wu"] == (None, MODEL_AXIS)
            and specs["wd"] == (MODEL_AXIS, None))


def vocab_parallel_embed(embed: Tensor, tokens: Tensor, dtype,
                         axis: ModelAxis) -> Tensor:
    """Rows of a vocab-sharded embedding: each rank looks up the tokens it
    owns (zeros elsewhere) and the partial lookups are summed, which is
    the unsharded lookup exactly."""
    v = embed.shape[0]
    local = tokens - axis.rank * v
    owned = (local >= 0) & (local < v)
    h = embed.to(dtype)[local.clamp(0, v - 1)]
    h = torch.where(owned[..., None], h, torch.zeros((), dtype=dtype,
                                                     device=h.device))
    return from_model(h, axis)


def vocab_parallel_cross_entropy(logits: Tensor, labels: Tensor,
                                 axis: ModelAxis
                                 ) -> Tuple[Tensor, Tensor]:
    """``cross_entropy`` of vocab-sharded logits (B, S, V / M): the max and
    the sum of exponentials all-reduced over the axis, the gold logit
    taken from the rank that owns it."""
    lf = logits.float()
    v = lf.shape[-1]
    with torch.no_grad():
        m = axis.all_reduce(lf.amax(dim=-1), op=dist.ReduceOp.MAX)
    sumexp = from_model(torch.exp(lf - m[..., None]).sum(dim=-1), axis)
    lse = m + torch.log(sumexp)
    local = labels.long() - axis.rank * v
    owned = (local >= 0) & (local < v)
    gold = torch.gather(lf, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = from_model(torch.where(owned, gold, torch.zeros_like(gold)), axis)
    mask = (labels >= 0).float()
    per_tok = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return per_tok.sum() / denom, denom


def rmsnorm(x: Tensor, w: Tensor, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: Tensor, positions3: Tensor, theta: float,
                sections: Sequence[int]) -> Tensor:
    """Multimodal RoPE (Qwen2-VL): positions3 (3, B, S) = (t, h, w) ids;
    the hd/2 frequency channels split into ``sections``, each group rotated
    by its own position stream.  sum(sections) == hd // 2."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, device=x.device)
    chunks, start = [], 0
    for sec, pos in zip(sections, positions3):
        chunks.append(pos[..., None].float() * freqs[start:start + sec])
        start += sec
    angles = torch.cat(chunks, dim=-1)  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _project_qkv(p: Dict[str, Tensor], x: Tensor, n_heads: int, n_kv: int,
                 hd: int):
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(B, S, n_heads, hd), k.reshape(B, S, n_kv, hd),
            v.reshape(B, S, n_kv, hd))


def causal_mask(Sq: int, Sk: int, window: int = 0, device=None) -> Tensor:
    """(1, 1, 1, Sq, Sk) boolean mask: key j visible to query i when j <= i
    and, with a ``window``, j > i - window."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    m = ki <= qi
    if window:
        m = m & (ki > qi - window)
    return m[None, None, None]


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask) -> Tensor:
    """Grouped scaled-dot-product attention with materialized scores.
    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd); H = K * G."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def _sdpa_chunked(q: Tensor, k: Tensor, v: Tensor, *, window: int = 0,
                  chunk: int = 1024) -> Tensor:
    """Causal attention (within a ``window`` when it is nonzero) as a loop
    over KV chunks with an online softmax: the semantics of the JAX
    ``_sdpa_chunked`` scan (scores stay at (B, K, G, Sq, chunk))."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    nc = -(-k.shape[1] // chunk)
    pad = nc * chunk - k.shape[1]
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q.reshape(B, Sq, K, G, hd) / math.sqrt(hd)).to(q.dtype)
    qi = torch.arange(Sq, device=q.device)
    m = torch.full((B, K, G, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32, device=q.device)
    for j in range(nc):
        kj = kp[:, j * chunk:(j + 1) * chunk]
        vj = vp[:, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, kj).float()
        kidx = j * chunk + torch.arange(chunk, device=q.device)
        valid = kidx[None, :] <= qi[:, None]
        if window:
            valid &= kidx[None, :] > qi[:, None] - window
        s = torch.where(valid[None, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum(
            "bkgqc,bckh->bkgqh", p.to(q.dtype), vj).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).movedim(-2, 1).reshape(B, Sq, H, hd)


def attention(p: Dict[str, Tensor], x: Tensor, *, n_heads: int, n_kv: int,
              hd: int, positions: Tensor, theta: float, window: int = 0,
              mrope_sections: Sequence[int] = (), causal: bool = True,
              kv: Optional[Tuple[Tensor, Tensor]] = None,
              impl: str = "direct") -> Tensor:
    """Full-sequence attention (training / prefill), JAX's ``attention``.

    positions: (B, S), or (3, B, S) under M-RoPE (``mrope_sections``);
    window: sliding-window size (0: full); causal=False: no mask at all;
    kv: given (k, v) of shape (B, Sk, n_kv, hd) for cross-attention, which
    replace the projected ones and get no rotary embedding.
    impl: 'direct' (materialized scores) or 'chunked' (online softmax; the
    causal self-attention only, as in JAX)."""
    if impl not in ("direct", "chunked"):
        raise ValueError(f"attention impl {impl!r} not in ('direct', "
                         "'chunked')")
    B, S, _ = x.shape
    if kv is None:
        q, k, v = _project_qkv(p, x, n_heads, n_kv, hd)
    else:
        # JAX projects k and v from x too, then drops them
        q = x @ p["wq"].to(x.dtype)
        if "bq" in p:
            q = q + p["bq"].to(x.dtype)
        q = q.reshape(B, S, n_heads, hd)
        k, v = kv
    if mrope_sections:
        q = apply_mrope(q, positions, theta, mrope_sections)
        if kv is None:
            k = apply_mrope(k, positions, theta, mrope_sections)
    elif theta > 0 and kv is None:
        pos2 = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos2, theta)
        k = apply_rope(k, pos2, theta)
    if impl == "chunked" and causal and kv is None:
        out = _sdpa_chunked(q, k, v, window=window,
                            chunk=min(1024, k.shape[1]))
    else:
        mask = causal_mask(S, k.shape[1], window, device=x.device) \
            if causal else None
        out = _sdpa(q, k, v, mask)
    return out.reshape(B, S, n_heads * hd) @ p["wo"].to(x.dtype)


def attention_decode(p: Dict[str, Tensor], x: Tensor, cache_k: Tensor,
                     cache_v: Tensor, pos: Tensor, *, n_heads: int,
                     n_kv: int, hd: int, theta: float, window: int = 0,
                     mrope_sections: Sequence[int] = ()
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """One-token decode with a KV cache (JAX's ``attention_decode``), each
    lane at its own position.

    x: (B, 1, d); cache_k/v: (B, C, K, hd), C the context (or the window);
    pos: (B,) int, each lane's absolute position.  RoPE (or M-RoPE with
    all three sections at ``pos``) on q and k; the new K/V go to slot
    ``pos % C`` under a window (a ring buffer), else ``min(pos, C - 1)``,
    written into the cache tensors in place; then attention over the slots
    the lane has filled (all of them once a ring buffer wrapped).  Returns
    (out (B, 1, d'), cache_k, cache_v)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, hd)
    pos = pos.to(device=x.device, dtype=torch.int64)
    if mrope_sections:
        pos3 = pos[None, :, None].expand(3, B, 1)
        q = apply_mrope(q, pos3, theta, mrope_sections)
        k = apply_mrope(k, pos3, theta, mrope_sections)
    elif theta > 0:
        q = apply_rope(q, pos[:, None], theta)
        k = apply_rope(k, pos[:, None], theta)
    C = cache_k.shape[1]
    slot = pos % C if window else torch.clamp(pos, max=C - 1)
    lanes = torch.arange(B, device=x.device)
    cache_k[lanes, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[lanes, slot] = v[:, 0].to(cache_v.dtype)
    ki = torch.arange(C, device=x.device)[None, :]
    valid = ki <= pos[:, None]
    if window:
        # a ring buffer: before it wraps only slots <= pos are live, after
        # it every slot holds one of the last C tokens
        valid = valid | (pos[:, None] >= C)
    mask = valid[:, None, None, None, :]  # (B, 1, 1, 1, C)
    out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask)
    out = out.reshape(B, 1, n_heads * hd) @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v


def swiglu(p: Dict[str, Tensor], x: Tensor) -> Tensor:
    g = torch.nn.functional.silu(x @ p["wg"].to(x.dtype))
    u = x @ p["wu"].to(x.dtype)
    return (g * u) @ p["wd"].to(x.dtype)


# --------------------------------------------------------------------------
# Mamba-2 SSD block (``repro/models/mamba2.py``)
# --------------------------------------------------------------------------
#
# The chunked SSD scan of training and prefill: quadratic within a chunk,
# a linear recurrence over the chunks' end states.  Projections are stored
# un-fused (wz/wx/wB/wC/wdt), as in JAX.  Serving's recurrent decode
# (``mamba2_decode``) carries the SSM state and the conv window of each
# lane (``mamba2_cache_init``).

def mamba2_specs(d: int, *, d_inner: int, d_state: int, n_heads: int,
                 d_conv: int) -> Dict[str, Spec]:
    """The specs of ``mamba2_init``'s params (per layer, unstacked)."""
    conv_ch = d_inner + 2 * d_state
    return {
        "wz": auto_spec((d, d_inner), prefer=(1,)),
        "wx": auto_spec((d, d_inner), prefer=(1,)),
        "wB": auto_spec((d, d_state), prefer=(1,)),
        "wC": auto_spec((d, d_state), prefer=(1,)),
        "wdt": auto_spec((d, n_heads), prefer=(1,)),
        "dt_bias": (None,), "A_log": (None,), "D": (None,),
        "conv_w": auto_spec((d_conv, conv_ch), prefer=(1,)),
        "conv_b": auto_spec((conv_ch,), prefer=(0,)),
        "norm_w": auto_spec((d_inner,), prefer=(0,)),
        "wo": auto_spec((d_inner, d), prefer=(0,)),
    }


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (torch's
    ``softplus`` returns x itself above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over time as K shifted adds, then SiLU.
    x: (B, S, C); w: (K, C); b: (C,)."""
    K = w.shape[0]
    out = x * w[K - 1]
    for j in range(K - 1):
        shift = K - 1 - j
        out = out + torch.nn.functional.pad(
            x, (0, 0, shift, 0))[:, :-shift] * w[j]
    return torch.nn.functional.silu(out + b.to(x.dtype))


def ssd_chunked(xh: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                chunk: int) -> Tensor:
    """Chunked SSD scan.  xh: (B, S, H, hp); dt: (B, S, H); A: (H,)
    negative; Bm, Cm: (B, S, st).  Returns y: (B, S, H, hp).

    One change from ``mamba2.py:95-98`` (ROADMAP fault w): the decay matrix
    is ``exp(where(causal, diff, -inf))``, masked before the exp, where JAX
    computes ``where(causal, exp(diff), 0)``.  Above the diagonal ``diff``
    is a positive sum of up to chunk - 1 decays ``-dt * A``; at full width
    (chunk 128, A down to -24) it passes 88 and ``exp`` gives inf.  The
    forward values are the same either way (the select drops those
    entries, and exp(-inf) is 0), but the backward pass multiplies the
    select's zero cotangent by inf: JAX's gradient is NaN there, this
    one finite.  The scan over the chunks is a loop over their count."""
    B, S, H, hp = xh.shape
    st = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    nc = S // chunk
    f32 = torch.float32
    xc = xh.reshape(B, nc, chunk, H, hp)
    dtc = dt.reshape(B, nc, chunk, H).to(f32)
    Bc = Bm.reshape(B, nc, chunk, st)
    Cc = Cm.reshape(B, nc, chunk, st)

    a = dtc * A                           # per-step log decay (negative)
    cum_a = torch.cumsum(a, dim=2)        # inclusive, within the chunk
    xdt = xc * dtc[..., None].to(xc.dtype)

    # intra-chunk: L[i, j] = exp(cum_a[i] - cum_a[j]) for i >= j, else 0
    diff = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]
    idx = torch.arange(chunk, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, diff,
                              torch.full((), -math.inf, dtype=f32,
                                         device=xh.device)))
    cb = torch.einsum("bnis,bnjs->bnij", Cc.to(f32), Bc.to(f32))
    att = cb[..., None] * L
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", att.to(xc.dtype), xdt)

    # chunk-local end states: sum_j exp(cum_a[Q-1] - cum_a[j]) B_j x_j dt_j
    decay_to_end = torch.exp(cum_a[:, :, -1:, :] - cum_a)
    s_local = torch.einsum("bnjs,bnjh,bnjhp->bnhsp", Bc.to(f32),
                           decay_to_end, xdt.to(f32))

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum_a[:, :, -1, :])   # (B, nc, H)
    s = torch.zeros((B, H, st, hp), dtype=f32, device=xh.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = chunk_decay[:, c, :, None, None] * s + s_local[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)         # (B, nc, H, st, hp)

    decay_from_start = torch.exp(cum_a)
    y_inter = torch.einsum("bnis,bnih,bnhsp->bnihp", Cc.to(f32),
                           decay_from_start, s_prevs)
    return (y_intra + y_inter.to(xc.dtype)).reshape(B, S, H, hp)


def mamba2_apply(p: Dict[str, Tensor], x: Tensor, *, d_inner: int,
                 d_state: int, n_heads: int, chunk: int,
                 norm_eps: float = 1e-5) -> Tensor:
    """Full-sequence SSD block.  x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    hp = d_inner // n_heads
    z = x @ p["wz"].to(x.dtype)
    xin = x @ p["wx"].to(x.dtype)
    Bm = x @ p["wB"].to(x.dtype)
    Cm = x @ p["wC"].to(x.dtype)
    dt = softplus((x @ p["wdt"].to(x.dtype)).float() + p["dt_bias"])
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = causal_conv(conv_in, p["conv_w"].to(x.dtype), p["conv_b"])
    xin, Bm, Cm = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, n_heads, hp)
    y = ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    y = y + p["D"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y * torch.nn.functional.silu(z), p["norm_w"], norm_eps)
    return y @ p["wo"].to(x.dtype)


def mamba2_cache_init(batch: int, *, d_inner: int, d_state: int,
                      n_heads: int, d_conv: int, dtype=torch.float32,
                      device=None) -> Dict[str, Tensor]:
    """One layer's decode cache, zeros: the f32 SSM ``state`` (batch, H,
    st, hp) and the ``conv`` window of the last d_conv - 1 inputs (batch,
    d_conv - 1, d_inner + 2 st) in ``dtype``."""
    hp = d_inner // n_heads
    return {
        "state": torch.zeros((batch, n_heads, d_state, hp),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, d_conv - 1, d_inner + 2 * d_state),
                            dtype=dtype, device=device)}


def mamba2_decode(p: Dict[str, Tensor], x: Tensor, cache: Dict[str, Tensor],
                  *, d_inner: int, d_state: int, n_heads: int,
                  norm_eps: float = 1e-5
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token recurrent SSD step (JAX's ``mamba2_decode``).  x: (B, 1,
    d) -> (out (B, 1, d), the new cache).  Two of JAX's choices keep the
    batched step equal to the per-lane one: the dt projection in f32 (a
    narrow bf16 matmul sums in an order that varies with the batch), and
    the state update as an explicit broadcast product, not a three-operand
    einsum (whose pairing varies too).  A = -exp(A_log) and the decay by
    ``torch.exp``, as :func:`mamba2_apply` computes A."""
    B = x.shape[0]
    hp = d_inner // n_heads
    xt = x[:, 0]
    z = xt @ p["wz"].to(x.dtype)
    xin = xt @ p["wx"].to(x.dtype)
    Bm = xt @ p["wB"].to(x.dtype)
    Cm = xt @ p["wC"].to(x.dtype)
    dt = softplus(xt.float() @ p["wdt"] + p["dt_bias"])         # (B, H)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                  # (B, Ch)
    hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)  # (B, K, Ch)
    w = p["conv_w"].to(x.dtype)
    conv_out = torch.nn.functional.silu(
        torch.einsum("bkc,kc->bc", hist, w) + p["conv_b"].to(x.dtype))
    xin, Bm, Cm = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                   # (B, H)
    xh = xin.reshape(B, n_heads, hp).float()
    upd = (Bm.float()[:, None, :, None] * xh[:, :, None, :]
           * dt[:, :, None, None])
    state = decay[:, :, None, None] * cache["state"] + upd
    y = torch.einsum("bs,bhsp->bhp", Cm.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, d_inner).to(x.dtype)
    y = rmsnorm(y * torch.nn.functional.silu(z), p["norm_w"], norm_eps)
    out = (y @ p["wo"].to(x.dtype))[:, None]
    return out, {"state": state, "conv": hist[:, 1:]}


# --------------------------------------------------------------------------
# Mixture of experts (``repro/models/moe.py``)
# --------------------------------------------------------------------------
#
# A top-k softmax router, capacity-bounded scatter/gather dispatch and the
# Switch-style load-balance loss.  Expert weights are stacked on a leading
# E axis.  The dispatch groups run batched, as JAX's ``vmap`` runs them.

EXPERT_LEAVES = ("wg", "wu", "wd")


def moe_specs(d: int, ff: int, n_experts: int) -> Dict[str, Spec]:
    """The specs of ``moe_init``'s params (per layer, unstacked): experts
    parallel over 'model' only when E divides it, the router
    replicated."""
    return {"router": (None, None),
            "wg": auto_spec((n_experts, d, ff), prefer=(0,)),
            "wu": auto_spec((n_experts, d, ff), prefer=(0,)),
            "wd": auto_spec((n_experts, ff, d), prefer=(0,))}


def _is_moe_subtree(node) -> bool:
    return (isinstance(node, dict) and "router" in node
            and all(k in node for k in EXPERT_LEAVES))


def expert_activity_mask(moe_grads: Dict[str, Tensor]) -> Tensor:
    """Which experts this round's gradients touched: a boolean (..., E)
    mask, True where any of the wg/wu/wd slabs of an expert holds a
    nonzero entry (an expert no token reached has exactly zero slabs: the
    dispatch scatters a zero buffer row to it)."""
    masks = [(moe_grads[name] != 0).flatten(-2).any(-1)
             for name in EXPERT_LEAVES]
    return masks[0] | masks[1] | masks[2]


def zero_inactive_expert_grads(grads, mask: Optional[Tensor] = None):
    """Zero the wg/wu/wd gradient slabs of inactive experts, worker-side:
    every MoE subtree's expert leaves times ``mask`` (default
    :func:`expert_activity_mask` of the subtree itself, under which this
    is the identity).  Non-MoE subtrees pass through."""
    if _is_moe_subtree(grads):
        m = expert_activity_mask(grads) if mask is None else mask
        out = dict(grads)
        for name in EXPERT_LEAVES:
            g = grads[name]
            out[name] = g * m[..., None, None].to(g.dtype)
        return out
    if isinstance(grads, dict):
        return {k: zero_inactive_expert_grads(v, mask)
                for k, v in grads.items()}
    return grads


def fixed_routing_params(params):
    """Zero every MoE router leaf, so all logits tie and the top-k routes
    every token to experts 0..k-1 (ties to the lowest index)."""
    if _is_moe_subtree(params):
        out = dict(params)
        out["router"] = torch.zeros_like(params["router"])
        return out
    if isinstance(params, dict):
        return {k: fixed_routing_params(v) for k, v in params.items()}
    return params


def top_k_lowest_ties(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` along the last dim: (values, int64 indices) in
    descending order, ties to the lowest index (a stable descending sort;
    ``torch.topk`` orders ties otherwise)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    ids = order[..., :k]
    return torch.gather(x, -1, ids), ids


def dispatch_groups(p: Dict[str, Tensor], xg: Tensor, *, n_experts: int,
                    k: int, capacity: int) -> Tuple[Tensor, Tensor]:
    """Capacity-bounded dispatch and combine of G token groups at once
    (JAX's ``vmap`` of ``_dispatch_group``).  xg: (G, Tg, d) -> (out
    (G, Tg, d), aux (G,)).  A token's position in its expert is the
    exclusive cumsum of the int32 one-hot of the (token, choice) list;
    past the capacity it goes to the trash row E * C, the one row that
    repeats in the scatter."""
    G, Tg, d = xg.shape
    E, C = n_experts, capacity
    dt = xg.dtype
    logits = (xg @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k_lowest_ties(probs, k)       # (G, Tg, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    me = probs.mean(dim=1)
    ce = torch.nn.functional.one_hot(expert_ids[..., 0], E).float() \
        .mean(dim=1)
    aux = E * (me * ce).sum(dim=-1)

    flat_ids = expert_ids.reshape(G, Tg * k)
    onehot = torch.nn.functional.one_hot(flat_ids, E).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=1, dtype=torch.int32)
                       - onehot, -1, flat_ids[..., None])[..., 0]
    in_cap = pos < C
    slot = torch.where(in_cap, flat_ids * C + pos,
                       torch.full_like(flat_ids, E * C))       # (G, Tg*k)

    rows = E * C + 1
    xk = xg.repeat_interleave(k, dim=1)
    offset = torch.arange(G, device=xg.device)[:, None] * rows
    buf = torch.zeros((G * rows, d), dtype=dt, device=xg.device)
    buf = buf.index_add(0, (slot + offset).reshape(-1), xk.reshape(-1, d))
    eb = buf.reshape(G, rows, d)[:, :-1].reshape(G, E, C, d)

    h = torch.nn.functional.silu(
        torch.einsum("gecd,edf->gecf", eb, p["wg"].to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", eb, p["wu"].to(dt))
    out_e = torch.einsum("gecf,efd->gecd", h, p["wd"].to(dt))

    flat_out = torch.cat([out_e.reshape(G, E * C, d),
                          torch.zeros((G, 1, d), dtype=dt,
                                      device=xg.device)], dim=1)
    ok = torch.gather(flat_out, 1, slot[..., None].expand(G, Tg * k, d))
    weighted = ok * (gate_vals.reshape(G, -1, 1).to(dt)
                     * in_cap.reshape(G, -1, 1).to(dt))
    return weighted.reshape(G, Tg, k, d).sum(dim=2), aux


def moe_capacity(T: int, groups: int, n_experts: int, k: int,
                 capacity_factor: float) -> Tuple[int, int]:
    """(G, capacity) of ``moe_apply``: G groups (default one per batch row,
    lowered until it divides the T tokens) and the per-group capacity
    ``max(1, int(capacity_factor * k * Tg / E))`` in JAX's float order."""
    G = groups
    while T % G:
        G -= 1
    Tg = T // G
    return G, max(1, int(capacity_factor * k * Tg / n_experts))


def moe_apply(p: Dict[str, Tensor], x: Tensor, *, n_experts: int, k: int,
              capacity_factor: float = 1.25,
              groups: int = 0) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux load-balance loss, the mean over
    the dispatch groups)."""
    B, S, d = x.shape
    G, capacity = moe_capacity(B * S, groups or B, n_experts, k,
                               capacity_factor)
    out, aux = dispatch_groups(p, x.reshape(G, (B * S) // G, d),
                               n_experts=n_experts, k=k, capacity=capacity)
    return out.reshape(B, S, d), aux.mean()
