"""Transformer building blocks as plain torch ops (``repro/models/layers.py``):
RMSNorm, RoPE, grouped-query attention with QKV bias, SwiGLU, and the
parameter specs and collectives of the mesh's ``model`` axis.

Parameters are dicts of tensors in the JAX layout (``x @ W`` weights of
shape (in, out)).  Each op keeps the JAX version's dtype casts (norm and
RoPE in f32, matmuls in the activation dtype, softmax in f32), so the two
packages round at the same places.  Ported so far: what the dense family
runs in training.

Parameter specs (:func:`auto_spec`, :func:`head_spec`) are the JAX
package's PartitionSpecs written as tuples of axis names, one per dim:
``"model"`` on the dim the ``model`` axis shards, ``None`` elsewhere.  As
in JAX, divisibility is tested against :data:`MODEL_AXIS_SIZE` (16, the
production axis), not against the mesh at hand.  :class:`ModelAxis` is a
rank's place on that axis; :func:`to_model` (identity forward, all-reduce
backward) and :func:`from_model` (all-reduce forward, identity backward)
are the two collectives of tensor parallelism, as autograd functions.
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


def to_model(x: Tensor, axis: Optional[ModelAxis]) -> Tensor:
    return x if axis is None else _ToModel.apply(x, axis)


def from_model(x: Tensor, axis: Optional[ModelAxis]) -> Tensor:
    return x if axis is None else _FromModel.apply(x, axis)


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


def causal_mask(Sq: int, Sk: int, device=None) -> Tensor:
    """(1, 1, 1, Sq, Sk) boolean mask."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    return (ki <= qi)[None, None, None]


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


def _sdpa_chunked(q: Tensor, k: Tensor, v: Tensor, *,
                  chunk: int = 1024) -> Tensor:
    """Causal attention as a loop over KV chunks with an online softmax: the
    semantics of the JAX ``_sdpa_chunked`` scan (scores stay at
    (B, K, G, Sq, chunk))."""
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
              hd: int, positions: Tensor, theta: float,
              impl: str = "direct") -> Tensor:
    """Causal self-attention over the full sequence (training / prefill).
    impl: 'direct' (materialized scores) or 'chunked' (online softmax)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv, hd)
    if theta > 0:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    if impl == "chunked":
        out = _sdpa_chunked(q, k, v, chunk=min(1024, k.shape[1]))
    elif impl == "direct":
        out = _sdpa(q, k, v, causal_mask(S, k.shape[1], device=x.device))
    else:
        raise ValueError(f"attention impl {impl!r} not in ('direct', "
                         "'chunked')")
    return out.reshape(B, S, n_heads * hd) @ p["wo"].to(x.dtype)


def swiglu(p: Dict[str, Tensor], x: Tensor) -> Tensor:
    g = torch.nn.functional.silu(x @ p["wg"].to(x.dtype))
    u = x @ p["wu"].to(x.dtype)
    return (g * u) @ p["wd"].to(x.dtype)
