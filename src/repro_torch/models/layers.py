"""Transformer building blocks as plain torch ops (``repro/models/layers.py``):
RMSNorm, RoPE, grouped-query attention with QKV bias, SwiGLU.

Parameters are dicts of tensors in the JAX layout (``x @ W`` weights of
shape (in, out)).  Each op keeps the JAX version's dtype casts (norm and
RoPE in f32, matmuls in the activation dtype, softmax in f32), so the two
packages round at the same places.  Ported so far: what the dense family
runs in training.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Tensor = torch.Tensor


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
