"""Wire codecs: payload layouts, exact bit accounting, and the pack /
scatter-add helpers of the wire (``repro/distributed/wire.py``).

Every codec of the JAX zoo's compressors:

  codec         compressors                         payload of one leaf
  ------------  ----------------------------------  --------------------------
  LeafWire      block-top-k                         (values f32, local idx
                                                    int32), (nb, kb) each
  FlatSparse    top-k, scaled rand-k, comp-(k,k'),  (values f32, global idx
                mix-(k,k'), frac-*                  int32), (k,) each
  RandKSparse   rand-k                              as FlatSparse
  SignPack      sign (L1-norm scaled)               f32 scale + 32-bit bitmap
  QsgdQuant     QSGD(s)                             f32 norm + int8/16 levels
  NaturalPack   natural compression                 int8 exponents + bitmap
  DensePack     identity, m-nice (and any other)    f32 values

with the flat :class:`WireFormat` over a params tree, uplink and downlink,
and its federated accounting (``bits_per_round(participants=)``,
:func:`federated_round_bits`); the participation gate
(:func:`mask_message`, a scalar or an (n,) mask); and the pieces of the
pipelined exchange: the decode-zero priming message
(:func:`zero_message`, through each codec's ``mask_message``), the
worker-axis chunk rule (:func:`pipeline_chunks`) and the chunked
decode-sum (:func:`chunked_decode_sum`).  The wire dtypes other than f32,
the per-leaf ``TreeWire``, fleets and the serving envelopes are not yet
ported.  A bitmap's uint32 words are held as int32 with the same bits
(torch has no uint32 arithmetic on the CPU).

Kernel dispatch of the fused packs (``REPRO_TORCH_WIRE_KERNEL`` or the
``kernel=`` argument): ``auto`` goes through the kernel wrapper, which
launches the CUDA kernel on a CUDA tensor and runs its plain version on a
CPU tensor; ``cuda`` does the same but raises for a tensor that is not on
CUDA; ``oracle`` takes the codec's plain encode -> decode -> update, the
reference the tests hold the others against.  The wrappers' two sides
match the Pallas kernels bit for bit.  Codecs without a kernel run their
plain encode -> decode -> update under ``auto`` and ``oracle``, and raise
under ``cuda``.  A block-top-k leaf whose block is not a multiple of 128
takes the plain path under ``auto``, as JAX's ``fused_pack`` does.

For block-top-k the oracle matches JAX's jnp oracle, which differs from the
kernel in two places: it gathers a selected -0.0 as -0.0 (the kernel sends
+0.0), and it ranks a NaN above every number (a row of the kernel that
holds a NaN sends (0.0, 0) in every slot).  For QSGD and rand-k the oracle
and the kernel agree bit for bit, as JAX's two paths do when neither is
contracted to an FMA.

QSGD's norm ||g - h||_2 is torch's reduction, which may differ from XLA's
in its last bits, so a level can flip against the JAX package.  The kernel
wrapper is held bitwise given the norm (its ``norm`` argument); the codec
computes its own.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core import compressors as cz
from repro_torch.kernels import ops
from repro_torch.kernels.ref import level_dtype, to_levels, topk_rows

PyTree = Any
KERNEL_MODES = ("auto", "cuda", "oracle")
MASK32 = 0xFFFFFFFF


def _kernel_mode(kernel: Optional[str], x: torch.Tensor) -> str:
    mode = kernel or os.environ.get("REPRO_TORCH_WIRE_KERNEL", "auto")
    if mode not in KERNEL_MODES:
        raise ValueError(f"wire kernel {mode!r} not in {KERNEL_MODES}")
    if mode == "cuda" and not x.is_cuda:
        raise ValueError(f"wire kernel 'cuda' needs a CUDA tensor, got one "
                         f"on {x.device}")
    return mode


# ---------------------------------------------------------------------------
# bit packing (sign bitmaps)
# ---------------------------------------------------------------------------

def bitmap_words(nbits: int) -> int:
    return -(-nbits // 32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(m,) boolean -> (ceil(m/32),) 32-bit words, LSB-first within each
    word, as int32 holding the uint32 bits of JAX's ``pack_bits``."""
    m = bits.numel()
    w = bitmap_words(m)
    b = torch.nn.functional.pad(bits.reshape(-1).to(torch.int64),
                                (0, 32 * w - m)).reshape(w, 32)
    words = (b << torch.arange(32, device=bits.device)).sum(dim=1)
    return torch.where(words > 0x7FFFFFFF, words - 2**32, words).to(
        torch.int32)


def unpack_bits(words: torch.Tensor, m: int) -> torch.Tensor:
    """(w,) 32-bit words -> (m,) boolean, the inverse of
    :func:`pack_bits`."""
    u = words.to(torch.int64) & MASK32
    b = (u[:, None] >> torch.arange(32, device=words.device)) & 1
    return b.reshape(-1)[:m].to(torch.bool)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

class LeafCodec:
    """What the codecs share: a frozen dataclass with ``shape`` and
    ``size``, exact ``payload_bits``, ``encode`` of the flat f32 innovation
    into a payload tuple and ``decode`` back to the compressor's dense
    output, bit for bit."""

    kind = "abstract"
    #: ndim of the first payload component of one (un-stacked) message
    MSG_NDIM = 1

    def mask_message(self, payload: Sequence[torch.Tensor], m
                     ) -> Tuple[torch.Tensor, ...]:
        """Gate a message on the participation ``m``, a scalar for one
        message or an (n,) mask for the worker-stacked form
        (:func:`mask_message`)."""
        return mask_message(payload, m)

    def decode_sum(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        """Payload, worker-stacked on a leading axis or not -> dense flat
        (size,) sum of the decoded workers, added to zeros in ascending
        worker order, as XLA sums the worker axis (so -0.0 + -0.0 sums to
        +0.0)."""
        if payload[0].dim() == self.MSG_NDIM:
            return self.decode(payload)
        out = torch.zeros(self.size, dtype=torch.float32,
                          device=payload[0].device)
        for i in range(payload[0].shape[0]):
            out = out + self.decode(tuple(a[i] for a in payload))
        return out

    def encode_update(self, key, g: torch.Tensor, h: torch.Tensor,
                      lam: float, *, kernel: Optional[str] = None):
        """(payload, h'): encode -> decode -> h' = h + lam * d, each op
        rounded on its own.  There is no kernel: ``cuda`` raises."""
        if _kernel_mode(kernel, g) == "cuda":
            raise ValueError(f"{type(self).__name__} of {self.size} values "
                             "has no CUDA kernel; use 'auto' or 'oracle'")
        delta = g.reshape(-1).float() - h.reshape(-1).float()
        payload = self.encode(key, delta)
        del delta
        d = self.decode(payload).reshape(g.shape)
        return payload, (h.float() + lam * d).to(h.dtype)


@dataclasses.dataclass(frozen=True)
class LeafWire(LeafCodec):
    """Block-sparse layout of one leaf: per-block (values, block-LOCAL
    indices), shapes (nb, kb) each.  Local indices stay below ``block``, so
    the same scatter-add decodes one message and the worker-stacked
    (n, nb, kb) all-gather result."""

    shape: Tuple[int, ...]
    size: int
    block: int
    kb: int

    kind = "block_sparse"
    MSG_NDIM = 2

    @property
    def nb(self) -> int:
        return -(-self.size // self.block)

    @property
    def payload_bits(self) -> int:
        """Exact bits of one worker's message for this leaf: f32 values +
        int32 local indices, (nb, kb) each."""
        return self.nb * self.kb * (32 + 32)

    def encode(self, key, delta: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat f32 innovation -> (values f32, local indices int32), the
        layout spec (:func:`pack_oracle`); ``key`` is not used."""
        vals, idx = pack_oracle(self, delta)
        return vals.to(torch.float32), idx

    def decode_sum(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        """One message (nb, kb) or worker-stacked (n, nb, kb) -> dense flat
        (size,) scatter-add."""
        vals, idx = payload
        return scatter_add(self, vals.float(), idx)

    decode = decode_sum

    def encode_update(self, key, g: torch.Tensor, h: torch.Tensor,
                      lam: float, *, kernel: Optional[str] = None):
        """Fused compress-and-pack worker update (block-top-k is
        deterministic: ``key`` is not used)."""
        return fused_pack(self, g, h, lam, kernel=kernel)


@dataclasses.dataclass(frozen=True)
class QsgdQuant(LeafCodec):
    """QSGD(s): one f32 L2 norm + a signed integer level stream, level in
    [-s, s] (int8 when s <= 127, int16 otherwise): 32 + 8*d (or 16*d)
    bits."""

    shape: Tuple[int, ...]
    size: int
    s: int

    kind = "qsgd_quant"

    @property
    def level_dtype(self) -> torch.dtype:
        return level_dtype(self.s)

    @property
    def payload_bits(self) -> int:
        return 32 + self.size * (8 if self.s <= 127 else 16)

    def encode(self, key, delta: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat f32 innovation -> (norm (1,) f32, levels (size,)): QSGD's
        stochastic rounding with the uniforms of
        ``jax.random.uniform(key, (size,))``."""
        norm = torch.linalg.vector_norm(delta)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        level = delta.abs() / safe * self.s
        low = torch.floor(level)
        up = random.uniform(key, delta.numel(), delta.device) < (level - low)
        levels = to_levels(torch.sign(delta) * (low + up.to(torch.float32)),
                           self.s)
        return norm.reshape(1).to(torch.float32), levels

    def decode(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        """One payload -> dense flat f32 (size,):
        (norm * sign) * (|level| * f32(1/s)) where level != 0, else 0."""
        norm, lv = payload
        lf = lv.to(torch.float32)
        return torch.where(
            lf != 0,
            (norm[0] * torch.sign(lf))
            * (lf.abs() * float(np.float32(1.0 / self.s))),
            torch.zeros_like(lf))

    def encode_update(self, key, g: torch.Tensor, h: torch.Tensor,
                      lam: float, *, kernel: Optional[str] = None):
        """(payload, h') with the levels of QSGD(g - h) and
        h' = h + lam * decode(payload).  ``auto`` and ``cuda`` run the fused
        kernel wrapper on the uniforms of ``key``; ``oracle`` is encode ->
        decode -> update.  Both are bitwise equal given the norm."""
        mode = _kernel_mode(kernel, g)
        delta = g.reshape(-1).float() - h.reshape(-1).float()
        if mode == "oracle":
            payload = self.encode(key, delta)
            d = self.decode(payload).reshape(g.shape)
            return payload, (h.float() + lam * d).to(h.dtype)
        norm = torch.linalg.vector_norm(delta).reshape(1)
        del delta  # not alive beside u and h_out: 4 B less per value at peak
        u = random.uniform(key, self.size, g.device)
        levels, h_new = ops.qsgd_pack_update(g, h, u, norm, lam, self.s)
        return (norm, levels), h_new


@dataclasses.dataclass(frozen=True)
class FlatSparse(LeafCodec):
    """(values f32, global int32 indices), (k,) each: k * (32 + 32) bits.
    ``selector`` is the compressor whose ``encode`` picks the k kept
    coordinates and applies any unbiasedness scaling."""

    shape: Tuple[int, ...]
    size: int
    k: int
    selector: Any

    kind = "flat_sparse"

    @property
    def payload_bits(self) -> int:
        return self.k * (32 + 32)

    def encode(self, key, delta: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        vals, idx = self.selector.encode(key, delta)
        return vals.to(torch.float32), idx.to(torch.int32)

    def decode(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        """One payload -> dense flat f32 (size,): the values added into
        zeros at their indices."""
        vals, idx = payload
        out = torch.zeros(self.size, dtype=torch.float32, device=vals.device)
        return out.index_add_(0, idx.reshape(-1).long(),
                              vals.reshape(-1).float())

    def decode_sum(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        """Payload, worker-stacked (n, k) or not -> dense flat (size,) sum.
        The stacked form adds worker by worker in ascending order, one
        ``index_add_`` each: XLA's scatter of the n * k pairs adds them in
        that order, and a single scatter on the card would add duplicates
        across workers in any order (exact for n = 2 only)."""
        vals, idx = payload
        if vals.dim() == 1:
            return self.decode(payload)
        out = torch.zeros(self.size, dtype=torch.float32, device=vals.device)
        for i in range(vals.shape[0]):
            out.index_add_(0, idx[i].long(), vals[i].float())
        return out


@dataclasses.dataclass(frozen=True)
class RandKSparse(FlatSparse):
    """FlatSparse of rand-k: the positions do not depend on the data, so
    they are drawn first (``random.choice``) and the fused kernel computes
    the payload values and h' = h + lam * d in one pass, the dense d never
    in device memory."""

    kind = "randk_sparse"

    @property
    def has_kernel(self) -> bool:
        """Codec metadata as in the JAX package, whose Pallas kernel
        compares f32 positions, exact below 2**24.  The CUDA kernel has no
        such limit and runs on every leaf; nothing dispatches on this."""
        return self.size < 2 ** 24

    @property
    def scale(self) -> float:
        """f32(size / k), the unbiasedness scaling of the values."""
        return float(np.float32(self.size / self.k))

    def encode_update(self, key, g: torch.Tensor, h: torch.Tensor,
                      lam: float, *, kernel: Optional[str] = None):
        """(payload, h').  ``auto`` and ``cuda`` take the kernel wrapper,
        ``oracle`` the plain encode -> decode -> update.  Both give the
        same bits: the decode's 0.0 + v differs from v only for v = -0.0,
        which (g - h) * scale is only where h = +0.0, and h + lam * (+-0.0)
        is then +0.0 either way."""
        mode = _kernel_mode(kernel, g)
        if mode == "oracle":
            return LeafCodec.encode_update(self, key, g, h, lam,
                                           kernel=mode)
        idx = random.choice(key, self.size, self.k, g.device)
        vals, h_new = ops.randk_update(g, h, idx, lam, self.scale)
        return (vals, idx), h_new


@dataclasses.dataclass(frozen=True)
class SignPack(LeafCodec):
    """L1-norm-scaled sign: one f32 scale + an LSB-first 32-bit sign bitmap
    (bit set <=> value negative): 32 + 32 * ceil(d/32) bits.  The scale's
    sum is torch's reduction (ROADMAP fault c)."""

    shape: Tuple[int, ...]
    size: int

    kind = "sign_pack"

    @property
    def payload_bits(self) -> int:
        return 32 + 32 * bitmap_words(self.size)

    def encode(self, key, delta: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = delta.abs().sum() / delta.numel()
        return scale.reshape(1).to(torch.float32), pack_bits(delta < 0)

    def decode(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        scale, words = payload
        return scale[0] * torch.where(unpack_bits(words, self.size), -1.0,
                                      1.0)


@dataclasses.dataclass(frozen=True)
class NaturalPack(LeafCodec):
    """Natural compression: an int8 power-of-two exponent per value
    (sentinel -128 for an exact zero) + a 32-bit sign bitmap:
    8 * d + 32 * ceil(d/32) bits.  Exponents are clipped to [-126, 127]
    (exact on the normal f32 range).  Encode and decode take exponents
    exactly (``compressors.floor_log2``, ``exp2_int``), so the stream is
    lossless; the JAX package's come from XLA's inexact f32 ``log2`` and
    ``exp2`` (ROADMAP fault j)."""

    shape: Tuple[int, ...]
    size: int

    kind = "natural_pack"

    @property
    def payload_bits(self) -> int:
        return 8 * self.size + 32 * bitmap_words(self.size)

    def encode(self, key, delta: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        a = delta.abs()
        es = cz.natural_exponent(key, a).clamp(-126.0, 127.0)
        exps = torch.where(a > 0, es, -128.0).to(torch.int8)
        return exps, pack_bits(delta < 0)

    def decode(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        exps, words = payload
        mag = cz.exp2_int(exps.to(torch.float32))
        sgn = torch.where(unpack_bits(words, self.size), -1.0, 1.0)
        return torch.where(exps == -128, 0.0, sgn * mag)

    def mask_message(self, payload, m):
        """Zero is the sentinel exponent -128, not a value to scale: an
        absent worker's (m = 0) stream becomes the sentinel; m = 1 keeps
        it as it is.  ``m`` is a scalar or an (n,) mask over the
        worker-stacked streams."""
        exps, words = payload
        mm = _mask_like(m, exps)
        return torch.where(mm > 0, exps, torch.full_like(exps, -128)), words


@dataclasses.dataclass(frozen=True)
class DensePack(LeafCodec):
    """The compressor's dense output as raw f32 values: size * 32 bits.
    The codec of identity and m-nice, and of any compressor that declares
    no layout of its own."""

    shape: Tuple[int, ...]
    size: int
    compressor: Any

    kind = "dense_pack"

    @property
    def payload_bits(self) -> int:
        return self.size * 32

    def encode(self, key, delta: torch.Tensor) -> Tuple[torch.Tensor]:
        y = self.compressor(key, delta.reshape(self.shape))
        return (y.reshape(-1).to(torch.float32),)

    def decode(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        (vals,) = payload
        return vals.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Payload layout for a whole params tree (leaf order = flatten order)."""

    leaves: Tuple[Any, ...]

    def bits_per_round(self, *, n_workers: int = 1,
                       participants: Optional[float] = None):
        """Exact uplink bits one round puts on the wire: per worker when
        n_workers == 1 (the paper's per-node accounting), total otherwise.

        ``participants`` switches to the federated round: an n-worker
        participation bitmap (whole 32-bit words) plus only |S_t|
        payloads.  An integer count gives exact ``int`` bits; a fractional
        expected count p * n gives the expected accounting as a ``float``
        (the only case that returns one)."""
        per_worker = sum(l.payload_bits for l in self.leaves)
        if participants is None:
            return n_workers * per_worker
        bitmap = 32 * bitmap_words(n_workers)
        if float(participants).is_integer():
            return bitmap + int(participants) * per_worker
        return bitmap + participants * per_worker

    def downlink_bits_per_round(self) -> int:
        """Exact bits of the ONE master -> worker broadcast message of a
        round: a single payload whatever n is."""
        return sum(l.payload_bits for l in self.leaves)

    def dense_bits(self) -> int:
        """The fp32 dense baseline for this tree (one full copy)."""
        return 32 * sum(l.size for l in self.leaves)


def total_round_bits(up: WireFormat, down: WireFormat, *,
                     n_workers: int, participants: Optional[float] = None):
    """Exact wire bits of one full round, both directions: n_workers uplink
    payloads (federated: the participation bitmap and |S_t| payloads)
    plus the one downlink broadcast, which absent workers decode too."""
    return up.bits_per_round(n_workers=n_workers,
                             participants=participants) + \
        down.downlink_bits_per_round()


def federated_round_bits(fmt: WireFormat, mask) -> int:
    """Exact wire bits of one federated round given its concrete (n,)
    mask: the participation bitmap plus the |S_t| sampled payloads."""
    m = torch.as_tensor(mask)
    return fmt.bits_per_round(n_workers=int(m.shape[0]),
                              participants=int(m.sum()))


def clamp_for_leaf(compressor, size: int):
    """The compressor with its selection counts clamped to one leaf of
    ``size`` values (``wire.clamp_for_leaf``): the k of top-k, rand-k and
    scaled rand-k, comp-(k,k') and mix-(k,k'), and block-top-k's kb.  The
    same object when nothing changes; the size-adaptive members pass
    through."""
    d = int(size)
    cmp = compressor
    if isinstance(cmp, cz.MixKK):
        k = min(cmp.k, d)
        kp = min(cmp.kp, d - k)
        if (k, kp) != (cmp.k, cmp.kp):
            return dataclasses.replace(cmp, k=k, kp=kp)
    elif isinstance(cmp, cz.CompKK):
        kp = min(cmp.kp, d)
        k = min(cmp.k, kp)
        if (k, kp) != (cmp.k, cmp.kp):
            return dataclasses.replace(cmp, k=k, kp=kp)
    elif isinstance(cmp, (cz.TopK, cz.RandK, cz.ScaledRandK)):
        if cmp.k > d:
            return dataclasses.replace(cmp, k=d)
    elif isinstance(cmp, cz.BlockTopK):
        kb = min(cmp.kb, cmp.block, d)
        if kb != cmp.kb:
            return dataclasses.replace(cmp, kb=kb)
    return compressor


def codec_of(compressor, shape: Tuple[int, ...], size: int,
             wire_dtype: str = "float32"):
    """The codec ``compressor`` declares for one leaf, after
    :func:`clamp_for_leaf` (a dense value stream for an object that
    declares none)."""
    if wire_dtype != "float32":
        raise NotImplementedError(
            f"wire dtype {wire_dtype!r} is not yet ported (float32 only)")
    compressor = clamp_for_leaf(compressor, size)
    fn = getattr(compressor, "codec", None)
    if fn is None:
        return DensePack(shape=tuple(shape), size=int(size),
                         compressor=compressor)
    return fn(tuple(shape))


def format_for(compressor, tree: PyTree, *,
               wire_dtype: str = "float32") -> WireFormat:
    """WireFormat for ``compressor`` applied leaf-wise to ``tree`` (tensors
    of any device, ``meta`` included)."""
    return WireFormat(tuple(
        codec_of(compressor, tuple(leaf.shape), leaf.numel(), wire_dtype)
        for leaf in T.leaves(tree)))


def leaf_paths(tree: PyTree) -> Tuple[str, ...]:
    """'/'-joined path string of every leaf, in flatten order."""
    return tuple("/".join(p) for p, _ in T.flatten_with_path(tree))


def payload_bytes(payload: PyTree) -> int:
    """Measured bytes of a payload tree (what actually crosses the wire)."""
    return sum(a.numel() * a.element_size() for a in T.leaves(payload))


# ---------------------------------------------------------------------------
# block-sparse pack / scatter-add (the layout spec)
# ---------------------------------------------------------------------------

def _pad2d(xf: torch.Tensor, lw: LeafWire) -> torch.Tensor:
    pad = lw.nb * lw.block - lw.size
    return torch.nn.functional.pad(xf, (0, pad)).reshape(lw.nb, lw.block)


def pack_oracle(lw: LeafWire, delta: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, local indices), (nb, kb) each: the layout every fused
    producer matches bit for bit."""
    xp = _pad2d(delta.reshape(-1), lw)
    idx = topk_rows(xp.abs(), lw.kb)
    vals = torch.gather(xp, 1, idx)
    return vals, idx.to(torch.int32)


def scatter_add(lw: LeafWire, vals: torch.Tensor, idx: torch.Tensor
                ) -> torch.Tensor:
    """Payload -> dense flat (size,) vector.

    Accepts one message (nb, kb) or the worker-stacked all-gather result
    (n, nb, kb); the stacked form is scatter-SUMMED per block (divide by n
    for the mean), one ``scatter_add_`` per worker in ascending order.
    Within one message the indices of a block are distinct; across workers
    they repeat, and one scatter of all n * kb pairs would add the repeats
    in any order on the card (atomics), which differs from XLA's ascending
    order, and from run to run, once n >= 3."""
    out = torch.zeros((lw.nb, lw.block), dtype=vals.dtype, device=vals.device)
    if vals.dim() == 2:
        vals, idx = vals[None], idx[None]
    for i in range(vals.shape[0]):
        out.scatter_add_(1, idx[i].long(), vals[i])
    return out.reshape(-1)[:lw.size]


def fused_pack(lw: LeafWire, g: torch.Tensor, h: torch.Tensor, lam: float, *,
               kernel: Optional[str] = None
               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """d = block_topk(g - h) packed as (values, indices); h' = h + lam d.

    ``auto`` and ``cuda`` go through the kernel wrapper (one pass, dense d
    never in device memory), which raises on a CUDA tensor for a block the
    kernel does not take; ``oracle`` takes the plain layout spec.  As in
    the JAX package, ``auto`` routes a block with block % 128 != 0 (which
    no kernel tiles) to the plain layout spec on any device, by its shape
    alone and before any launch; an explicit ``cuda`` raises there."""
    mode = _kernel_mode(kernel, g)
    if mode == "auto" and lw.block % 128:
        mode = "oracle"
    if mode != "oracle":
        return ops.efbv_pack_update(g, h, lam, block=lw.block, kb=lw.kb)
    delta = g.float() - h.float()
    vals, idx = pack_oracle(lw, delta)
    d = scatter_add(lw, vals, idx).reshape(lw.shape)
    h_new = (h.float() + lam * d).to(h.dtype)
    return (vals.to(g.dtype), idx), h_new


def encode_update(codec, key, g: torch.Tensor, h: torch.Tensor,
                  lam: float, *, kernel: Optional[str] = None):
    """Fused compress-and-pack worker update through ``codec`` (f32
    gradients; other wire dtypes are not yet ported).  ``key`` feeds the
    stochastic codecs; the deterministic ones ignore it."""
    if g.dtype != torch.float32:
        raise NotImplementedError(
            f"the wire of the port takes f32 gradients, got {g.dtype}")
    return codec.encode_update(key, g, h, lam, kernel=kernel)


# ---------------------------------------------------------------------------
# the pipelined exchange
# ---------------------------------------------------------------------------

def _mask_like(m, x: torch.Tensor) -> torch.Tensor:
    """The participation ``m`` (a scalar, or an (n,) mask over a leading
    worker axis) as a tensor on ``x``'s device that broadcasts against
    ``x``."""
    mm = torch.as_tensor(m, device=x.device)
    return mm.reshape(tuple(mm.shape) + (1,) * (x.dim() - mm.dim()))


def mask_message(payload: Sequence[torch.Tensor], m
                 ) -> Tuple[torch.Tensor, ...]:
    """Gate a message on the participation ``m``: scale its leading
    value-carrying component (sparse values, sign scale, QSGD norm, dense
    stream) by ``m`` in that component's dtype.  m = 0 makes the message
    decode to exactly zero, and m = 1 is a bitwise identity.  ``m`` is a
    scalar for one message or an (n,) mask for the worker-stacked form."""
    head, *rest = payload
    return (head * _mask_like(m, head).to(head.dtype), *rest)


def zero_message(codec, key, device) -> Tuple[torch.Tensor, ...]:
    """The decode-zero payload of ``codec`` on ``device``: a real wire
    message (the encode of the zero vector, masked to zero, so a stochastic
    codec decodes to exactly zero too).  It primes the pipelined schedule's
    round-0 in-flight slot; every path draws it from the same key,
    ``fold_in(fold_in(key(0), PIPELINE_FOLD), j)`` for leaf j."""
    payload = codec.encode(key, torch.zeros(codec.size, dtype=torch.float32,
                                            device=device))
    return codec.mask_message(payload, 0.0)


def pipeline_chunks(n_workers: int) -> int:
    """Worker-axis chunk count of the pipelined exchange: gcd(n, 4) for
    n >= 4, else 1 (the JAX package's rule, so both decode-sum in the same
    chunks and therefore the same order)."""
    n = int(n_workers)
    return math.gcd(n, 4) if n >= 4 else 1


def chunked_decode_sum(codec, payload, chunks: int) -> torch.Tensor:
    """decode_sum of a worker-stacked payload with the worker axis split
    into ``chunks`` equal slices, the partial sums added in ascending chunk
    order.  ``chunks=1`` is ``codec.decode_sum`` itself."""
    if chunks <= 1:
        return codec.decode_sum(payload)
    n = payload[0].shape[0]
    if n % chunks:
        raise ValueError(f"{n} stacked messages do not split into {chunks} "
                         "equal chunks")
    cs = n // chunks
    total = None
    for c in range(chunks):
        dec = codec.decode_sum(tuple(a[c * cs:(c + 1) * cs] for a in payload))
        total = dec if total is None else total + dec
    return total
