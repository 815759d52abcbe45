"""Wire codecs: payload layouts, exact bit accounting, and the pack /
scatter-add helpers of the wire (``repro/distributed/wire.py``).

Every codec of the JAX zoo's compressors:

  codec         compressors                         payload of one leaf
  ------------  ----------------------------------  --------------------------
  LeafWire      block-top-k                         (values, local idx
                                                    int32), (nb, kb) each
  FlatSparse    top-k, scaled rand-k, comp-(k,k'),  (values, global idx
                mix-(k,k'), frac-*                  int32), (k,) each
  RandKSparse   rand-k                              as FlatSparse
  SignPack      sign (L1-norm scaled)               f32 scale + 32-bit bitmap
  QsgdQuant     QSGD(s)                             f32 norm + int8/16 levels
  NaturalPack   natural compression                 int8 exponents + bitmap
  DensePack     identity, m-nice (and any other)    values

``val_dtype`` (float32, bfloat16 or float16) is the type of the values of
LeafWire, FlatSparse and DensePack; scales, norms, levels, signs and
exponents keep theirs.  A value rounds to nearest even into the wire type
and the decode reads it back exactly, so the control variate tracks the
rounded values: a non-f32 wire takes the plain encode -> decode -> update
path, as the JAX package's does.

The flat :class:`WireFormat` over a params tree, uplink and downlink,
and its federated accounting (``bits_per_round(participants=)``,
:func:`federated_round_bits`); the participation gate
(:func:`mask_message`, a scalar or an (n,) mask); and the pieces of the
pipelined exchange: the decode-zero priming message
(:func:`zero_message`, through each codec's ``mask_message``), the
worker-axis chunk rule (:func:`pipeline_chunks`) and the chunked
decode-sum (:func:`chunked_decode_sum`); a heterogeneous fleet's
per-worker formats (:func:`fleet_formats`, :func:`fleet_bits_per_round`);
and the per-leaf wire: the codec rules' grammar (:func:`parse_leaf_rules`,
:func:`resolve_leaf`), :class:`TreeWire` and :func:`tree_format_for`; and
the serving downlink's versioned push envelope (:class:`DeltaEnvelope`,
:func:`push_bits`, :func:`checkpoint_push_bits`).  A bitmap's uint32 words
are held as int32 with the same bits (torch has no uint32 arithmetic on
the CPU).

Kernel dispatch of the fused packs (``REPRO_TORCH_WIRE_KERNEL`` or the
``kernel=`` argument): ``auto`` goes through the kernel wrapper, which
launches the CUDA kernel on a CUDA tensor and runs its plain version on a
CPU tensor; ``cuda`` does the same but raises for a tensor that is not on
CUDA; ``oracle`` takes the codec's plain encode -> decode -> update, the
reference the tests hold the others against.  The wrappers' two sides
match the Pallas kernels bit for bit.  Codecs without a kernel run their
plain encode -> decode -> update under ``auto`` and ``oracle``, and raise
under ``cuda``.  A block-top-k leaf whose block is not a multiple of 128,
and a block-top-k or rand-k leaf on a non-f32 wire, take the plain path
under ``auto``, by shape and type before any launch, as the JAX package's
dispatch routes them; ``cuda`` raises there.

The plain path's h' = h + lam * d rounds each op on its own, as JAX's
base ``encode_update`` computes it outside ``jit``.  The trainer's worker
update (``contract=True``, from ``aggregate.compress_local``) rounds it
as XLA does under ``jit``: one fused multiply-add, except after a decode
that ends in a select (``LeafCodec.DECODE_SELECTS``: QSGD, natural), where
the two roundings stay (ROADMAP faults a and r).

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
import fnmatch
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
#: the wire's value dtypes by name
VAL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}


def val_torch_dtype(val_dtype: str) -> torch.dtype:
    """The torch type of a wire value dtype's name."""
    if val_dtype not in VAL_DTYPES:
        raise ValueError(f"wire value dtype {val_dtype!r} not in "
                         f"{tuple(VAL_DTYPES)}")
    return VAL_DTYPES[val_dtype]


def _val_bits(val_dtype: str) -> int:
    return 8 * val_torch_dtype(val_dtype).itemsize


def to_wire(x: torch.Tensor, val_dtype: str) -> torch.Tensor:
    """f32 values in the wire type, rounded to nearest even as XLA
    converts them; a NaN becomes bf16's quiet NaN of its sign, as in XLA
    (torch's conversion on the CPU gives 0xffff for every NaN)."""
    y = x.to(val_torch_dtype(val_dtype))
    if y.dtype != torch.bfloat16:
        return y
    qnan = torch.where(torch.signbit(x), -0x40, 0x7FC0).to(torch.int16)
    return torch.where(x.isnan(), qnan.view(torch.bfloat16), y)


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
    #: a fused kernel computes this leaf's payload and h'
    has_kernel = False
    #: the decode ends in a select against zero (``where(..., v, 0)``):
    #: under ``jit`` XLA keeps a product applied to it inside the select,
    #: so a downlink's w + lam * q rounds twice (every other decode's
    #: update is one fused rounding)
    DECODE_SELECTS = False

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

    def update(self, h: torch.Tensor, d: torch.Tensor, lam: float,
               contract: bool = False) -> torch.Tensor:
        """h + lam * d of the decoded d, in h's type: each op rounded on
        its own, or with ``contract`` as XLA rounds it under ``jit``, one
        fused multiply-add unless the decode ends in a select."""
        if contract and not self.DECODE_SELECTS:
            return torch.add(h.float(), d, alpha=lam).to(h.dtype)
        return (h.float() + lam * d).to(h.dtype)

    def encode_update(self, key, g: torch.Tensor, h: torch.Tensor,
                      lam: float, *, kernel: Optional[str] = None,
                      contract: bool = False):
        """(payload, h'): encode -> decode -> h' = h + lam * d
        (:meth:`update`).  There is no kernel: ``cuda`` raises."""
        if _kernel_mode(kernel, g) == "cuda":
            raise ValueError(f"{type(self).__name__} of {self.size} values "
                             f"on a {getattr(self, 'val_dtype', 'float32')} "
                             "wire has no CUDA kernel; use 'auto' or "
                             "'oracle'")
        delta = g.reshape(-1).float() - h.reshape(-1).float()
        payload = self.encode(key, delta)
        del delta
        d = self.decode(payload).reshape(g.shape)
        return payload, self.update(h, d, lam, contract)


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
    val_dtype: str = "float32"

    kind = "block_sparse"
    MSG_NDIM = 2

    @property
    def nb(self) -> int:
        return -(-self.size // self.block)

    @property
    def payload_bits(self) -> int:
        """Exact bits of one worker's message for this leaf: values +
        int32 local indices, (nb, kb) each."""
        return self.nb * self.kb * (_val_bits(self.val_dtype) + 32)

    @property
    def has_kernel(self) -> bool:
        """The pack kernel takes this leaf: block % 128 == 0 on an f32
        wire (it updates h with the f32 values, which equal the decoded
        payload only there)."""
        return self.block % 128 == 0 and self.val_dtype == "float32"

    def encode(self, key, delta: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat f32 innovation -> (values, local indices int32), the
        layout spec (:func:`pack_oracle`); ``key`` is not used."""
        vals, idx = pack_oracle(self, delta)
        return to_wire(vals, self.val_dtype), idx

    def decode_sum(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        """One message (nb, kb) or worker-stacked (n, nb, kb) -> dense flat
        (size,) scatter-add."""
        vals, idx = payload
        return scatter_add(self, vals.float(), idx)

    decode = decode_sum

    def encode_update(self, key, g: torch.Tensor, h: torch.Tensor,
                      lam: float, *, kernel: Optional[str] = None,
                      contract: bool = False):
        """Fused compress-and-pack worker update (block-top-k is
        deterministic: ``key`` is not used).  A non-f32 wire takes the
        plain path (``cuda`` raises there)."""
        if self.val_dtype != "float32":
            return LeafCodec.encode_update(self, key, g, h, lam,
                                           kernel=kernel, contract=contract)
        return fused_pack(self, g, h, lam, kernel=kernel, contract=contract)


@dataclasses.dataclass(frozen=True)
class QsgdQuant(LeafCodec):
    """QSGD(s): one f32 L2 norm + a signed integer level stream, level in
    [-s, s] (int8 when s <= 127, int16 otherwise): 32 + 8*d (or 16*d)
    bits."""

    shape: Tuple[int, ...]
    size: int
    s: int

    kind = "qsgd_quant"
    DECODE_SELECTS = True
    has_kernel = True

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
                      lam: float, *, kernel: Optional[str] = None,
                      contract: bool = False):
        """(payload, h') with the levels of QSGD(g - h) and
        h' = h + lam * decode(payload).  ``auto`` and ``cuda`` run the fused
        kernel wrapper on the uniforms of ``key``; ``oracle`` is encode ->
        decode -> update.  Both are bitwise equal given the norm; the decode
        ends in a select, so ``contract`` changes nothing."""
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
    """(values, global int32 indices), (k,) each: k * (value bits + 32)
    bits.  ``selector`` is the compressor whose ``encode`` picks the k kept
    coordinates and applies any unbiasedness scaling."""

    shape: Tuple[int, ...]
    size: int
    k: int
    selector: Any
    val_dtype: str = "float32"

    kind = "flat_sparse"

    @property
    def payload_bits(self) -> int:
        return self.k * (_val_bits(self.val_dtype) + 32)

    def encode(self, key, delta: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        vals, idx = self.selector.encode(key, delta)
        return to_wire(vals, self.val_dtype), idx.to(torch.int32)

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
        compares f32 positions, exact below 2**24, on an f32 wire.  The
        CUDA kernel has no size limit and runs on every f32 leaf; only
        the wire dtype is dispatched on."""
        return self.size < 2 ** 24 and self.val_dtype == "float32"

    @property
    def scale(self) -> float:
        """f32(size / k), the unbiasedness scaling of the values."""
        return float(np.float32(self.size / self.k))

    def encode_update(self, key, g: torch.Tensor, h: torch.Tensor,
                      lam: float, *, kernel: Optional[str] = None,
                      contract: bool = False):
        """(payload, h').  ``auto`` and ``cuda`` take the kernel wrapper,
        ``oracle`` the plain encode -> decode -> update.  Both give the
        same bits: the decode's 0.0 + v differs from v only for v = -0.0,
        which (g - h) * scale is only where h = +0.0, and h + lam * (+-0.0)
        is then +0.0 either way.  A non-f32 wire takes the plain path with
        the trainer's ``contract`` rounding (``cuda`` raises there)."""
        mode = _kernel_mode(kernel, g)
        if self.val_dtype != "float32":
            return LeafCodec.encode_update(self, key, g, h, lam,
                                           kernel=kernel, contract=contract)
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
    sum is torch's reduction (ROADMAP fault c), times f32(1/d)."""

    shape: Tuple[int, ...]
    size: int

    kind = "sign_pack"

    @property
    def payload_bits(self) -> int:
        return 32 + 32 * bitmap_words(self.size)

    def encode(self, key, delta: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the f32 scale sum|delta| * f32(1/d), as XLA computes the
        division by a constant, and the sign bitmap)."""
        scale = delta.abs().sum() * cz._f32(1.0 / delta.numel())
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
    DECODE_SELECTS = True

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
    """The compressor's dense output as raw values of the wire type:
    size * value bits.  The codec of identity and m-nice, and of any
    compressor that declares no layout of its own."""

    shape: Tuple[int, ...]
    size: int
    compressor: Any
    val_dtype: str = "float32"

    kind = "dense_pack"

    @property
    def payload_bits(self) -> int:
        return self.size * _val_bits(self.val_dtype)

    def encode(self, key, delta: torch.Tensor) -> Tuple[torch.Tensor]:
        y = self.compressor(key, delta.reshape(self.shape))
        return (to_wire(y.reshape(-1), self.val_dtype),)

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


def total_round_bits(up: WireFormat, down: Optional[WireFormat], *,
                     n_workers: int, participants: Optional[float] = None):
    """Exact wire bits of one full round, both directions: n_workers uplink
    payloads (federated: the participation bitmap and |S_t| payloads)
    plus the one downlink broadcast, which absent workers decode too (a
    dense f32 broadcast when ``down`` is None)."""
    down_bits = (up.dense_bits() if down is None
                 else down.downlink_bits_per_round())
    return up.bits_per_round(n_workers=n_workers,
                             participants=participants) + down_bits


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
    """The codec ``compressor`` declares for one leaf on a ``wire_dtype``
    wire, after :func:`clamp_for_leaf` (a dense value stream for an object
    that declares none)."""
    compressor = clamp_for_leaf(compressor, size)
    fn = getattr(compressor, "codec", None)
    if fn is None:
        return DensePack(shape=tuple(shape), size=int(size),
                         compressor=compressor, val_dtype=wire_dtype)
    return fn(tuple(shape), wire_dtype=wire_dtype)


def format_for(compressor, tree: PyTree, *,
               wire_dtype: str = "float32") -> WireFormat:
    """WireFormat for ``compressor`` applied leaf-wise to ``tree`` (tensors
    of any device, ``meta`` included)."""
    return WireFormat(tuple(
        codec_of(compressor, tuple(leaf.shape), leaf.numel(), wire_dtype)
        for leaf in T.leaves(tree)))


def fleet_formats(fleet: Sequence[Any], tree: PyTree, *,
                  wire_dtype: str = "float32") -> Tuple[WireFormat, ...]:
    """One WireFormat per worker of a heterogeneous fleet (worker i's
    payload layout is its own compressor's)."""
    return tuple(format_for(c, tree, wire_dtype=wire_dtype) for c in fleet)


def fleet_bits_per_round(fmts: Sequence[WireFormat], mask=None) -> int:
    """Exact uplink bits of one mixed-fleet round: the sum of the
    participating workers' payloads.  ``mask``, the (n,) participation
    mask of a federated round, adds the n-worker bitmap and drops absent
    workers' payloads; None is the full-participation round."""
    if mask is None:
        return sum(f.bits_per_round() for f in fmts)
    m = torch.as_tensor(mask)
    if m.shape[0] != len(fmts):
        raise ValueError(f"mask of {m.shape[0]} workers for a fleet of "
                         f"{len(fmts)}")
    return 32 * bitmap_words(len(fmts)) + sum(
        f.bits_per_round() for f, mi in zip(fmts, m.tolist()) if mi > 0)


def parse_leaf_rules(spec: str):
    """The per-leaf codec grammar, ';'-separated ``pattern=compressor_spec``
    entries (fnmatch over the leaf's '/'-joined path, first match wins; a
    bare spec is the catch-all '*'): :func:`compressors.parse_leaf_rules`."""
    return cz.parse_leaf_rules(spec)


def resolve_leaf(rules, path: str, default):
    """The compressor the rule list assigns to one leaf path (first
    matching fnmatch pattern wins; no match keeps ``default``)."""
    for pat, comp in rules or ():
        if fnmatch.fnmatchcase(path, pat):
            return comp
    return default


def leaf_paths(tree: PyTree) -> Tuple[str, ...]:
    """'/'-joined path string of every leaf, in flatten order."""
    return tuple("/".join(p) for p, _ in T.flatten_with_path(tree))


@dataclasses.dataclass(frozen=True)
class TreeWire(WireFormat):
    """The per-leaf wire format (``wire.TreeWire``): leaf j carries the
    compressor its path resolves to under the rules (clamped to the leaf's
    size) and that compressor's codec.  The accounting is the inherited
    sum over leaves, so the composed bits are the sum of the per-leaf
    bits.  Encode, decode, zero and mask walk the leaves in flatten order,
    leaf j keyed ``fold_in(key, j)`` as every aggregation path keys it.
    ``skeleton`` holds the tree's structure (its leaves are placeholders)
    for the decoded trees."""

    paths: Tuple[str, ...]
    compressors: Tuple[Any, ...]
    skeleton: Any

    @staticmethod
    def for_tree(compressor, tree: PyTree, *, wire_dtype: str = "float32",
                 rules=()) -> "TreeWire":
        """TreeWire of ``tree`` (tensors of any device, ``meta``
        included): every leaf's compressor resolved through ``rules``
        (falling back to ``compressor``), clamped to the leaf's size, and
        asked for its codec."""
        flat = T.leaves(tree)
        paths = leaf_paths(tree)
        comps = tuple(
            clamp_for_leaf(resolve_leaf(rules, p, compressor), leaf.numel())
            for p, leaf in zip(paths, flat))
        codecs = tuple(
            codec_of(c, tuple(leaf.shape), leaf.numel(), wire_dtype)
            for c, leaf in zip(comps, flat))
        return TreeWire(leaves=codecs, paths=paths, compressors=comps,
                        skeleton=T.tree_map(lambda _: 0, tree))

    def leaf_keys(self, keys) -> Tuple[Any, ...]:
        """Per-leaf keys: an explicit sequence of keys as it is, one base
        key folded per leaf index, ``fold_in(key, j)`` (None stays
        None)."""
        if isinstance(keys, (tuple, list)):
            if len(keys) != len(self.leaves):
                raise ValueError(f"{len(keys)} leaf keys for a tree of "
                                 f"{len(self.leaves)} leaves")
            return tuple(keys)
        return tuple(None if keys is None else random.fold_in(keys, j)
                     for j in range(len(self.leaves)))

    def encode_update(self, keys, grads: PyTree, h: PyTree, lam: float, *,
                      kernel: Optional[str] = None, contract: bool = False):
        """Per-leaf worker update: (payload list, h' tree) with
        d_j = C_j(g_j - h_j) packed and h'_j = h_j + lam d_j.  An explicit
        ``cuda`` applies where a leaf has a kernel; the other leaves run
        their plain path, their only one."""
        payloads, h_new = [], []
        for codec, kj, gj, hj in zip(self.leaves, self.leaf_keys(keys),
                                     T.leaves(grads), T.leaves(h)):
            kk = kernel
            if kernel == "cuda" and not getattr(codec, "has_kernel", False):
                kk = "oracle"
            p, hn = codec.encode_update(kj, gj, hj, lam, kernel=kk,
                                        contract=contract)
            payloads.append(p)
            h_new.append(hn)
        return payloads, T.unflatten(self.skeleton, h_new)

    def decode(self, payloads) -> PyTree:
        """One worker's payload list -> dense f32 tree (leaf shapes)."""
        return T.unflatten(self.skeleton, [
            c.decode(p).reshape(c.shape)
            for c, p in zip(self.leaves, payloads)])

    def decode_sum(self, payloads, *, chunks: int = 1) -> PyTree:
        """Worker-stacked payload list -> dense f32 tree of the sums over
        workers (divide by n for the mean), the worker axis split into
        ``chunks`` as :func:`chunked_decode_sum` splits it."""
        return T.unflatten(self.skeleton, [
            chunked_decode_sum(c, p, chunks).reshape(c.shape)
            for c, p in zip(self.leaves, payloads)])

    def mask_messages(self, payloads, m) -> list:
        """Every leaf's message gated on the participation ``m``."""
        return [c.mask_message(p, m) for c, p in zip(self.leaves, payloads)]

    def zero_messages(self, base_key, device) -> list:
        """The pipelined schedule's priming payloads on ``device``, leaf j
        keyed ``fold_in(base_key, j)``, as ``init_inflight`` keys them."""
        return [zero_message(c, random.fold_in(base_key, j), device)
                for j, c in enumerate(self.leaves)]

    def bits_by_leaf(self) -> Tuple[int, ...]:
        """Exact per-leaf payload bits in flatten order; their sum is
        ``bits_per_round()``."""
        return tuple(c.payload_bits for c in self.leaves)


def tree_format_for(compressor, tree: PyTree, *,
                    wire_dtype: str = "float32", rules=None):
    """The wire format of ``tree``: the flat :class:`WireFormat` without
    per-leaf rules, a :class:`TreeWire` with them."""
    if not rules:
        return format_for(compressor, tree, wire_dtype=wire_dtype)
    return TreeWire.for_tree(compressor, tree, wire_dtype=wire_dtype,
                             rules=tuple(rules))


def payload_bytes(payload: PyTree) -> int:
    """Measured bytes of a payload tree (what actually crosses the wire)."""
    return sum(a.numel() * a.element_size() for a in T.leaves(payload))


# ---------------------------------------------------------------------------
# the serving downlink: versioned compressed-delta push envelopes
# ---------------------------------------------------------------------------

#: exact header bits of one push envelope: two unsigned 64-bit version
#: fields, ``version`` (the w the push produces) and ``base_version`` (the
#: w it must be applied to)
PUSH_HEADER_BITS = 2 * 64

#: envelope kinds: a ``delta`` decodes to the model innovation (the replica
#: applies w + lam * decode), a ``snapshot`` to the model itself (the
#: replica assigns it: a lossless downlink's push is a full checkpoint)
PUSH_KINDS = ("delta", "snapshot")


@dataclasses.dataclass(frozen=True)
class DeltaEnvelope:
    """One versioned model push on the serving downlink (``wire.py``'s
    ``DeltaEnvelope``): ``payloads`` is the per-leaf payload list of ONE
    broadcast message, as ``Downlink.encode_push`` emits it and
    ``Downlink.apply_push`` consumes it; ``version`` is the model version
    the push produces, ``base_version`` the version it applies to.  A
    replica at any other version refuses it (stale or gap)."""

    version: int
    base_version: int
    payloads: Any
    kind: str = "delta"

    def __post_init__(self):
        if self.kind not in PUSH_KINDS:
            raise ValueError(f"push kind {self.kind!r} not in {PUSH_KINDS}")
        if self.version <= self.base_version:
            raise ValueError(
                f"push version {self.version} must advance past its base "
                f"{self.base_version} (versions are strictly monotonic)")


def push_bits(fmt: WireFormat) -> int:
    """Exact bits of one versioned push: the envelope header plus the ONE
    broadcast message of the downlink format (every replica decodes the
    same push)."""
    return PUSH_HEADER_BITS + fmt.downlink_bits_per_round()


def checkpoint_push_bits(fmt: WireFormat) -> int:
    """Exact bits of shipping a full f32 copy of the same tree under the
    same header: the baseline a delta push is measured against."""
    return PUSH_HEADER_BITS + fmt.dense_bits()


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
               kernel: Optional[str] = None, contract: bool = False
               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """d = block_topk(g - h) packed as (values, indices); h' = h + lam d.

    ``auto`` and ``cuda`` go through the kernel wrapper (one pass, dense d
    never in device memory), which raises on a CUDA tensor for a block the
    kernel does not take; ``oracle`` takes the plain layout spec.  As in
    the JAX package, ``auto`` routes a block with block % 128 != 0 (which
    no kernel tiles) to the plain layout spec on any device, by its shape
    alone and before any launch; an explicit ``cuda`` raises there.  The
    explicit ``oracle`` rounds h + lam d twice, as the kernel does (it is
    the kernel's reference); the plain path that ``auto`` takes by shape
    rounds it as JAX's jitted oracle does when ``contract`` (the trainer's
    rounding, :meth:`LeafCodec.update`)."""
    mode = _kernel_mode(kernel, g)
    routed = mode == "auto" and lw.block % 128 != 0
    if mode != "oracle" and not routed:
        return ops.efbv_pack_update(g, h, lam, block=lw.block, kb=lw.kb)
    delta = g.float() - h.float()
    vals, idx = pack_oracle(lw, delta)
    d = scatter_add(lw, vals, idx).reshape(lw.shape)
    return (vals.to(g.dtype), idx), lw.update(h, d, lam, contract and routed)


def encode_update(codec, key, g: torch.Tensor, h: torch.Tensor,
                  lam: float, *, kernel: Optional[str] = None,
                  contract: bool = False):
    """Fused compress-and-pack worker update through ``codec`` (f32
    gradients, any wire dtype).  ``key`` feeds the stochastic codecs; the
    deterministic ones ignore it.  ``contract``: the plain paths round
    h + lam * d as XLA does under ``jit`` (:meth:`LeafCodec.update`)."""
    if g.dtype != torch.float32:
        raise NotImplementedError(
            f"the wire of the port takes f32 gradients, got {g.dtype}")
    return codec.encode_update(key, g, h, lam, kernel=kernel,
                               contract=contract)


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
