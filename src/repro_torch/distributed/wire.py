"""Wire codecs: payload layout, exact bit accounting, and the pack /
scatter-add helpers of the block-sparse wire (``repro/distributed/wire.py``).

Ported so far: the block-sparse layout of block-top-k (:class:`LeafWire`,
per block (values f32, block-local indices int32), (nb, kb) each) with the
flat :class:`WireFormat` over a params tree.  The other codecs of the zoo
and the per-leaf ``TreeWire`` are not yet ported.

Kernel dispatch of the fused pack (``REPRO_TORCH_WIRE_KERNEL`` or the
``kernel=`` argument): ``auto`` goes through the kernel wrapper, which
launches the CUDA kernel on a CUDA tensor and runs its plain version on a
CPU tensor; ``cuda`` does the same but raises for a tensor that is not on
CUDA; ``oracle`` takes the layout-spec oracle below, the reference the
tests hold the others against.  The wrapper's two sides match the Pallas
kernel bit for bit.  The oracle matches JAX's jnp oracle instead, which
differs from the kernel in two places: it gathers a selected -0.0 as -0.0
(the kernel sends +0.0), and it ranks a NaN above every number (a row of
the kernel that holds a NaN sends (0.0, 0) in every slot).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core.compressors import BlockTopK
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_rows

PyTree = Any
KERNEL_MODES = ("auto", "cuda", "oracle")


def _kernel_mode(kernel: Optional[str], x: torch.Tensor) -> str:
    mode = kernel or os.environ.get("REPRO_TORCH_WIRE_KERNEL", "auto")
    if mode not in KERNEL_MODES:
        raise ValueError(f"wire kernel {mode!r} not in {KERNEL_MODES}")
    if mode == "cuda" and not x.is_cuda:
        raise ValueError(f"wire kernel 'cuda' needs a CUDA tensor, got one "
                         f"on {x.device}")
    return mode


@dataclasses.dataclass(frozen=True)
class LeafWire:
    """Block-sparse layout of one leaf: per-block (values, block-LOCAL
    indices), shapes (nb, kb) each.  Local indices stay below ``block``, so
    the same scatter-add decodes one message and the worker-stacked
    (n, nb, kb) all-gather result."""

    shape: Tuple[int, ...]
    size: int
    block: int
    kb: int

    kind = "block_sparse"

    @property
    def nb(self) -> int:
        return -(-self.size // self.block)

    @property
    def payload_bits(self) -> int:
        """Exact bits of one worker's message for this leaf: f32 values +
        int32 local indices, (nb, kb) each."""
        return self.nb * self.kb * (32 + 32)

    def decode_sum(self, payload: Sequence[torch.Tensor]) -> torch.Tensor:
        vals, idx = payload
        return scatter_add(self, vals, idx)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Payload layout for a whole params tree (leaf order = flatten order)."""

    leaves: Tuple[LeafWire, ...]

    def bits_per_round(self, *, n_workers: int = 1) -> int:
        """Exact uplink bits one round puts on the wire: per worker when
        n_workers == 1 (the paper's per-node accounting), total otherwise."""
        return n_workers * sum(l.payload_bits for l in self.leaves)

    def dense_bits(self) -> int:
        """The fp32 dense baseline for this tree (one full copy)."""
        return 32 * sum(l.size for l in self.leaves)


def format_for(compressor, tree: PyTree, *,
               wire_dtype: str = "float32") -> WireFormat:
    """WireFormat for ``compressor`` applied leaf-wise to ``tree`` (tensors
    of any device, ``meta`` included).  Block-top-k clamps kb to a leaf
    smaller than kb, as ``wire.clamp_for_leaf`` does."""
    if wire_dtype != "float32":
        raise NotImplementedError(
            f"wire dtype {wire_dtype!r} is not yet ported (float32 only)")
    codecs = []
    for leaf in T.leaves(tree):
        size = leaf.numel()
        comp = compressor
        if isinstance(comp, BlockTopK) and min(comp.block, size) < comp.kb:
            comp = dataclasses.replace(comp, kb=min(comp.block, size))
        codecs.append(comp.codec(tuple(leaf.shape)))
    return WireFormat(tuple(codecs))


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
    for the mean).  Duplicate indices from different workers add in an
    unspecified order; with two workers the sum 0 + a + b is exact in
    either order."""
    if vals.dim() == 3:  # (n, nb, kb) -> (nb, n*kb)
        vals = vals.movedim(0, 1).reshape(vals.shape[1], -1)
        idx = idx.movedim(0, 1).reshape(idx.shape[1], -1)
    out = torch.zeros((lw.nb, lw.block), dtype=vals.dtype, device=vals.device)
    out.scatter_add_(1, idx.long(), vals)
    return out.reshape(-1)[:lw.size]


def fused_pack(lw: LeafWire, g: torch.Tensor, h: torch.Tensor, lam: float, *,
               kernel: Optional[str] = None
               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """d = block_topk(g - h) packed as (values, indices); h' = h + lam d.

    ``auto`` and ``cuda`` go through the kernel wrapper (one pass, dense d
    never in device memory), which raises on a CUDA tensor for a block the
    kernel does not take; only ``oracle`` takes the plain layout spec."""
    if _kernel_mode(kernel, g) != "oracle":
        return ops.efbv_pack_update(g, h, lam, block=lw.block, kb=lw.kb)
    delta = g.float() - h.float()
    vals, idx = pack_oracle(lw, delta)
    d = scatter_add(lw, vals, idx).reshape(lw.shape)
    h_new = (h.float() + lam * d).to(h.dtype)
    return (vals.to(g.dtype), idx), h_new


def encode_update(codec: LeafWire, g: torch.Tensor, h: torch.Tensor,
                  lam: float, *, kernel: Optional[str] = None):
    """Fused compress-and-pack worker update through ``codec`` (f32
    gradients; other wire dtypes are not yet ported)."""
    if g.dtype != torch.float32:
        raise NotImplementedError(
            f"the block-sparse wire of the port takes f32 gradients, got "
            f"{g.dtype}")
    return fused_pack(codec, g, h, lam, kernel=kernel)
