"""Compressed cross-worker aggregation: the worker and master halves of one
round of Algorithm 1 (``repro/distributed/aggregate.py``).

  phase 1, per worker (:func:`compress_local`): d_i = C(grad_i - h_i) and
      h_i <- h_i + lam d_i, returning the worker's message;
  the exchange: every rank ends with all n messages in worker order
      (:func:`exchange`, over a :class:`WorkerGroup`; in one process
      :func:`stack_messages`);
  phase 2, once per rank (:func:`combine_global`): d_bar = (1/n) sum_i d_i
      from the gathered messages, then the master update;
  phase 3, once per rank (:func:`broadcast_global`), with a downlink: the
      master's compressed broadcast of x - w, which every worker applies
      to w.

``dense_psum`` carries the dense d_i (the paper's semantics, no byte
savings): across processes an all-reduce sum.  ``sparse_allgather``
carries the wire codec's payload: across processes an all-gather of one
flat byte buffer per round (:func:`pack_bytes` / :func:`unpack_bytes`),
and every rank decodes the gathered payloads by scatter-add.  Both give
the same d_bar for a deterministic compressor.

One process per worker group: rank r of P owns the contiguous workers
[r n/P, (r + 1) n/P), as ``process_worker_slice`` numbers them in the JAX
package, and runs phase 1 for them only.  Phases 2 and 3 run replicated on
every rank (same inputs, same kernels, no collective), as the JAX package
runs them under GSPMD, so the params, h_avg and w stay bitwise identical
across ranks.

Federated rounds thread a per-worker participation ``mask`` through
:func:`compress_local`: an absent worker's message is gated to
decode-zero and its control variate stays stale, so
:func:`combine_global` needs no variant.

The mesh (``repro/launch/mesh.py`` and ``repro/distributed/spec.py``):
:func:`make_mesh` and friends give its geometry, the worker axes and the
trailing ``model`` axis.  Under a mesh ``WxM`` over P = W' x M processes
(W' dividing the W workers), global rank r is worker-group rank r // M and
model rank r % M: the M ranks of one worker group hold the shards of one
worker's params (tensor parallelism, ``models/layers.py``), and the ranks
with one model index form the worker group that exchanges messages.  The
compressor acts on the logical (unsharded) per-worker gradient, so the
payload and the bits per round are those of one process
(:class:`ModelShards`): a block-sparse leaf whose every block lies inside
one contiguous run of a shard is packed on its shard in place, any other
sharded leaf is gathered over the model group, packed whole, and only this
rank's shard of h' is kept.  Master state, decode, the master update and
AdamW act on shards.  Under fsdp (:class:`FsdpShards`) the master state is
split once more over the worker group, and gathered in two stages.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core.efbv import EFBV, Downlink
from repro_torch.distributed import wire
from repro_torch.models.layers import (MODEL_AXIS, ModelAxis, is_spec,
                                      spec_dim)

PyTree = Any
AGG_MODES = ("dense_psum", "sparse_allgather")
BACKENDS = ("gloo", "nccl")
#: torch's fake process-group backend: collectives that move nothing, for
#: one rank's program of a large world on the ``meta`` device (the dry
#: run, ``launch/train.py::dryrun_one``), and only there
DRYRUN_BACKEND = "fake"
#: byte alignment of each payload component in the flat transport buffer,
#: so every component views back as its own dtype (itemsizes 1, 2 and 4)
ALIGN = 4


def compress_local(algo: EFBV, key, grads: PyTree, h_local: PyTree, *,
                   mode: str = "dense_psum", wire_dtype: str = "float32",
                   mask=None, worker: Optional[int] = None,
                   shards: Optional["ModelShards"] = None
                   ) -> Tuple[Any, PyTree]:
    """d_i = C_i(grad_i - h_i); h_i <- h_i + lam d_i.

    ``key`` is this worker's threefry key (or None for a deterministic
    compressor); leaf j draws from ``fold_in(key, j)``.  Returns (message,
    h_local_new): the dense d_i tree (dense_psum) or the list of per-leaf
    payloads in flatten order (sparse_allgather), where each leaf's fused
    pack emits the payload and the h update in one pass, and each plain
    codec rounds h + lam d as the jitted JAX trainer does
    (``wire.LeafCodec.update(contract=True)``).  Under ``algo.leaf_rules``
    leaf j runs the compressor its path resolves to, clamped to the leaf
    (``wire.tree_format_for``; under dense_psum the same compressors,
    dense).

    ``worker`` is this worker's linear index, which a heterogeneous fleet
    (``algo.fleet``) needs: worker i runs ``algo.fleet[i]``.  Mixed fleets
    send dense messages of one shape, so they run under dense_psum only.

    ``mask`` is this worker's scalar participation for the round (a 0-dim
    tensor or a number): at 0 the message is gated to decode-zero
    (``codec.mask_message``, or a zeroed dense d_i) and h_i stays stale
    (``where(m > 0, h', h)``); at 1 both gates are bitwise identities;
    None (full participation) skips them.

    ``shards`` (a mesh rank): ``grads`` and ``h_local`` are this rank's
    shards and the codecs those of the logical leaves; each leaf is packed
    in place or gathered (:meth:`ModelShards.part_codec`), so the message
    holds this rank's part of an in-place leaf and the whole payload of
    every other.
    """
    if mode not in AGG_MODES:
        raise ValueError(f"mode {mode!r} not in {AGG_MODES}")
    if algo.fleet is not None:
        if mode != "dense_psum":
            raise ValueError(
                "mixed fleets need a uniform per-worker message shape; "
                "mode='sparse_allgather' cannot stack heterogeneous "
                "payloads -- use mode='dense_psum'")
        if worker is None:
            raise ValueError("mixed-fleet compress_local needs the worker "
                             "index (worker=)")
    leaves = T.leaves(grads)
    h_leaves = T.leaves(h_local)
    logical = grads if shards is None else shards.logical
    fmt = wire.tree_format_for(algo.compressor, logical, wire_dtype=wire_dtype,
                               rules=algo.leaf_rules) \
        if mode == "sparse_allgather" else None
    # the dense path's compressor of each leaf
    comps = [algo.compressor] * len(leaves)
    if algo.fleet is not None:
        comps = [algo.fleet[worker]] * len(leaves)
    elif algo.leaf_rules and fmt is None:
        comps = [wire.clamp_for_leaf(
            wire.resolve_leaf(algo.leaf_rules, p, algo.compressor),
            leaf.numel()) for p, leaf in zip(wire.leaf_paths(logical),
                                             T.leaves(logical))]
    msgs, h_new = [], []
    for j, (g_leaf, h_leaf) in enumerate(zip(leaves, h_leaves)):
        kj = None if key is None else random.fold_in(key, j)
        part = None if fmt is None or shards is None \
            else shards.part_codec(j, fmt.leaves[j])
        whole = shards is not None and part is None
        if whole:
            g_leaf, h_leaf = shards.gather(j, g_leaf), shards.gather(j, h_leaf)
        if fmt is not None:
            codec = fmt.leaves[j] if part is None else part
            payload, h_leaf_new = wire.encode_update(
                codec, kj, g_leaf, h_leaf, algo.lam, contract=True)
            if mask is not None:
                payload = codec.mask_message(payload, mask)
            msgs.append(payload)
        else:
            d_leaf = comps[j](kj, g_leaf - h_leaf)
            h_leaf_new = algo.worker_update(h_leaf, d_leaf)
            if whole:  # the dense message: this rank's shard of d
                d_leaf = shards.shard(j, d_leaf)
            msgs.append(d_leaf if mask is None else wire.mask_message(
                (d_leaf,), mask)[0])
        if whole:
            h_leaf = shards.shard(j, h_leaf)
            h_leaf_new = shards.shard(j, h_leaf_new)
        if mask is not None:
            h_leaf_new = torch.where(
                torch.as_tensor(mask, device=h_leaf.device) > 0, h_leaf_new,
                h_leaf)
        h_new.append(h_leaf_new)
    message = T.unflatten(grads, msgs) if fmt is None else msgs
    return message, T.unflatten(h_local, h_new)


def stack_messages(messages) -> Any:
    """The all-gather, held in memory: per-worker messages stacked on a
    new leading worker axis."""
    return T.tree_map(lambda *xs: torch.stack(xs), *messages)


# ---------------------------------------------------------------------------
# the mesh: geometry (``repro/launch/mesh.py``) and specs
# (``repro/distributed/spec.py``)
# ---------------------------------------------------------------------------

POD_AXIS, DATA_AXIS = "pod", "data"
_DEFAULT_AXES = (POD_AXIS, DATA_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh's geometry: axis names and sizes, the ``model`` axis (if
    any) last.  Its ranks are laid out row-major over ``devices_shape``,
    which is process-major: rank r's coordinates are
    ``np.unravel_index(r, devices_shape)``.  The port runs one process per
    rank; there is no device array."""

    axis_names: Tuple[str, ...]
    devices_shape: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices_shape))


def _mesh_axes(shape, axes, who: str) -> Tuple[str, ...]:
    if axes is not None:
        return tuple(axes)
    if len(shape) > len(_DEFAULT_AXES):
        # the trailing-names slice cannot grow past 3 axes
        raise ValueError(
            f"{who} has default axis names for up to {len(_DEFAULT_AXES)} "
            f"mesh dims {_DEFAULT_AXES}, got shape {tuple(shape)} with "
            f"{len(shape)} dims -- pass axes= explicitly")
    return _DEFAULT_AXES[-len(shape):]


def make_mesh(shape: Sequence[int], axes: Optional[Sequence[str]] = None
              ) -> Mesh:
    """A mesh of ``shape``; axes default to the trailing names of
    ('pod', 'data', 'model')."""
    shape = tuple(int(x) for x in shape)
    return Mesh(_mesh_axes(shape, axes, "make_mesh"), shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production meshes: (16, 16) ('data', 'model') on one pod,
    (2, 16, 16) ('pod', 'data', 'model') across two."""
    if multi_pod:
        return make_mesh((2, 16, 16), (POD_AXIS, DATA_AXIS, MODEL_AXIS))
    return make_mesh((16, 16), (DATA_AXIS, MODEL_AXIS))


def multihost_worker_shape(n_workers: int, num_processes: int
                           ) -> Tuple[int, int]:
    """Split a worker count into (num_processes, workers_per_process): the
    leading worker axis must tile the processes exactly, so each process
    owns whole workers."""
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if n_workers % num_processes:
        raise ValueError(
            f"{n_workers} workers cannot tile {num_processes} processes: "
            f"the leading worker axis must be divisible by the process "
            f"count so each host owns whole workers")
    return num_processes, n_workers // num_processes


def make_multihost_mesh(shape: Sequence[int],
                        axes: Optional[Sequence[str]] = None, *,
                        num_processes: int = 1) -> Mesh:
    """A mesh whose rank layout is process-major: process p owns rows
    [p * rows, (p + 1) * rows) of the leading axis.  Rank numbers are
    process-major by construction; this checks the geometry (the leading
    axis divisible by ``num_processes``)."""
    shape = tuple(int(x) for x in shape)
    axes = _mesh_axes(shape, axes, "make_multihost_mesh")
    multihost_worker_shape(shape[0], num_processes)
    return Mesh(axes, shape)


def process_worker_slice(shape: Sequence[int], num_processes: int,
                         process_index: int) -> range:
    """The linear worker indices process ``process_index`` owns under the
    process-major layout; the trailing ``model`` axis, if any, does not
    change worker numbering (a 1-d mesh is all workers)."""
    shape = tuple(shape)
    n = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    multihost_worker_shape(shape[0], num_processes)
    if not 0 <= process_index < num_processes:
        raise ValueError(f"process_index {process_index} out of range for "
                         f"{num_processes} processes")
    per = n // num_processes
    return range(process_index * per, (process_index + 1) * per)


def worker_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The EF-BV worker axes: every axis but ``model``."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def num_workers(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in worker_axes(mesh))


def model_size(mesh: Mesh) -> int:
    """Size of the mesh's ``model`` axis (1 without one)."""
    return mesh.shape.get(MODEL_AXIS, 1)


def worker_entry(mesh: Mesh):
    """The worker axes as one spec entry, as a PartitionSpec normalizes
    them: None without one, the axis name alone when there is one, else
    the tuple."""
    w = worker_axes(mesh)
    return (w[0] if len(w) == 1 else w) if w else None


def batch_spec(mesh: Mesh) -> tuple:
    """The global batch is sharded over every worker axis."""
    return (worker_entry(mesh),)


def stack_worker_spec(mesh: Mesh, specs: PyTree) -> PyTree:
    """The control variates' specs: the worker axes prepended to each
    leaf's spec (h has a leading per-worker axis of size n)."""
    w = worker_entry(mesh)
    return T.tree_map(lambda s: (w,) + tuple(s), specs, is_leaf=is_spec)


def linear_worker_index(mesh: Mesh, coords: Dict[str, int]) -> int:
    """The linearized worker index of worker-axis coordinates (axis ->
    index), row-major over the worker axes."""
    idx = 0
    for a in worker_axes(mesh):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def first_of_shape(shapes: Sequence[Tuple[int, ...]]) -> Tuple[int, ...]:
    """Per leaf, the index of the first leaf of its shape: JAX's
    ``train_state_shardings``/``fsdp_state_shardings`` (``spec_for``) give
    AdamW's m and v and h_avg the spec of that leaf, not of their own."""
    first: Dict[Tuple[int, ...], int] = {}
    return tuple(first.setdefault(tuple(s), j) for j, s in enumerate(shapes))


def _move(axis: ModelAxis, x: torch.Tensor, src: Optional[int],
          dst: Optional[int]) -> torch.Tensor:
    """``x``, split over ``axis`` on dim ``src`` (None: whole), split on
    dim ``dst`` instead: a slice of the local rows from a whole tensor, an
    all-gather (counted in ``axis.stats``) from a split one."""
    if src == dst or axis.size == 1:
        return x
    whole = x if src is None else axis.all_gather(x, src)
    return whole if dst is None else axis.shard(whole, dst)


@dataclasses.dataclass
class ModelShards:
    """One worker's tree on a rank of the mesh's ``model`` axis: per leaf
    in flatten order the dim the axis shards (None: replicated), and the
    logical tree (``meta`` tensors) that the wire formats are built from.
    :meth:`gather` and :meth:`shard` move a leaf between its shard and its
    logical form; :meth:`part_codec` says whether a block-sparse leaf packs
    in place.

    The slot trees (AdamW's m and v, h_avg) are laid out as JAX lays them
    out: leaf j as the first leaf of its shape, ``slot_of[j]`` (JAX's
    ``spec_for``), which differs from leaf j's own layout where a
    replicated leaf shares its shape with a sharded one (qwen2's ``ln1`` and
    ``ln2`` take the q bias's split).  :meth:`to_slot` and
    :meth:`from_slot` move a leaf between the two layouts, bitwise."""

    axis: ModelAxis
    logical: PyTree
    dims: Tuple[Optional[int], ...]

    def __post_init__(self):
        self.slot_of = first_of_shape(
            [tuple(x.shape) for x in T.leaves(self.logical)])
        #: per leaf, the dim the axis splits its slots on
        self.slot_dims = tuple(self.dims[f] for f in self.slot_of)

    def slot_shape(self, j: int) -> Tuple[int, ...]:
        return self.shard_shape(self.slot_of[j])

    def slot_part(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's slot of leaf j's logical tensor."""
        return self.shard(self.slot_of[j], x)

    def same_slot(self, j: int) -> bool:
        """Whether leaf j's slots lie as its own shard does."""
        return self.dims[j] == self.slot_dims[j] or self.axis.size == 1

    def to_slot(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf j's slot from this rank's part of it."""
        return _move(self.axis, x, self.dims[j], self.slot_dims[j])

    def from_slot(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of leaf j from its slot (``x`` itself where
        the layouts agree)."""
        return _move(self.axis, x, self.slot_dims[j], self.dims[j])

    def slot_from_worker(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf j's slot from what a worker holds of it."""
        return self.to_slot(j, self.from_worker(j, x))

    def slots_from_worker(self, tree: PyTree) -> PyTree:
        return T.unflatten(tree, [self.slot_from_worker(j, x)
                                  for j, x in enumerate(T.leaves(tree))])

    def slot_like(self, tree: PyTree) -> PyTree:
        """Empty tensors shaped as the slots of this rank's part of
        ``tree`` (its own leaves where the layouts agree): what the slot
        trees are initialised from."""
        return T.unflatten(tree, [
            x if self.same_slot(j) else
            torch.empty(self.slot_shape(j), dtype=x.dtype, device=x.device)
            for j, x in enumerate(T.leaves(tree))])

    @classmethod
    def of(cls, axis: ModelAxis, specs: PyTree, logical: PyTree
           ) -> "ModelShards":
        dims = tuple(spec_dim(s) for s in T.leaves(specs, is_leaf=is_spec))
        if len(dims) != len(T.leaves(logical)):
            raise ValueError("specs and params differ in structure")
        return cls(axis=axis, logical=logical, dims=dims)

    def shape(self, j: int) -> Tuple[int, ...]:
        return tuple(T.leaves(self.logical)[j].shape)

    def shard_shape(self, j: int) -> Tuple[int, ...]:
        shape, dim = list(self.shape(j)), self.dims[j]
        if dim is not None:
            shape[dim] //= self.axis.size
        return tuple(shape)

    def gather(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf j's logical tensor from this rank's shard (a collective
        over the model group for a sharded leaf)."""
        dim = self.dims[j]
        return x if dim is None else self.axis.all_gather(x, dim)

    def shard(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of leaf j's logical tensor (flat or shaped)."""
        x = x.reshape(self.shape(j))
        dim = self.dims[j]
        return x if dim is None else self.axis.shard(x, dim)

    def shard_tree(self, tree: PyTree) -> PyTree:
        return T.unflatten(tree, [self.shard(j, x) for j, x in
                                  enumerate(T.leaves(tree))])

    def from_worker(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the master's leaf j from what a worker
        holds of it (here, the same shard)."""
        return x.reshape(self.shard_shape(j))

    def part_codec(self, j: int, codec) -> Optional[wire.LeafWire]:
        """The codec of this rank's part of leaf j's payload when it packs
        in place: a block-sparse leaf (of any wire dtype, a TreeWire's
        too) sharded on a dim whose contiguous run per shard (shard's dim
        size times the trailing dims) is a multiple of the block, so every
        block lies inside one shard and the shard's blocks, in order, are
        its rows of the logical payload.  None: the leaf is replicated, or
        packs whole after a gather (every other codec)."""
        dim = self.dims[j]
        if dim is None or not isinstance(codec, wire.LeafWire):
            return None
        shape = self.shape(j)
        run = shape[dim] // self.axis.size * math.prod(shape[dim + 1:])
        if run % codec.block:
            return None
        shard = self.shard_shape(j)
        return dataclasses.replace(codec, shape=shard, size=math.prod(shard))

    def norm(self, tree: PyTree, slots: bool = False) -> torch.Tensor:
        """The global L2 norm of the logical tree from this rank's shards
        (its slots when ``slots``): the sharded leaves' squares summed
        here, then over the axis (f32); the replicated leaves' added
        once."""
        local, rep = [], []
        for x, dim in zip(T.leaves(tree),
                          self.slot_dims if slots else self.dims):
            (rep if dim is None else local).append(
                torch.sum(torch.square(x)))
        # every rank holds the same dims, so all skip the all-reduce alike
        # when no leaf is sharded (granite-moe on a model axis of 16)
        total = self.axis.all_reduce(torch.stack(local).sum()) if local \
            else torch.zeros((), dtype=torch.float32,
                             device=T.leaves(tree)[0].device)
        if rep:
            total = total + torch.stack(rep).sum()
        return torch.sqrt(total)

    def gather_tree(self, tree: PyTree) -> PyTree:
        """The logical tree from this rank's shards, leaf by leaf."""
        return T.unflatten(tree, [self.gather(j, x) for j, x in
                                  enumerate(T.leaves(tree))])

    #: whether a worker's control variate h_i and its compress step hold
    #: shards (a mesh rank), or the logical tree (fsdp)
    shards_worker_state = True


@dataclasses.dataclass
class FsdpShards(ModelShards):
    """The fsdp layout of the master state on a rank of a
    :class:`WorkerGroup` of P ranks (``repro/train/trainer.py``'s
    ``fsdp_state_shardings``): params, AdamW's m and v, h_avg and w hold,
    per leaf, the rank's contiguous 1/P of the dim that ``fsdp_dims``
    picks on the logical shape (a leaf with none keeps what a worker
    holds of it).  ``axis`` is the worker group's process group, so the
    first stage of :meth:`gather` is an all-gather over the ranks; its
    host time, calls and bytes are counted in ``axis.stats``.

    Without a ``model`` axis (:attr:`model` None) a worker's h_i, its
    gradient and its payload are the logical leaf's, so each rank decodes
    a payload whole and keeps its part (:meth:`part_codec` is None): for
    one leaf at a time that costs the logical leaf in f32 beside its part.

    On a mesh with a ``model`` axis the worker side is the axis's
    (:attr:`model`, the :class:`ModelShards` of the group's ``model``; JAX's
    ``h_sh = stack_worker_spec(mesh, param_specs)``): h_i, the gradient and
    the payload are model shards, packed in place where the model axis
    allows, and a master leaf is doubly sharded -- the model spec's dim
    split over the M model ranks, the fsdp dim over the worker group.
    :meth:`gather` then runs in two stages: over the worker group, which
    rebuilds the model shard (:meth:`to_worker`), then over the model axis
    (:attr:`model_axis`, the group's ``model`` process group with its own
    ``stats``), which rebuilds the logical leaf.

    The slots (m, v, h_avg) take the layout of the first leaf of their
    shape (JAX's ``fsdp_state_shardings``): where its fsdp dim, or on a
    model axis its model dim, differs from leaf j's, :meth:`to_slot` and
    :meth:`from_slot` move between the two through the same stages."""

    shards_worker_state = False
    #: what a worker holds: the model axis's shards (None: logical leaves)
    model: Optional[ModelShards] = None
    #: the second stage of :meth:`gather` (None without a model axis)
    model_axis: Optional[ModelAxis] = None

    @classmethod
    def of_group(cls, group: "WorkerGroup", dims: Sequence[Optional[int]],
                 logical: PyTree, specs: PyTree = None) -> "FsdpShards":
        """This rank's layout: ``dims`` the fsdp dims, ``specs`` the
        model specs (needed on a group with a ``model`` axis)."""
        dims = tuple(dims)
        if len(dims) != len(T.leaves(logical)):
            raise ValueError("fsdp dims and params differ in structure")
        model = model_axis = None
        if group.model is not None:
            if specs is None:
                raise ValueError("fsdp on a 'model' axis needs the param "
                                 "specs")
            tp = group.model
            model = ModelShards.of(tp, specs, logical)
            model_axis = ModelAxis(size=tp.size, rank=tp.rank, pg=tp.pg)
        return cls(axis=ModelAxis(size=group.world, rank=group.rank,
                                  pg=group.pg),
                   logical=logical, dims=dims, model=model,
                   model_axis=model_axis)

    def worker_shape(self, j: int) -> Tuple[int, ...]:
        """The shape of what a worker holds of leaf j: its model shard, or
        the logical leaf."""
        return self.shape(j) if self.model is None \
            else self.model.shard_shape(j)

    def shard_shape(self, j: int) -> Tuple[int, ...]:
        shape, dim = list(self.worker_shape(j)), self.dims[j]
        if dim is not None:
            shape[dim] //= self.axis.size
        return tuple(shape)

    def from_worker(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of leaf j from what a worker holds of it."""
        x = x.reshape(self.worker_shape(j))
        dim = self.dims[j]
        return x if dim is None else self.axis.shard(x, dim)

    def shard(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of leaf j's logical tensor (flat or shaped)."""
        x = x.reshape(self.shape(j))
        if self.model is not None:
            x = self.model.shard(j, x)
        return self.from_worker(j, x)

    def to_worker(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """What a worker holds of leaf j from this rank's part: the first
        stage of :meth:`gather`, over the worker group."""
        dim = self.dims[j]
        return x if dim is None else self.axis.all_gather(x, dim)

    def gather(self, j: int, x: torch.Tensor) -> torch.Tensor:
        x = self.to_worker(j, x)
        dim = None if self.model is None else self.model.dims[j]
        return x if dim is None else self.model_axis.all_gather(x, dim)

    def worker_tree(self, tree: PyTree) -> PyTree:
        """What a worker holds of a master tree (:meth:`to_worker`)."""
        return T.unflatten(tree, [self.to_worker(j, x) for j, x in
                                  enumerate(T.leaves(tree))])

    def worker_like(self) -> PyTree:
        """``meta`` tensors shaped as what a worker holds of each leaf."""
        return T.unflatten(self.logical, [
            torch.empty(self.worker_shape(j), device="meta")
            for j in range(len(self.dims))])

    def part_codec(self, j: int, codec) -> Optional[wire.LeafWire]:
        return None if self.model is None \
            else self.model.part_codec(j, codec)

    def same_slot(self, j: int) -> bool:
        return super().same_slot(j) and (self.model is None
                                         or self.model.same_slot(j))

    def _relayout(self, x: torch.Tensor, src, dst) -> torch.Tensor:
        """A part split as (model dim, fsdp dim) ``src`` split as ``dst``:
        the fsdp split undone over the worker group unless it stays and
        lies off both model dims, the model split moved over the model
        axis, then the fsdp split redone."""
        (m1, f1), (m2, f2) = src, dst
        if m1 == m2:
            return _move(self.axis, x, f1, f2)
        keep = f1 == f2 and f1 not in (m1, m2)
        if not keep:
            x = _move(self.axis, x, f1, None)
        x = _move(self.model_axis, x, m1, m2)
        return x if keep else _move(self.axis, x, None, f2)

    def _layouts(self, j: int):
        """((model dim, fsdp dim) of leaf j, the same of its slots)."""
        model = (None, None) if self.model is None \
            else (self.model.dims[j], self.model.slot_dims[j])
        return (model[0], self.dims[j]), (model[1], self.slot_dims[j])

    def to_slot(self, j: int, x: torch.Tensor) -> torch.Tensor:
        own, slot = self._layouts(j)
        return self._relayout(x, own, slot)

    def from_slot(self, j: int, x: torch.Tensor) -> torch.Tensor:
        own, slot = self._layouts(j)
        return self._relayout(x, slot, own)

    def slot_from_worker(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf j's slot from what a worker holds of it (its model shard,
        split over no worker), cut once."""
        own, slot = self._layouts(j)
        return self._relayout(x.reshape(self.worker_shape(j)),
                              (own[0], None), slot)

    def norm(self, tree: PyTree, slots: bool = False) -> torch.Tensor:
        """The global L2 norm of the logical tree from this rank's parts
        (its slots when ``slots``): each leaf's squares summed here, then
        over the axes that split it (f32)."""
        if self.model is None:
            return super().norm(tree, slots)
        fdims = self.slot_dims if slots else self.dims
        mdims = self.model.slot_dims if slots else self.model.dims
        # by (split over the workers, split over the model axis)
        sums = {}
        for j, x in enumerate(T.leaves(tree)):
            key = (fdims[j] is not None, mdims[j] is not None)
            sums.setdefault(key, []).append(torch.sum(torch.square(x)))
        dev = T.leaves(tree)[0].device
        part = {k: torch.stack(sums[k]).sum() if k in sums
                else torch.zeros((), device=dev)
                for k in ((a, b) for a in (True, False)
                          for b in (True, False))}
        workers = self.axis.all_reduce(torch.stack(
            [part[(True, True)], part[(True, False)]]))
        model = self.model_axis.all_reduce(workers[0] + part[(False, True)])
        return torch.sqrt(model + workers[1] + part[(False, False)])


def fsdp_dims(specs: PyTree, mesh: Mesh) -> Tuple[Optional[int], ...]:
    """Per leaf in flatten order, the dim that ``fsdp_specs`` gives the
    worker axes (None: the leaf stays whole)."""
    w = worker_entry(mesh)
    return tuple(s.index(w) if w in s else None
                 for s in T.leaves(specs, is_leaf=is_spec))


# ---------------------------------------------------------------------------
# one process per worker group
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerGroup:
    """This rank's place among P processes that share the n workers: the
    process group, rank and P, the contiguous workers it owns
    (:attr:`workers`), its device, and what its exchanges cost
    (:attr:`stats`: host seconds spent in the collectives, or in
    ``wait()`` for an exchange started with ``async_op``; exchanges; bytes
    gathered).  On a mesh with a ``model`` axis of M > 1, ``rank``,
    ``world`` and ``pg`` are those of the worker group (the ranks with
    this rank's model index), and :attr:`model` is its place on the model
    axis.  Build one with :meth:`join`."""

    n_workers: int
    rank: int
    world: int
    backend: str
    device: torch.device
    pg: Any = None
    stats: dict = dataclasses.field(default_factory=lambda: {
        "exchange_s": 0.0, "exchanges": 0, "bytes": 0})
    model: Optional[ModelAxis] = None

    def __post_init__(self):
        dry = self.backend == DRYRUN_BACKEND and self.device.type == "meta"
        if self.backend not in BACKENDS and not dry:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} of {self.world} processes")
        if self.n_workers % self.world:
            raise ValueError(
                f"{self.n_workers} workers cannot tile {self.world} "
                "processes: each process must own whole workers")

    @classmethod
    def join(cls, n_workers: int, *, backend: str, device,
             init_method: Optional[str] = None,
             model_size: int = 1, rank: Optional[int] = None,
             world: Optional[int] = None, store=None) -> "WorkerGroup":
        """Join the process group as ``torchrun`` starts a rank: rank and
        size from ``RANK`` and ``WORLD_SIZE``, the rendezvous from
        ``init_method`` (``env://`` -- ``MASTER_ADDR`` / ``MASTER_PORT`` --
        by default; tests pass a ``file://`` store).  The backend is the
        caller's: nothing switches it.  ``model_size`` M > 1 splits the
        WORLD_SIZE ranks into WORLD_SIZE / M worker-group ranks of M model
        ranks each (global rank r = worker rank r // M, model rank r % M)
        and builds both sub-groups.  ``rank``, ``world`` and ``store`` (the
        dry run's fake backend) replace the environment and the
        rendezvous."""
        if rank is None:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if model_size < 1 or world % model_size:
            raise ValueError(f"WORLD_SIZE={world} ranks do not split into "
                             f"model groups of {model_size}")
        device = torch.device(device)
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"nccl needs a CUDA device, got {device}")
        m = model_size
        group = cls(n_workers=n_workers, rank=rank // m, world=world // m,
                    backend=backend, device=device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if store is not None:
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world)
        else:
            dist.init_process_group(backend,
                                    init_method=init_method or "env://",
                                    rank=rank, world_size=world)
        group.pg = dist.group.WORLD
        if m > 1:
            # every rank builds every sub-group, in the same order
            for w in range(world // m):
                pg = dist.new_group([w * m + i for i in range(m)])
                if w == rank // m:
                    group.model = ModelAxis(size=m, rank=rank % m, pg=pg)
            for i in range(m):
                pg = dist.new_group([w * m + i for w in range(world // m)])
                if i == rank % m:
                    group.pg = pg
        return group

    @property
    def global_rank(self) -> int:
        """This process's rank among all WORLD_SIZE ranks."""
        return self.rank if self.model is None \
            else self.rank * self.model.size + self.model.rank

    def close(self) -> None:
        """Leave the process group."""
        if self.pg is not None:
            dist.destroy_process_group()
            self.pg = None
            if self.model is not None:
                self.model.pg = None

    @property
    def per_rank(self) -> int:
        return self.n_workers // self.world

    @property
    def workers(self) -> range:
        """The linear worker indices this rank owns."""
        return range(self.rank * self.per_rank,
                     (self.rank + 1) * self.per_rank)

    def sent(self, nbytes: int) -> None:
        """Count an exchange started, and the bytes it gathers here."""
        self.stats["exchanges"] += 1
        self.stats["bytes"] += nbytes

    def waited(self, seconds: float) -> None:
        """Count host time spent in a collective or waiting for one."""
        self.stats["exchange_s"] += seconds


# ---------------------------------------------------------------------------
# the transport: every payload crosses the wire as bytes
# ---------------------------------------------------------------------------

def byte_layout(message) -> Tuple[List[Tuple[tuple, torch.dtype, int, int]],
                                  int]:
    """([(shape, dtype, offset, nbytes)] of each component of one worker's
    message in flatten order, row bytes): the static offsets of the flat
    byte row, each component aligned to :data:`ALIGN` bytes.  Every codec
    the trainer runs has fixed shapes given its format, so every worker and
    every rank computes the same layout."""
    layout, off = [], 0
    for a in T.leaves(message):
        nbytes = a.numel() * a.element_size()
        layout.append((tuple(a.shape), a.dtype, off, nbytes))
        off += -(-nbytes // ALIGN) * ALIGN
    return layout, off


def pack_bytes(messages) -> torch.Tensor:
    """Per-worker messages -> one (len(messages), row bytes) uint8 buffer:
    each component viewed as bytes at its offset (:func:`byte_layout`)."""
    layout, row = byte_layout(messages[0])
    buf = torch.zeros((len(messages), row), dtype=torch.uint8,
                      device=T.leaves(messages[0])[0].device)
    for i, message in enumerate(messages):
        for a, (_, _, off, nbytes) in zip(T.leaves(message), layout):
            buf[i, off:off + nbytes] = a.contiguous().reshape(-1).view(
                torch.uint8)
    return buf


def unpack_bytes(buf: torch.Tensor, like) -> Any:
    """An (n, row bytes) uint8 buffer -> the messages of its n rows,
    stacked on a leading worker axis in row order, as
    :func:`stack_messages` stacks them (``like``: one worker's message, for
    the structure and layout).  Each component is a view of ``buf``, so
    the round trip moves every bit, -0.0 and NaN payloads included."""
    layout, row = byte_layout(like)
    if buf.shape[1] != row:
        raise ValueError(f"rows of {buf.shape[1]} bytes, layout needs {row}")
    n = buf.shape[0]
    return T.unflatten(like, [
        buf[:, off:off + nbytes].view(dtype).reshape((n,) + shape)
        for shape, dtype, off, nbytes in layout])


class Pending:
    """An exchange on the wire (``async_op=True``): :meth:`wait` blocks
    until it has arrived and returns what :func:`combine_global` takes; the
    host time spent waiting goes to the group's stats."""

    def __init__(self, group: WorkerGroup, works, finish: Callable[[], Any]):
        # ``finish`` holds the send and receive buffers until the wait
        self.group, self.works, self.finish = group, works, finish

    def wait(self):
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        self.group.waited(time.perf_counter() - t0)
        out = self.finish()
        self.works = self.finish = None
        return out


def exchange(group: Optional[WorkerGroup], messages: list, *, mode: str,
             async_op: bool = False):
    """Every worker's message of the round, on every rank, in worker order:
    ``messages`` are this rank's workers' own, ascending.

    * no group (one process): the messages stacked in memory;
    * ``sparse_allgather``: one all-gather of the flat byte buffer
      (:func:`pack_bytes`), viewed back as the (n, ...) stacked payloads;
    * ``dense_psum``: this rank's d summed onto zeros in worker order, then
      an all-reduce sum of each leaf; :func:`combine_global` takes it with
      ``summed=True``.

    ``async_op`` returns a :class:`Pending` whose ``wait()`` gives the
    result (the pipelined schedule's in-flight exchange)."""
    if group is None:
        return stack_messages(messages)
    if mode == "sparse_allgather":
        send = pack_bytes(messages)
        out = torch.empty((group.world,) + tuple(send.shape),
                          dtype=torch.uint8, device=send.device)
        t0 = time.perf_counter()
        works = [dist.all_gather(list(out.unbind(0)), send, group=group.pg,
                                 async_op=async_op)]
        nbytes = out.numel()
        like = messages[0]

        def finish():
            return unpack_bytes(out.reshape(-1, send.shape[1]), like)
    else:
        local = T.tree_map(torch.zeros_like, messages[0])
        for message in messages:
            T.tree_map(lambda acc, d: acc.add_(d), local, message)
        t0 = time.perf_counter()
        works = [dist.all_reduce(a, group=group.pg, async_op=async_op)
                 for a in T.leaves(local)]
        nbytes = sum(a.numel() * a.element_size() for a in T.leaves(local))

        def finish():
            return local
    group.sent(nbytes)
    if async_op:
        return Pending(group, works, finish)
    group.waited(time.perf_counter() - t0)
    return finish()


def gather_metrics(group: Optional[WorkerGroup], local: torch.Tensor
                   ) -> torch.Tensor:
    """This rank's (workers, k) per-worker metrics -> every worker's
    (n, k), in worker order (the rows themselves with no group)."""
    if group is None:
        return local
    out = torch.empty((group.world,) + tuple(local.shape), dtype=local.dtype,
                      device=local.device)
    dist.all_gather(list(out.unbind(0)), local.contiguous(), group=group.pg)
    return out.reshape((-1,) + tuple(local.shape[1:]))


def ring_allgather(group: WorkerGroup, x: torch.Tensor) -> torch.Tensor:
    """(P,) + x.shape: every rank's ``x`` in rank order, as an all-gather
    gives it, moved by P - 1 point-to-point hops around the ring
    (``repro/distributed/aggregate.py::ring_allgather``).  Hop h brings
    rank (r - h) mod P's tensor, written at that index, so every rank
    holds the same stacked result.  Gloo's send and recv take host tensors
    only, so with gloo a CUDA tensor is staged through pinned host buffers
    here, explicitly."""
    P, r = group.world, group.rank
    out = torch.empty((P,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[r] = x
    stage = group.backend == "gloo" and x.is_cuda
    cur = x.contiguous()
    if stage:
        cur = torch.empty(cur.shape, dtype=cur.dtype,
                          pin_memory=True).copy_(cur)
    for hop in range(1, P):
        buf = torch.empty_like(cur)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur, (r + 1) % P, group=group.pg),
            dist.P2POp(dist.irecv, buf, (r - 1) % P, group=group.pg)])
        for w in works:
            w.wait()
        out[(r - hop) % P].copy_(buf)
        cur = buf
    return out


def combine_global(algo: EFBV, message_stacked, h_avg: PyTree, *,
                   n_workers: int, mode: str = "dense_psum",
                   wire_dtype: str = "float32", chunks: int = 1,
                   summed: bool = False,
                   shards: Optional[ModelShards] = None
                   ) -> Tuple[PyTree, PyTree]:
    """d_bar = (1/n) sum_i d_i; g = h_avg + nu d_bar;
    h_avg <- h_avg + lam d_bar.  ``message_stacked`` carries a leading
    worker axis of size n.  ``chunks`` > 1 (the pipelined exchange) decodes
    each sparse payload in that many worker slices, summed in ascending
    order (``wire.chunked_decode_sum``); the dense path ignores it.
    ``summed`` (dense only) says the message is already the sum of the n
    workers' d (the all-reduce of :func:`exchange`), which is divided by n
    here as ``torch.mean`` divides.  ``shards`` (a mesh or fsdp rank):
    ``h_avg`` holds this rank's slots (JAX's layout of m, v and h_avg:
    :class:`ModelShards`), an in-place leaf's payload decodes to this
    rank's model shard and any other's to the logical leaf, and each is
    cut to the slot (``from_worker``, ``slot_part``); a dense message
    (what a worker holds) is cut to the slots (``slots_from_worker``).  g
    comes out in the slots' layout, as AdamW's m and v take it."""
    if mode == "dense_psum":
        d_bar = T.tree_map(lambda d: d / n_workers, message_stacked) \
            if summed else T.tree_map(lambda d: torch.mean(d, dim=0),
                                      message_stacked)
        if shards is not None:
            d_bar = shards.slots_from_worker(d_bar)
    else:
        logical = h_avg if shards is None else shards.logical
        fmt = wire.tree_format_for(algo.compressor, logical,
                                   wire_dtype=wire_dtype,
                                   rules=algo.leaf_rules)
        d_leaves = []
        for j, (payload, codec, ref) in enumerate(zip(
                message_stacked, fmt.leaves, T.leaves(h_avg))):
            # a slot laid out otherwise than its leaf is cut from the whole
            part = None if shards is None or not shards.same_slot(j) \
                else shards.part_codec(j, codec)
            d = wire.chunked_decode_sum(part or codec, payload,
                                        chunks) / n_workers
            d_leaves.append(d.reshape(ref.shape) if shards is None
                            else shards.from_worker(j, d) if part
                            else shards.slot_part(j, d))
        d_bar = T.unflatten(h_avg, d_leaves)
    return algo.master_update(h_avg, d_bar)


def broadcast_global(downlink: Downlink, key, params: PyTree, w: PyTree, *,
                     wire_dtype: str = "float32",
                     shards: Optional[ModelShards] = None
                     ) -> Tuple[PyTree, list]:
    """One downlink round: the master encodes C_s(x^{t+1} - w^t) through
    its codec and every worker applies the decoded innovation to the shared
    reconstruction w.  Returns (w_new, payloads); ``key`` must be the
    round's ``downlink_key(step_key)``.  ``shards`` (a mesh rank): x and w
    are shards, and each sharded leaf's x - w is gathered and encoded
    whole, so the payload (its norm too) is the logical leaf's."""
    if shards is None:
        return downlink.broadcast(key, params, w, wire_dtype=wire_dtype)
    return downlink.broadcast(key, params, w, wire_dtype=wire_dtype,
                              gather=shards.gather, shard=shards.shard)
