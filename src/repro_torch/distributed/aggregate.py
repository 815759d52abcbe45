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
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core.efbv import EFBV, Downlink
from repro_torch.distributed import wire

PyTree = Any
AGG_MODES = ("dense_psum", "sparse_allgather")
BACKENDS = ("gloo", "nccl")
#: byte alignment of each payload component in the flat transport buffer,
#: so every component views back as its own dtype (itemsizes 1, 2 and 4)
ALIGN = 4


def compress_local(algo: EFBV, key, grads: PyTree, h_local: PyTree, *,
                   mode: str = "dense_psum", wire_dtype: str = "float32",
                   mask=None) -> Tuple[Any, PyTree]:
    """d_i = C(grad_i - h_i); h_i <- h_i + lam d_i.

    ``key`` is this worker's threefry key (or None for a deterministic
    compressor); leaf j draws from ``fold_in(key, j)``.  Returns (message,
    h_local_new): the dense d_i tree (dense_psum) or the list of per-leaf
    payloads in flatten order (sparse_allgather), where each leaf's fused
    pack emits the payload and the h update in one pass.

    ``mask`` is this worker's scalar participation for the round (a 0-dim
    tensor or a number): at 0 the message is gated to decode-zero
    (``codec.mask_message``, or a zeroed dense d_i) and h_i stays stale
    (``where(m > 0, h', h)``); at 1 both gates are bitwise identities;
    None (full participation) skips them.
    """
    if mode not in AGG_MODES:
        raise ValueError(f"mode {mode!r} not in {AGG_MODES}")
    leaves = T.leaves(grads)
    h_leaves = T.leaves(h_local)
    fmt = wire.format_for(algo.compressor, grads, wire_dtype=wire_dtype) \
        if mode == "sparse_allgather" else None
    msgs, h_new = [], []
    for j, (g_leaf, h_leaf) in enumerate(zip(leaves, h_leaves)):
        kj = None if key is None else random.fold_in(key, j)
        if fmt is not None:
            payload, h_leaf_new = wire.encode_update(
                fmt.leaves[j], kj, g_leaf, h_leaf, algo.lam)
            if mask is not None:
                payload = fmt.leaves[j].mask_message(payload, mask)
            msgs.append(payload)
        else:
            d_leaf = algo.compressor(kj, g_leaf - h_leaf)
            msgs.append(d_leaf if mask is None else wire.mask_message(
                (d_leaf,), mask)[0])
            h_leaf_new = algo.worker_update(h_leaf, d_leaf)
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
# one process per worker group
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerGroup:
    """This rank's place among P processes that share the n workers: the
    process group, rank and P, the contiguous workers it owns
    (:attr:`workers`), its device, and what its exchanges cost
    (:attr:`stats`: host seconds spent in the collectives, or in
    ``wait()`` for an exchange started with ``async_op``; exchanges; bytes
    gathered).  Build one with :meth:`join`."""

    n_workers: int
    rank: int
    world: int
    backend: str
    device: torch.device
    pg: Any = None
    stats: dict = dataclasses.field(default_factory=lambda: {
        "exchange_s": 0.0, "exchanges": 0, "bytes": 0})

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} of {self.world} processes")
        if self.n_workers % self.world:
            raise ValueError(
                f"{self.n_workers} workers cannot tile {self.world} "
                "processes: each process must own whole workers")

    @classmethod
    def join(cls, n_workers: int, *, backend: str, device,
             init_method: Optional[str] = None) -> "WorkerGroup":
        """Join the process group as ``torchrun`` starts a rank: rank and
        size from ``RANK`` and ``WORLD_SIZE``, the rendezvous from
        ``init_method`` (``env://`` -- ``MASTER_ADDR`` / ``MASTER_PORT`` --
        by default; tests pass a ``file://`` store).  The backend is the
        caller's: nothing switches it."""
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device = torch.device(device)
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"nccl needs a CUDA device, got {device}")
        group = cls(n_workers=n_workers, rank=rank, world=world,
                    backend=backend, device=device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
        group.pg = dist.group.WORLD
        return group

    def close(self) -> None:
        """Leave the process group."""
        if self.pg is not None:
            dist.destroy_process_group()
            self.pg = None

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
                   summed: bool = False) -> Tuple[PyTree, PyTree]:
    """d_bar = (1/n) sum_i d_i; g = h_avg + nu d_bar;
    h_avg <- h_avg + lam d_bar.  ``message_stacked`` carries a leading
    worker axis of size n.  ``chunks`` > 1 (the pipelined exchange) decodes
    each sparse payload in that many worker slices, summed in ascending
    order (``wire.chunked_decode_sum``); the dense path ignores it.
    ``summed`` (dense only) says the message is already the sum of the n
    workers' d (the all-reduce of :func:`exchange`), which is divided by n
    here as ``torch.mean`` divides."""
    if mode == "dense_psum":
        d_bar = T.tree_map(lambda d: d / n_workers, message_stacked) \
            if summed else T.tree_map(lambda d: torch.mean(d, dim=0),
                                      message_stacked)
    else:
        fmt = wire.format_for(algo.compressor, h_avg, wire_dtype=wire_dtype)
        ref_leaves = T.leaves(h_avg)
        d_bar = T.unflatten(h_avg, [
            (wire.chunked_decode_sum(codec, payload, chunks)
             / n_workers).reshape(ref.shape)
            for payload, codec, ref in zip(message_stacked, fmt.leaves,
                                           ref_leaves)])
    return algo.master_update(h_avg, d_bar)


def broadcast_global(downlink: Downlink, key, params: PyTree, w: PyTree, *,
                     wire_dtype: str = "float32") -> Tuple[PyTree, list]:
    """One downlink round: the master encodes C_s(x^{t+1} - w^t) through
    its codec and every worker applies the decoded innovation to the shared
    reconstruction w.  Returns (w_new, payloads); ``key`` must be the
    round's ``downlink_key(step_key)``."""
    return downlink.broadcast(key, params, w, wire_dtype=wire_dtype)
