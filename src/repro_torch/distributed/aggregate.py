"""Compressed cross-worker aggregation: the worker and master halves of one
round of Algorithm 1 (``repro/distributed/aggregate.py``).

  phase 1, per worker (:func:`compress_local`): d_i = C(grad_i - h_i) and
      h_i <- h_i + lam d_i, returning the worker's message;
  phase 2, once (:func:`combine_global`): d_bar = (1/n) sum_i d_i from the
      stacked messages, then the master update;
  phase 3, once (:func:`broadcast_global`), with a downlink: the master's
      compressed broadcast of x - w, which every worker applies to w.

``dense_psum`` carries the dense d_i (the paper's semantics, no byte
savings); ``sparse_allgather`` carries the wire codec's payload, and the
master decodes the stacked payloads by scatter-add.  Both give the same
d_bar for a deterministic compressor.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core.efbv import EFBV, Downlink
from repro_torch.distributed import wire

PyTree = Any
AGG_MODES = ("dense_psum", "sparse_allgather")


def compress_local(algo: EFBV, key, grads: PyTree, h_local: PyTree, *,
                   mode: str = "dense_psum", wire_dtype: str = "float32"
                   ) -> Tuple[Any, PyTree]:
    """d_i = C(grad_i - h_i); h_i <- h_i + lam d_i.

    ``key`` is this worker's threefry key (or None for a deterministic
    compressor); leaf j draws from ``fold_in(key, j)``.  Returns (message,
    h_local_new): the dense d_i tree (dense_psum) or the list of per-leaf
    payloads in flatten order (sparse_allgather), where each leaf's fused
    pack emits the payload and the h update in one pass.
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
            msgs.append(payload)
        else:
            d_leaf = algo.compressor(kj, g_leaf - h_leaf)
            msgs.append(d_leaf)
            h_leaf_new = algo.worker_update(h_leaf, d_leaf)
        h_new.append(h_leaf_new)
    message = T.unflatten(grads, msgs) if fmt is None else msgs
    return message, T.unflatten(h_local, h_new)


def stack_messages(messages) -> Any:
    """The all-gather, held in memory: per-worker messages stacked on a
    new leading worker axis."""
    return T.tree_map(lambda *xs: torch.stack(xs), *messages)


def combine_global(algo: EFBV, message_stacked, h_avg: PyTree, *,
                   n_workers: int, mode: str = "dense_psum",
                   wire_dtype: str = "float32", chunks: int = 1
                   ) -> Tuple[PyTree, PyTree]:
    """d_bar = (1/n) sum_i d_i; g = h_avg + nu d_bar;
    h_avg <- h_avg + lam d_bar.  ``message_stacked`` carries a leading
    worker axis of size n.  ``chunks`` > 1 (the pipelined exchange) decodes
    each sparse payload in that many worker slices, summed in ascending
    order (``wire.chunked_decode_sum``); the dense path ignores it."""
    if mode == "dense_psum":
        d_bar = T.tree_map(lambda d: torch.mean(d, dim=0), message_stacked)
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
