"""The EF-BV training step on one device (``repro/train/trainer.py``).

The n workers run in one process, one after another, as an explicit loop:
the JAX trainer's vmap formulation written out.  One step:

    for worker i in ascending order:
        loss_i, grads_i = value_and_grad(loss_fn)(w, batch slice i)
        message_i, h_i  = compress_local(fold_in(key, i), ...)  # worker side
    g, h_avg = combine_global(stacked messages, ...) # the all-gather, in memory
    params  <- optimizer(params, g)
    w, _    = broadcast_global(downlink, downlink_key(key), params, w)

Worker i's batch slice is row block i of the worker-major reshape
(B, ...) -> (n, B / n, ...), as in the JAX trainer.  Workers evaluate their
gradients at w, the downlink's reconstruction of the model; without a
downlink w is the params and the last line is skipped.  Only one worker's
gradients are alive at a time.

The pipelined schedule (``pipeline=Pipeline(1)``) double-buffers the
messages: ``combine_global`` applies ``state.inflight``, the messages of
round t-1 (at round 0 the decode-zero priming payload of
:func:`init_inflight`), and round t's stacked messages take its slot.
The workers run in one process and the wire is in memory, so nothing
overlaps the exchange yet: the schedule's arithmetic is the JAX trainer's,
its overlap awaits a multi-process exchange.  Ported so far: the
sequential and pipelined schedules with full participation and one
compressor for every worker.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core.efbv import (EFBV, PIPELINE_FOLD, Downlink, Pipeline,
                                   downlink_key)
from repro_torch.distributed import wire
from repro_torch.distributed.aggregate import (broadcast_global,
                                               combine_global, compress_local,
                                               stack_messages)
from repro_torch.optim.optimizers import Optimizer, apply_updates, global_norm

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt_state: PyTree
    h: PyTree        # per-worker control variates, leading axis n
    h_avg: PyTree    # master's uplink control variate
    step: int
    w: Optional[PyTree] = None   # downlink control variate (bidirectional)
    # the pipelined schedule's in-flight messages (round t-1), stacked on a
    # leading worker axis like the round's own; None when sequential
    inflight: Optional[PyTree] = None


def init_inflight(algo: EFBV, params: PyTree, n: int, *,
                  agg_mode: str = "dense_psum",
                  wire_dtype: str = "float32") -> PyTree:
    """The round-0 in-flight messages of the pipelined schedule: under
    ``sparse_allgather`` leaf j's slot holds ``wire.zero_message`` under
    ``fold_in(fold_in(key(0), PIPELINE_FOLD), j)``, tiled over the n
    workers (a real wire message that decodes to exactly zero, so round 0
    applies g = h_avg + nu * 0); under ``dense_psum`` an f32 zeros tree of
    shape (n,) + leaf shape."""
    if agg_mode != "sparse_allgather":
        return T.tree_map(
            lambda p: torch.zeros((n,) + tuple(p.shape), dtype=torch.float32,
                                  device=p.device), params)
    base = random.fold_in(random.key(0), PIPELINE_FOLD)
    fmt = wire.format_for(algo.compressor, params, wire_dtype=wire_dtype)
    return [tuple(a.unsqueeze(0).repeat((n,) + (1,) * a.dim())
                  for a in wire.zero_message(codec, random.fold_in(base, j),
                                             leaf.device))
            for j, (codec, leaf) in enumerate(zip(fmt.leaves,
                                                  T.leaves(params)))]


def init_train_state(params: PyTree, optimizer: Optimizer, *,
                     n_workers: int, bidirectional: bool = False,
                     algo: Optional[EFBV] = None,
                     agg_mode: str = "dense_psum",
                     wire_dtype: str = "float32",
                     pipeline: Optional[Pipeline] = None) -> TrainState:
    """h_i = 0 (f32, stacked on a leading worker axis), h_avg = 0, and
    w = a copy of the params when ``bidirectional`` (workers start from
    the broadcast initial model).  A pipelined state (``pipeline`` of depth
    1) also holds the priming in-flight messages, which need ``algo`` (and
    the run's ``agg_mode`` and ``wire_dtype``)."""
    n = n_workers
    pipelined = pipeline is not None and pipeline.depth > 0
    if pipelined and algo is None:
        raise ValueError("a pipelined TrainState buffers a wire payload; "
                         "init_train_state needs algo= to build it")
    h = T.tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                         dtype=torch.float32, device=p.device),
                   params)
    h_avg = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    return TrainState(params=params, opt_state=optimizer.init(params), h=h,
                      h_avg=h_avg, step=0,
                      w=T.tree_map(torch.clone, params) if bidirectional
                      else None,
                      inflight=init_inflight(algo, params, n,
                                             agg_mode=agg_mode,
                                             wire_dtype=wire_dtype)
                      if pipelined else None)


def value_and_grad(loss_fn, params: PyTree, batch) -> Tuple[torch.Tensor,
                                                             PyTree]:
    """(loss, f32 grads) of ``loss_fn(params, batch)`` w.r.t. every leaf."""
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(T.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), T.unflatten(params, [g.float() for g in grads])


def make_train_step(
    loss_fn: Callable[[PyTree, Any], Tuple[torch.Tensor, dict]],
    optimizer: Optimizer,
    algo: EFBV,
    *,
    n_workers: int,
    agg_mode: str = "dense_psum",
    wire_dtype: str = "float32",
    downlink: Optional[Downlink] = None,
    pipeline: Optional[Pipeline] = None,
) -> Callable[[TrainState, Dict[str, Any], Any], Tuple[TrainState, dict]]:
    """Build the train step ``step(state, batch, key)``.
    ``loss_fn(params, batch) -> (loss, aux)`` sees one worker's batch
    slice; ``key`` is the round's threefry key (``repro_torch.random``):
    worker i compresses under ``fold_in(key, i)`` and the downlink
    broadcasts under ``downlink_key(key)``.

    ``downlink`` switches on bidirectional compression: workers evaluate
    at ``state.w`` and the step ends with the compressed broadcast of the
    new params.  It needs a TrainState built with
    ``init_train_state(..., bidirectional=True)``.

    ``pipeline`` of depth 1 switches on the one-round-stale schedule: the
    master applies ``state.inflight`` (decoded in ``wire.pipeline_chunks``
    worker chunks) and the round's messages replace it.  It needs a TrainState built with
    ``init_train_state(..., pipeline=...)``.  None or depth 0 is the
    sequential step, bit for bit.

    The step takes the state over, as the JAX step donates it: the
    control variates are updated in place, worker by worker."""
    n = n_workers
    pipelined = pipeline is not None and pipeline.depth > 0
    chunks = wire.pipeline_chunks(n) \
        if pipelined and agg_mode == "sparse_allgather" else 1

    @torch.no_grad()
    def train_step(state: TrainState, batch: Dict[str, Any], key
                   ) -> Tuple[TrainState, dict]:
        if downlink is not None and state.w is None:
            raise ValueError("a downlink needs a TrainState built with "
                             "init_train_state(..., bidirectional=True)")
        if pipelined and state.inflight is None:
            raise ValueError("a pipelined step needs a TrainState built "
                             "with init_train_state(..., pipeline=...)")
        eval_params = state.w if downlink is not None else state.params
        dev = T.leaves(state.params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"global batch {B} does not split over {n} "
                             "workers")
        per = B // n
        messages, local = [], []
        for i in range(n):
            batch_i = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, grads = value_and_grad(loss_fn, eval_params, batch_i)
            h_i = T.tree_map(lambda a: a[i], state.h)
            message, h_i_new = compress_local(
                algo, random.fold_in(key, i), grads, h_i, mode=agg_mode,
                wire_dtype=wire_dtype)
            local.append({
                "loss": loss,
                "grad_norm": global_norm(grads),
                "h_residual": global_norm(
                    T.tree_map(torch.sub, grads, h_i_new)),
            })
            T.tree_map(lambda dst, src: dst.copy_(src), h_i, h_i_new)
            messages.append(message)
            del grads, h_i_new
        message = stack_messages(messages)
        del messages
        # pipelined: the master applies round t-1's in-flight messages and
        # round t's take their slot
        g, h_avg = combine_global(
            algo, state.inflight if pipelined else message, state.h_avg,
            n_workers=n, mode=agg_mode, wire_dtype=wire_dtype, chunks=chunks)
        inflight = message if pipelined else state.inflight
        del message
        updates, opt_state = optimizer.update(g, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        metrics = {k: torch.stack([m[k] for m in local]).mean()
                   for k in local[0]}
        metrics["g_norm"] = global_norm(g)
        metrics["update_norm"] = global_norm(updates)
        w = state.w
        if downlink is not None:
            # phase 3: one compressed broadcast, applied by every worker
            w, _ = broadcast_global(downlink, downlink_key(key), params, w,
                                    wire_dtype=wire_dtype)
            metrics["w_err"] = global_norm(T.tree_map(torch.sub, params, w))
        return TrainState(params=params, opt_state=opt_state, h=state.h,
                          h_avg=h_avg, step=state.step + 1, w=w,
                          inflight=inflight), metrics

    return train_step
