"""The EF-BV training step (``repro/train/trainer.py``).

The n workers run as an explicit loop, the JAX trainer's vmap formulation
written out: in one process all n of them, or, over a
:class:`~repro_torch.distributed.aggregate.WorkerGroup` of P processes,
rank r's contiguous n/P (one process per worker at P = n).  One step:

    for worker i this rank owns, in ascending order:
        loss_i, grads_i = value_and_grad(loss_fn)(w, batch slice i)
        message_i, h_i  = compress_local(fold_in(key, i), ...)  # worker side
    messages = exchange(group, ...)    # all n, in worker order
    g, h_avg = combine_global(messages, ...)
    params  <- optimizer(params, g)
    w, _    = broadcast_global(downlink, downlink_key(key), params, w)

Worker i's batch slice is row block i of the worker-major reshape
(B, ...) -> (n, B / n, ...), as in the JAX trainer.  Workers evaluate their
gradients at w, the downlink's reconstruction of the model; without a
downlink w is the params and the last line is skipped.  Only one worker's
gradients are alive at a time.  ``combine_global``, the optimizer and the
broadcast run replicated on every rank, so params, h_avg and w stay
bitwise identical across ranks; ``TrainState.h`` holds only this rank's
workers' control variates (a leading axis of n/P).  The per-worker
metrics are gathered and averaged in worker order, as in one process.

The pipelined schedule (``pipeline=Pipeline(1)``) double-buffers the
messages: ``combine_global`` applies ``state.inflight``, the messages of
round t-1 (at round 0 the decode-zero priming payload of
:func:`init_inflight`), and round t's exchange takes its slot.  Over a
group that exchange is started with ``async_op`` and waited on just before
round t+1's ``combine_global``, so it overlaps round t+1's forward and
backward.

``participation`` (the federated mode) samples the round's (n,) mask from
``participation_key(key)`` on every rank; each rank gates its own workers'
messages and control variates with it, and the step reports the
``participants`` metric.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core.efbv import (EFBV, PIPELINE_FOLD, Downlink,
                                   Participation, Pipeline, downlink_key,
                                   participation_key)
from repro_torch.distributed import wire
from repro_torch.distributed.aggregate import (Pending, WorkerGroup,
                                               broadcast_global,
                                               combine_global, compress_local,
                                               exchange, gather_metrics)
from repro_torch.optim.optimizers import Optimizer, apply_updates, global_norm

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt_state: PyTree
    h: PyTree        # this rank's workers' control variates, leading axis
    #                  n (one process) or n/P (a rank of a WorkerGroup)
    h_avg: PyTree    # master's uplink control variate
    step: int
    w: Optional[PyTree] = None   # downlink control variate (bidirectional)
    # the pipelined schedule's in-flight messages (round t-1), stacked on a
    # leading worker axis like the round's own (over a group the all-reduced
    # sum under dense_psum, and from round 1 the exchange still on the wire,
    # a ``Pending``); None when sequential
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
                     pipeline: Optional[Pipeline] = None,
                     group: Optional[WorkerGroup] = None) -> TrainState:
    """h_i = 0 (f32, stacked on a leading axis over this rank's workers:
    all n without a ``group``), h_avg = 0, and w = a copy of the params
    when ``bidirectional`` (workers start from the broadcast initial model).
    A pipelined state (``pipeline`` of depth 1) also holds the priming
    in-flight messages, which need ``algo`` (and the run's ``agg_mode``
    and ``wire_dtype``): over a group under ``dense_psum`` their all-reduced
    sum, zeros of the params' shapes."""
    n = n_workers
    pipelined = pipeline is not None and pipeline.depth > 0
    if pipelined and algo is None:
        raise ValueError("a pipelined TrainState buffers a wire payload; "
                         "init_train_state needs algo= to build it")
    if group is not None and group.n_workers != n:
        raise ValueError(f"the group shares {group.n_workers} workers, the "
                         f"state {n}")
    local = n if group is None else group.per_rank
    h = T.tree_map(lambda p: torch.zeros((local,) + tuple(p.shape),
                                         dtype=torch.float32, device=p.device),
                   params)
    h_avg = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    inflight = None
    if pipelined and group is not None and agg_mode == "dense_psum":
        inflight = T.tree_map(torch.zeros_like, h_avg)
    elif pipelined:
        inflight = init_inflight(algo, params, n, agg_mode=agg_mode,
                                 wire_dtype=wire_dtype)
    return TrainState(params=params, opt_state=optimizer.init(params), h=h,
                      h_avg=h_avg, step=0,
                      w=T.tree_map(torch.clone, params) if bidirectional
                      else None,
                      inflight=inflight)


def value_and_grad(loss_fn, params: PyTree, batch) -> Tuple[torch.Tensor,
                                                             PyTree]:
    """(loss, f32 grads) of ``loss_fn(params, batch)`` w.r.t. every leaf."""
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(T.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), T.unflatten(params, [g.float() for g in grads])


METRICS = ("loss", "grad_norm", "h_residual")


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
    participation: Optional[Participation] = None,
    group: Optional[WorkerGroup] = None,
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
    worker chunks) and the round's messages replace it.  It needs a
    TrainState built with ``init_train_state(..., pipeline=...)``.  None
    or depth 0 is the sequential step, bit for bit.

    ``participation`` other than full samples the round's worker mask
    (federated mode).  ``group`` runs this rank's workers only and
    exchanges the messages over its processes; it needs a TrainState built
    with the same group.  Without one the step is the one-process loop.

    The step takes the state over, as the JAX step donates it: the
    control variates are updated in place, worker by worker."""
    n = n_workers
    pipelined = pipeline is not None and pipeline.depth > 0
    federated = participation is not None and not participation.is_full
    chunks = wire.pipeline_chunks(n) \
        if pipelined and agg_mode == "sparse_allgather" else 1
    if group is not None and group.n_workers != n:
        raise ValueError(f"the group shares {group.n_workers} workers, the "
                         f"step {n}")
    workers = range(n) if group is None else group.workers
    summed = group is not None and agg_mode == "dense_psum"

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
        # sampled before the workers run, on every rank from the same key
        mask = participation.sample_mask(participation_key(key), n, dev) \
            if federated else None
        messages, local = [], []
        for row, i in enumerate(workers):
            batch_i = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, grads = value_and_grad(loss_fn, eval_params, batch_i)
            h_i = T.tree_map(lambda a: a[row], state.h)
            message, h_i_new = compress_local(
                algo, random.fold_in(key, i), grads, h_i, mode=agg_mode,
                wire_dtype=wire_dtype,
                mask=None if mask is None else mask[i])
            local.append(torch.stack([
                loss.float(), global_norm(grads),
                global_norm(T.tree_map(torch.sub, grads, h_i_new))]))
            T.tree_map(lambda dst, src: dst.copy_(src), h_i, h_i_new)
            messages.append(message)
            del grads, h_i_new
        # every worker's metrics, in worker order, on every rank
        local = gather_metrics(group, torch.stack(local))
        # pipelined over a group: round t's exchange stays on the wire while
        # round t+1's workers run; the master applies round t-1's
        message = exchange(group, messages, mode=agg_mode,
                           async_op=pipelined)
        del messages
        applied = state.inflight if pipelined else message
        if isinstance(applied, Pending):
            applied = applied.wait()
        g, h_avg = combine_global(
            algo, applied, state.h_avg, n_workers=n, mode=agg_mode,
            wire_dtype=wire_dtype, chunks=chunks, summed=summed)
        del applied
        inflight = message if pipelined else state.inflight
        del message
        updates, opt_state = optimizer.update(g, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        metrics = {k: local[:, j].contiguous().mean()
                   for j, k in enumerate(METRICS)}
        metrics["g_norm"] = global_norm(g)
        metrics["update_norm"] = global_norm(updates)
        if federated:
            metrics["participants"] = mask.sum()
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
