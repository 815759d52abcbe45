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
gradients are alive at a time.  Ported so far: the sequential schedule
with full participation and one compressor for every worker.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core.efbv import EFBV, Downlink, downlink_key
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


def init_train_state(params: PyTree, optimizer: Optimizer, *,
                     n_workers: int, bidirectional: bool = False
                     ) -> TrainState:
    """h_i = 0 (f32, stacked on a leading worker axis), h_avg = 0, and
    w = a copy of the params when ``bidirectional`` (workers start from
    the broadcast initial model)."""
    n = n_workers
    h = T.tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                         dtype=torch.float32, device=p.device),
                   params)
    h_avg = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    return TrainState(params=params, opt_state=optimizer.init(params), h=h,
                      h_avg=h_avg, step=0,
                      w=T.tree_map(torch.clone, params) if bidirectional
                      else None)


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

    The step takes the state over, as the JAX step donates it: the
    control variates are updated in place, worker by worker."""
    n = n_workers

    @torch.no_grad()
    def train_step(state: TrainState, batch: Dict[str, Any], key
                   ) -> Tuple[TrainState, dict]:
        if downlink is not None and state.w is None:
            raise ValueError("a downlink needs a TrainState built with "
                             "init_train_state(..., bidirectional=True)")
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
        g, h_avg = combine_global(algo, stack_messages(messages), state.h_avg,
                                  n_workers=n, mode=agg_mode,
                                  wire_dtype=wire_dtype)
        del messages
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
                          h_avg=h_avg, step=state.step + 1, w=w), metrics

    return train_step
