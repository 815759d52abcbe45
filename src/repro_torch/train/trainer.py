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
(B, ...) -> (n, B / n, ...), as in the JAX trainer; a rank copies only its
workers' row blocks of the global batch to its device.  Workers evaluate their
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

On a mesh with a ``model`` axis (``shards``, a
:class:`~repro_torch.distributed.aggregate.ModelShards`, with a group whose
``model`` is that axis) every tree of the state holds this rank's shards
(params, h_i and w as ``Model.param_specs`` shards them; AdamW's m and v
and h_avg as JAX's ``train_state_shardings`` does, each leaf by the spec
of the first param of its shape: ``ModelShards.slot_of``); ``loss_fn`` is
the tensor-parallel loss.  The compressor still acts
on the logical gradient (``compress_local``), the decode keeps this rank's
slot, the master update and AdamW's moments are elementwise on slots,
and the moment step moves to the params' shards before the weight decay
(``from_slot``: a gather over the model axis, or a slice of a replicated
param's rows); the norms are reduced over the model group, and the worker
exchange runs over the worker group.  The
in-flight payload is every worker's message, as the exchange delivers it.
Under fsdp (:func:`make_train_step_fsdp`) the master trees are further
split over the worker group, and the workers hold what they hold without
it.

Each block's activations are recomputed in the backward by the model
itself (``cfg.remat``, JAX's default); JAX's trainer-level ``remat=``
(the whole loss under one ``jax.checkpoint``) has no counterpart: no
driver of either package sets it.  In sanitize mode
(``kernels.enable``) the drivers wrap the step in :func:`sanitized_step`,
JAX's ``jax_debug_nans``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core.efbv import (EFBV, PIPELINE_FOLD, Downlink,
                                   Participation, Pipeline, downlink_key,
                                   participation_key)
from repro_torch.distributed import wire
from repro_torch.distributed.aggregate import (FsdpShards, Mesh,
                                               ModelShards, Pending,
                                               WorkerGroup, broadcast_global,
                                               combine_global, compress_local,
                                               exchange, first_of_shape,
                                               fsdp_dims,
                                               gather_metrics, num_workers,
                                               stack_worker_spec,
                                               worker_entry)
from repro_torch.models.layers import is_spec
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
                  wire_dtype: str = "float32",
                  shards: Optional[ModelShards] = None) -> PyTree:
    """The round-0 in-flight messages of the pipelined schedule: under
    ``sparse_allgather`` leaf j's slot holds ``wire.zero_message`` of its
    codec in the run's format (``wire.tree_format_for``, per-leaf rules
    included) under
    ``fold_in(fold_in(key(0), PIPELINE_FOLD), j)``, tiled over the n
    workers (a real wire message that decodes to exactly zero, so round 0
    applies g = h_avg + nu * 0); under ``dense_psum`` an f32 zeros tree of
    shape (n,) + leaf shape.  On a mesh rank (``shards``) a leaf packed in
    place holds its part's rows (every row of a zero message is the same)."""
    if agg_mode != "sparse_allgather":
        return T.tree_map(
            lambda p: torch.zeros((n,) + tuple(p.shape), dtype=torch.float32,
                                  device=p.device), params)
    base = random.fold_in(random.key(0), PIPELINE_FOLD)
    logical = params if shards is None else shards.logical
    fmt = wire.tree_format_for(algo.compressor, logical,
                               wire_dtype=wire_dtype, rules=algo.leaf_rules)
    dev = T.leaves(params)[0].device
    out = []
    for j, codec in enumerate(fmt.leaves):
        part = None if shards is None else shards.part_codec(j, codec)
        out.append(tuple(a.unsqueeze(0).repeat((n,) + (1,) * a.dim())
                         for a in wire.zero_message(
                             part or codec, random.fold_in(base, j), dev)))
    return out


def init_train_state(params: PyTree, optimizer: Optimizer, *,
                     n_workers: int, bidirectional: bool = False,
                     algo: Optional[EFBV] = None,
                     agg_mode: str = "dense_psum",
                     wire_dtype: str = "float32",
                     pipeline: Optional[Pipeline] = None,
                     group: Optional[WorkerGroup] = None,
                     shards: Optional[ModelShards] = None) -> TrainState:
    """h_i = 0 (f32, stacked on a leading axis over this rank's workers:
    all n without a ``group``), h_avg = 0, and w = a copy of the params
    when ``bidirectional`` (workers start from the broadcast initial model).
    A pipelined state (``pipeline`` of depth 1) also holds the priming
    in-flight messages, which need ``algo`` (and the run's ``agg_mode``
    and ``wire_dtype``): over a group under ``dense_psum`` their all-reduced
    sum, zeros of the workers' leaf shapes.  On a mesh rank ``params`` are
    its shards and ``shards`` says how (every tree of the state is sharded
    alike); under fsdp (:class:`FsdpShards`) ``params`` are the rank's fsdp
    parts and h_i and the in-flight messages what a worker holds (the
    logical tree's, or on a ``model`` axis its shards).  With ``shards``
    AdamW's m and v and h_avg hold this rank's slots (JAX's layout of them,
    ``ModelShards.slot_like``)."""
    n = n_workers
    pipelined = pipeline is not None and pipeline.depth > 0
    if pipelined and algo is None:
        raise ValueError("a pipelined TrainState buffers a wire payload; "
                         "init_train_state needs algo= to build it")
    if group is not None and group.n_workers != n:
        raise ValueError(f"the group shares {group.n_workers} workers, the "
                         f"state {n}")
    local = n if group is None else group.per_rank
    dev = T.leaves(params)[0].device
    # the tree a worker's h_i and message are shaped like
    worker = params if shards is None or shards.shards_worker_state \
        else shards.worker_like()
    h = T.tree_map(lambda p: torch.zeros((local,) + tuple(p.shape),
                                         dtype=torch.float32, device=dev),
                   worker)
    # m, v and h_avg: JAX's layout, each leaf as the first of its shape
    slots = params if shards is None else shards.slot_like(params)
    h_avg = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       slots)
    inflight = None
    if pipelined and group is not None and agg_mode == "dense_psum":
        inflight = T.tree_map(lambda p: torch.zeros(
            tuple(p.shape), dtype=torch.float32, device=dev), worker)
    elif pipelined:
        inflight = init_inflight(algo, params, n, agg_mode=agg_mode,
                                 wire_dtype=wire_dtype, shards=shards)
    return TrainState(params=params, opt_state=optimizer.init(slots), h=h,
                      h_avg=h_avg, step=0,
                      w=T.tree_map(torch.clone, params) if bidirectional
                      else None,
                      inflight=inflight)


def value_aux_and_grad(loss_fn, params: PyTree, batch
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  PyTree]:
    """(loss, aux metrics, f32 grads) of ``loss_fn(params, batch) ->
    (loss, aux)`` w.r.t. every leaf."""
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(T.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            T.unflatten(params, [g.float() for g in grads]))


def value_and_grad(loss_fn, params: PyTree, batch) -> Tuple[torch.Tensor,
                                                             PyTree]:
    """(loss, f32 grads) of ``loss_fn(params, batch)`` w.r.t. every leaf."""
    loss, _, grads = value_aux_and_grad(loss_fn, params, batch)
    return loss, grads


#: the per-worker metrics of every step, averaged over the workers; the
#: loss function's aux metrics (``ce``, ``aux_loss``) follow, by name
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
    shards: Optional[ModelShards] = None,
    grad_transform: Optional[Callable[[PyTree], PyTree]] = None,
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
    ``shards`` runs this rank's shards on a mesh with a ``model`` axis
    (with ``group``, whose ``model`` is that axis, and the tensor-parallel
    ``loss_fn``); it needs a TrainState built with the same shards.

    ``grad_transform`` rewrites each worker's f32 gradient tree before its
    compress step (the JAX trainer's hook; e.g.
    ``layers.zero_inactive_expert_grads``, the worker side of the MoE
    expert-sparsity contract); the norms and h_residual see the rewritten
    tree.  None is the plain step.

    The metrics are the workers' means of ``METRICS`` and of the loss
    function's aux metrics, and ``g_norm``, ``update_norm`` (and
    ``participants``, ``w_err`` where they apply).

    The step takes the state over, as the JAX step donates it: the
    control variates are updated in place, worker by worker."""
    if shards is not None and not shards.shards_worker_state:
        raise ValueError("fsdp shards run make_train_step_fsdp")
    if shards is not None and (group is None or group.model is None):
        raise ValueError("model shards need a group with a 'model' axis")
    return _make_step(loss_fn, optimizer, algo, n_workers=n_workers,
                      agg_mode=agg_mode, wire_dtype=wire_dtype,
                      downlink=downlink, pipeline=pipeline,
                      participation=participation, group=group,
                      shards=shards, grad_transform=grad_transform)


def _make_step(loss_fn, optimizer, algo, *, n_workers, agg_mode, wire_dtype,
               downlink, pipeline, participation, group, shards,
               grad_transform):
    """The step of :func:`make_train_step` and, when ``shards`` is an
    :class:`FsdpShards`, of :func:`make_train_step_fsdp`."""
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
    fsdp = shards is not None and not shards.shards_worker_state
    # the workers' tree: a mesh rank's model shards (fsdp on a model axis
    # too), or the logical tree (one process, fsdp without a model axis);
    # the master state's: the rank's model shards or fsdp parts, if any
    worker_shards = shards.model if fsdp else shards
    wnorm = global_norm if worker_shards is None else worker_shards.norm
    mnorm = global_norm if shards is None else shards.norm
    snorm = global_norm if shards is None \
        else (lambda tree: shards.norm(tree, slots=True))

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
        if fsdp:
            # the workers run what they hold of the model: gathered leaf
            # by leaf over the worker group
            eval_params = shards.worker_tree(eval_params)
        dev = T.leaves(state.params)[0].device
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"global batch {B} does not split over {n} "
                             "workers")
        per = B // n
        # only this rank's workers' rows reach its device
        lo = workers[0] * per
        batch = {k: torch.as_tensor(v[lo:lo + len(workers) * per],
                                    device=dev) for k, v in batch.items()}
        # sampled before the workers run, on every rank from the same key
        mask = participation.sample_mask(participation_key(key), n, dev) \
            if federated else None
        messages, local, names = [], [], METRICS
        for row, i in enumerate(workers):
            batch_i = {k: v[row * per:(row + 1) * per]
                       for k, v in batch.items()}
            loss, aux, grads = value_aux_and_grad(loss_fn, eval_params,
                                                  batch_i)
            if grad_transform is not None:
                grads = grad_transform(grads)
            names = METRICS + tuple(sorted(aux))
            h_i = T.tree_map(lambda a: a[row], state.h)
            message, h_i_new = compress_local(
                algo, random.fold_in(key, i), grads, h_i, mode=agg_mode,
                wire_dtype=wire_dtype,
                mask=None if mask is None else mask[i], worker=i,
                shards=worker_shards)
            local.append(torch.stack([
                loss.float(), wnorm(grads),
                wnorm(T.tree_map(torch.sub, grads, h_i_new))]
                + [aux[k].float() for k in sorted(aux)]))
            T.tree_map(lambda dst, src: dst.copy_(src), h_i, h_i_new)
            messages.append(message)
            del grads, h_i_new
        del eval_params
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
            wire_dtype=wire_dtype, chunks=chunks, summed=summed,
            shards=shards)
        del applied
        inflight = message if pipelined else state.inflight
        del message
        # g, m and v lie as h_avg (the slots); the update moves to the
        # params' layout before it is applied
        updates, opt_state = optimizer.update(
            g, state.opt_state, state.params,
            to_params=None if shards is None else shards.from_slot)
        params = apply_updates(state.params, updates)
        metrics = {k: local[:, j].contiguous().mean()
                   for j, k in enumerate(names)}
        metrics["g_norm"] = snorm(g)
        metrics["update_norm"] = mnorm(updates)
        if federated:
            metrics["participants"] = mask.sum()
        w = state.w
        if downlink is not None:
            # phase 3: one compressed broadcast, applied by every worker
            w, _ = broadcast_global(downlink, downlink_key(key), params, w,
                                    wire_dtype=wire_dtype, shards=shards)
            metrics["w_err"] = mnorm(T.tree_map(torch.sub, params, w))
        return TrainState(params=params, opt_state=opt_state, h=state.h,
                          h_avg=h_avg, step=state.step + 1, w=w,
                          inflight=inflight), metrics

    # what the state's master trees hold: the logical tree (None), a mesh
    # rank's shards or an fsdp rank's
    train_step.shards = shards
    return train_step


# ---------------------------------------------------------------------------
# the fsdp trainer: the master state sharded over the worker group
# ---------------------------------------------------------------------------

def train_state_shardings(mesh: Mesh, param_specs: PyTree,
                          state: TrainState) -> TrainState:
    """Each TrainState leaf's spec on ``mesh`` (JAX's
    ``train_state_shardings``, specs as tuples of axis names): params and
    w by ``param_specs``; AdamW's m and v and h_avg by the spec of the
    first param of their shape (JAX's ``spec_for``, as the port lays them
    out: ``ModelShards.slot_of``); h with the worker axes prepended
    (``stack_worker_spec``); the in-flight payload over the worker axes;
    the counters replicated."""
    return _state_specs(mesh, param_specs, param_specs, state)


def _state_specs(mesh, param_specs, master, state) -> TrainState:
    """The TrainState of specs with params and w by ``master``, m, v and
    h_avg by the ``master`` spec of the first leaf of their shape (the
    logical shapes from h, whole on every rank but a mesh rank's)."""
    shapes = [tuple(a.shape[1:]) for a in T.leaves(state.h)]
    specs = T.leaves(master, is_leaf=is_spec)
    like = [specs[f] for f in first_of_shape(shapes)]
    opt = {k: (T.unflatten(v, like) if isinstance(v, (dict, list)) else ())
           for k, v in state.opt_state.items()}
    h_avg = T.unflatten(state.h_avg, like)
    waxes = (worker_entry(mesh),)
    inflight = None if state.inflight is None else T.tree_map(
        lambda _: waxes, state.inflight)
    return TrainState(
        params=master, opt_state=opt,
        h=stack_worker_spec(mesh, param_specs), h_avg=h_avg, step=(),
        w=None if state.w is None else master, inflight=inflight)


def fsdp_specs(mesh: Mesh, param_specs: PyTree, shapes: PyTree) -> PyTree:
    """JAX's ``fsdp_specs``: the worker axes added to the first dim of each
    param spec that no axis shards and that the worker count divides
    (classic FSDP on top of tensor parallelism); a leaf with no such dim
    keeps its spec.  ``shapes``: the logical params (tensors, ``meta``
    ones too)."""
    w = worker_entry(mesh)
    n = num_workers(mesh)

    def one(spec, leaf):
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (p, dim) in enumerate(zip(parts, shape)):
            if p is None and dim % n == 0 and dim > 0:
                parts[i] = w
                break
        return tuple(parts)

    return T.tree_map(one, param_specs, shapes, is_leaf=is_spec)


def fsdp_state_shardings(mesh: Mesh, param_specs: PyTree,
                         state: TrainState) -> TrainState:
    """JAX's ``fsdp_state_shardings``, specs as tuples: params and w by
    :func:`fsdp_specs`; AdamW's m and v and h_avg by the fsdp spec of the
    first param of their shape (JAX's ``spec_for``, as ``FsdpShards``
    lays them out); h keeps ``stack_worker_spec`` of the param specs (a
    worker's h_i is whole); the in-flight payload over the worker axes.
    The logical shapes come from h, which is whole on every rank."""
    shapes = [tuple(a.shape[1:]) for a in T.leaves(state.h)]
    fspecs = fsdp_specs(mesh, param_specs, T.unflatten(
        param_specs, [torch.empty(s, device="meta") for s in shapes],
        is_leaf=is_spec))
    return _state_specs(mesh, param_specs, fspecs, state)


def make_fsdp_shards(group: Optional[WorkerGroup], mesh: Mesh,
                     param_specs: PyTree, logical: PyTree
                     ) -> Optional[FsdpShards]:
    """This rank's :class:`FsdpShards` of the logical params (``meta``
    tensors) by :func:`fsdp_specs` on ``mesh`` (and on a ``model`` axis
    the model specs); None in one process, where nothing is sharded."""
    if group is None:
        return None
    return FsdpShards.of_group(
        group, fsdp_dims(fsdp_specs(mesh, param_specs, logical), mesh),
        logical, param_specs)


def make_train_step_fsdp(
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
    shards: Optional[FsdpShards] = None,
    grad_transform: Optional[Callable[[PyTree], PyTree]] = None,
) -> Callable[[TrainState, Dict[str, Any], Any], Tuple[TrainState, dict]]:
    """The fsdp train step (``repro/train/trainer.py``'s
    ``make_train_step_fsdp``, the same keywords): over a ``group`` with
    its ``shards`` (:func:`make_fsdp_shards`) each rank keeps only its
    fsdp parts of params, AdamW's m and v, h_avg and w, and the h_i of its
    own workers as a worker holds them.  One step:

        w_worker = all-gather of w over the worker group (the params
            without a downlink): the logical tree, or on a ``model`` axis
            this rank's model shards
        for each of this rank's workers: loss, grads at w_worker, then
            compress_local exactly as :func:`make_train_step` does (on a
            model axis: the mesh rank's, in place or gathered)
        exchange; combine_global decodes each payload as the step without
            fsdp does and keeps this rank's part of g and h_avg
        AdamW on the parts
        broadcast_global: each leaf's x - w gathered in two stages (the
            worker group, then the model axis), encoded whole (its norm
            and uniforms the logical leaf's), its part kept

    Every per-element step acts on parts and every draw and every wire
    reduction on the leaf that the step without fsdp reduces, so the parts
    are bitwise those of one process, or on a ``model`` axis of the mesh
    rank's shards; ``g_norm``, ``update_norm`` and ``w_err`` are reduced
    over the axes (within rounding).  On a ``model`` axis ``loss_fn`` is
    the tensor-parallel loss.  It needs a TrainState built with
    ``init_train_state(..., group=group, shards=shards)``.  In one process
    (no group) nothing is sharded and this is :func:`make_train_step`."""
    if shards is not None and shards.shards_worker_state:
        raise ValueError("model shards run make_train_step")
    if (shards is None) != (group is None):
        raise ValueError("an fsdp step over a group needs its FsdpShards "
                         "(make_fsdp_shards), and only then")
    return _make_step(loss_fn, optimizer, algo, n_workers=n_workers,
                      agg_mode=agg_mode, wire_dtype=wire_dtype,
                      downlink=downlink, pipeline=pipeline,
                      participation=participation, group=group,
                      shards=shards, grad_transform=grad_transform)


# ---------------------------------------------------------------------------
# sanitize mode: JAX's jax_debug_nans
# ---------------------------------------------------------------------------

#: ops whose output is uninitialised memory, which may hold any bits
_UNINITIALISED = ("empty", "empty_like", "new_empty", "empty_strided")


class NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first aten op (forward or
    backward) whose floating output holds a NaN, naming it, as
    ``jax_debug_nans`` names the primitive.  Inf is not checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # a view makes no value, and uninitialised memory holds any bits
        if not func.is_view \
                and func._overloadpacket.__name__ not in _UNINITIALISED:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and t.device.type != "meta" \
                        and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


def _clone(x):
    """A copy of the tensors of a (nested) state, the rest shared."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


def _holds_nan(tree) -> bool:
    flags = [torch.isnan(t).any() for t in tree_leaves(tree)
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    return bool(torch.stack(flags).any()) if flags else False


def sanitized_step(step_fn):
    """``step_fn`` under JAX's ``jax_debug_nans`` semantics: after each
    step its outputs (the state and metrics trees) are checked for NaN, and
    on one the step is run again from a copy of its inputs under
    :class:`NanCheck` and ``torch.autograd.detect_anomaly(check_nan=True)``,
    which raises ``FloatingPointError`` at the first op that made a NaN.  A
    NaN that the step masks away raises nothing, as under JAX."""
    def step(state, batch, key):
        saved = _clone(state)
        out = step_fn(state, batch, key)
        if _holds_nan(out):
            try:
                with NanCheck(), \
                        torch.autograd.detect_anomaly(check_nan=True):
                    step_fn(saved, batch, key)
            except RuntimeError as e:
                if "nan" not in str(e):
                    raise
                raise FloatingPointError(str(e)) from e
            raise FloatingPointError(
                "the step's outputs hold a NaN that no op of its re-run "
                "made")
        return out

    step.shards = getattr(step_fn, "shards", None)
    return step
