"""Optimizers on params trees (``repro/optim/optimizers.py``): SGD (with
momentum and Nesterov), AdamW, and the chainable gradient transforms
``clip_by_global_norm`` and ``chain``.

An Optimizer is a pair (init, update):
    state            = init(params)
    updates, state   = update(grads, state, params)   # updates are *deltas*
    params           = apply_updates(params, updates)

The trainer feeds the EF-BV gradient estimate g in as ``grads``.  Where
grads and the optimizer's state lie otherwise than params (a mesh rank's
slots, ``ModelShards``), ``update(..., to_params=move)`` takes
``move(j, x)``, which moves leaf j from the grads' layout to the params';
the updates come out in the params' layout.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import tree as T

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]


def _moved(updates: PyTree, to_params) -> PyTree:
    """``updates`` in the params' layout (``to_params``: None when the
    layouts agree)."""
    if to_params is None:
        return updates
    return T.unflatten(updates, [to_params(j, u) for j, u in
                                 enumerate(T.leaves(updates))])


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return T.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in T.leaves(tree)))


def sgd(schedule, momentum: float = 0.0, nesterov: bool = False
        ) -> Optimizer:
    """SGD, with heavy-ball momentum m <- momentum * m + g (Nesterov: the
    step takes momentum * m + g); the step count is a python int."""

    def init(params):
        mom = T.tree_map(torch.zeros_like, params) if momentum else None
        return {"count": 0, "mom": mom}

    def update(grads, state, params, to_params=None):
        lr = schedule(int(state["count"]))
        if momentum:
            mom = T.tree_map(lambda m, g: momentum * m + g, state["mom"],
                             grads)
            eff = (T.tree_map(lambda m, g: momentum * m + g, mom, grads)
                   if nesterov else mom)
        else:
            mom, eff = None, grads
        updates = _moved(T.tree_map(lambda g: -lr * g, eff), to_params)
        return updates, {"count": int(state["count"]) + 1, "mom": mom}

    return Optimizer(init, update)


def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay; moments in f32.  The step count is
    a python int (a 0-d JAX count carried over by
    ``tree.params_from_jax`` works too)."""

    def init(params):
        return {"count": 0,
                "m": T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                params),
                "v": T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                params)}

    def update(grads, state, params, to_params=None):
        count = int(state["count"]) + 1
        lr = schedule(int(state["count"]))
        m = T.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                       state["m"], grads)
        v = T.tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                       state["v"], grads)
        # bias corrections in f32, as the JAX update computes them
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))

        def upd(j, m_, v_, p):
            step = m_ / c1 / (torch.sqrt(v_ / c2) + eps)
            # the moment step in the moments' layout, the decay in the
            # params': the same elementwise operations, so the same bits
            if to_params is not None:
                step = to_params(j, step)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr * step).to(p.dtype)

        updates = T.unflatten(params, [
            upd(j, *a) for j, a in enumerate(zip(
                T.leaves(m), T.leaves(v), T.leaves(params)))])
        return updates, {"count": count, "m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Gradient transform: rescale so ||g|| <= max_norm (chainable).  The
    scale stays a tensor on the grads' device."""

    def init(params):
        return {}

    def update(grads, state, params, to_params=None):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
        return _moved(T.tree_map(lambda g: g * scale, grads),
                      to_params), state

    return Optimizer(init, update)


def chain(*transforms: Optimizer) -> Optimizer:
    """Compose gradient transforms; the last one produces the final
    deltas."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params, to_params=None):
        new_states = []
        for i, (t, s) in enumerate(zip(transforms, state)):
            # the last transform's deltas leave in the params' layout
            last = i == len(transforms) - 1
            grads, s = t.update(grads, s, params,
                                to_params=to_params if last else None)
            new_states.append(s)
        return grads, tuple(new_states)

    return Optimizer(init, update)
