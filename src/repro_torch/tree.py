"""Nested-dict pytrees with JAX's flatten order.

JAX flattens a dict by sorted key and a list/tuple by position; the wire's
leaf order, the per-leaf codecs and ``leaf_paths`` all depend on that
order, so the port flattens the same way.  Containers are dicts, lists and
tuples; ``None`` is an empty subtree; anything else is a leaf.

:func:`params_from_jax` and :func:`params_to_numpy` carry trees between the
JAX package and the port, leaf by leaf: a JAX params tree (or control
variates, or AdamW state) converted to numpy
(``jax.tree.map(np.asarray, tree)``) becomes the same nested dict of torch
tensors, and back.  Leaves keep their shapes and dtypes, so paths, sizes
and flatten order are unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

PyTree = Any


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_path(tree: PyTree) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path segments, leaf)] in JAX's flatten order."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    _walk(tree, (), out)
    return out


# The recursions are module-level functions: a nested function that calls
# itself is a reference cycle, which would keep its closure (the leaves)
# alive until the garbage collector runs.
def _walk(t, path, out):
    if t is None:
        return
    if _is_node(t):
        for k, v in _children(t):
            _walk(v, path + (k,), out)
    else:
        out.append((path, t))


def leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: PyTree, new_leaves) -> PyTree:
    """A tree of ``like``'s structure holding ``new_leaves`` in flatten
    order."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def _build(t, it):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` applied leaf-wise over trees of one structure."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("tree_map over trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])


def params_from_jax(tree_of_numpy: PyTree, device="cuda") -> PyTree:
    """Numpy (or numpy-convertible) leaves -> torch tensors on ``device``;
    python scalars stay python scalars."""
    dev = resolve_device(device)

    def one(x):
        if isinstance(x, (int, float)):
            return x
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return tree_map(one, tree_of_numpy)


def params_to_numpy(tree: PyTree) -> PyTree:
    """Torch tensors -> numpy arrays on the host; python scalars stay."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)
