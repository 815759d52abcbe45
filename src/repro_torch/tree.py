"""Nested-dict pytrees with JAX's flatten order.

JAX flattens a dict by sorted key and a list/tuple by position; the wire's
leaf order, the per-leaf codecs and ``leaf_paths`` all depend on that
order, so the port flattens the same way.  Containers are dicts, lists and
tuples; ``None`` is an empty subtree; anything else is a leaf, and so is
any node for which the optional ``is_leaf`` says so (a tuple of axis names
in a tree of parameter specs, say).

:func:`params_from_jax` and :func:`params_to_numpy` carry trees between the
JAX package and the port, leaf by leaf: a JAX params tree (or control
variates, or AdamW state) converted to numpy
(``jax.tree.map(np.asarray, tree)``) becomes the same nested dict of torch
tensors, and back.  Leaves keep their shapes and dtypes, so paths, sizes
and flatten order are unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

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


def flatten_with_path(tree: PyTree, is_leaf: Optional[Callable] = None
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path segments, leaf)] in JAX's flatten order."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    _walk(tree, (), out, is_leaf)
    return out


# The recursions are module-level functions: a nested function that calls
# itself is a reference cycle, which would keep its closure (the leaves)
# alive until the garbage collector runs.
def _walk(t, path, out, is_leaf):
    if t is None:
        return
    if _is_node(t) and not (is_leaf is not None and is_leaf(t)):
        for k, v in _children(t):
            _walk(v, path + (k,), out, is_leaf)
    else:
        out.append((path, t))


def leaves(tree: PyTree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def unflatten(like: PyTree, new_leaves,
              is_leaf: Optional[Callable] = None) -> PyTree:
    """A tree of ``like``'s structure holding ``new_leaves`` in flatten
    order."""
    it = iter(new_leaves)
    out = _build(like, it, is_leaf)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def _build(t, it, is_leaf):
    if t is None:
        return None
    if is_leaf is not None and is_leaf(t):
        return next(it)
    if isinstance(t, dict):
        return {k: _build(t[k], it, is_leaf) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it, is_leaf) for v in t)
    return next(it)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable] = None) -> PyTree:
    """``fn`` applied leaf-wise over trees of one structure (``is_leaf``
    decides the leaves of ``tree``; ``rest`` is flattened to as many)."""
    flat = leaves(tree, is_leaf)
    others = [leaves(r, is_leaf) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("tree_map over trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)], is_leaf)


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
