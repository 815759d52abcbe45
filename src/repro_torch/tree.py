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

import os
import re
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


# --------------------------------------------------------------------------
# checkpoint (``repro/checkpoint/npz.py``)
# --------------------------------------------------------------------------
#
# One ``step_%08d.npz`` per checkpoint, written to ``.tmp_step_%08d.npz``
# and moved into place with ``os.replace``; leaves are addressed by their
# tree paths joined by ``|`` ('params|layers|attn|wq'), in JAX's flatten
# order.  ``save_checkpoint(..., spec=)`` embeds the experiment spec's JSON
# and fingerprint, and a spec-gated restore refuses a checkpoint whose
# fingerprint differs (the message prints both specs).

_SEP = "|"
#: reserved npz entry names for the embedded experiment identity (never
#: valid tree paths: leaf keys cannot start with '__spec')
SPEC_JSON_KEY = "__spec_json__"
SPEC_FINGERPRINT_KEY = "__spec_fingerprint__"
_META_KEYS = frozenset({SPEC_JSON_KEY, SPEC_FINGERPRINT_KEY})


def _flat(tree: PyTree) -> dict:
    """{'|'-joined path: host numpy array} of every leaf."""
    return {_SEP.join(path): (leaf.detach().cpu().numpy()
                              if isinstance(leaf, torch.Tensor)
                              else np.asarray(leaf))
            for path, leaf in flatten_with_path(tree)}


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save_checkpoint(ckpt_dir: str, step: int, tree: PyTree, *,
                    spec=None) -> str:
    """Write one atomic npz checkpoint; ``spec`` (an ExperimentSpec) embeds
    the experiment identity for fingerprint-gated resume."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_path(ckpt_dir, step)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}.npz")
    flat = _flat(tree)
    if spec is not None:
        flat[SPEC_JSON_KEY] = np.asarray(spec.to_json())
        flat[SPEC_FINGERPRINT_KEY] = np.asarray(spec.fingerprint())
    np.savez(tmp, **flat)  # the .npz suffix keeps numpy from renaming
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_latest(ckpt_dir: str, template: PyTree, *, spec=None):
    """Restore the newest checkpoint in ``ckpt_dir``: ``(step, tree)``, or
    None when the directory holds none.  ``spec`` gates identity as in
    :func:`restore_checkpoint`."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return step, restore_checkpoint(ckpt_dir, step, template, spec=spec)


def saved_spec(ckpt_dir: str, step: int):
    """The ExperimentSpec embedded in a checkpoint, or None for a spec-less
    file."""
    from repro_torch.core import ExperimentSpec

    data = np.load(_step_path(ckpt_dir, step))
    if SPEC_JSON_KEY not in data.files:
        return None
    return ExperimentSpec.from_json(str(data[SPEC_JSON_KEY][()]))


def restore_checkpoint(ckpt_dir: str, step: int, template: PyTree, *,
                       spec=None) -> PyTree:
    """Restore a checkpoint into ``template``'s structure: each leaf a
    tensor of the template leaf's dtype on its device (the host for a
    ``meta`` leaf), or a numpy array for a numpy leaf.  ``spec`` gates the resume on experiment identity: the
    embedded fingerprint must equal ``spec.fingerprint()``, else the
    restore is refused with both specs printed; a spec-less checkpoint
    cannot satisfy a spec-gated restore (``spec=None`` opts out)."""
    path = _step_path(ckpt_dir, step)
    data = np.load(path)
    if spec is not None:
        if SPEC_FINGERPRINT_KEY not in data.files:
            raise ValueError(
                f"checkpoint {path} embeds no experiment spec but the "
                "restore is spec-gated; re-save with save_checkpoint(..., "
                "spec=...) or pass spec=None to skip the identity check")
        saved_fp = str(data[SPEC_FINGERPRINT_KEY][()])
        want_fp = spec.fingerprint()
        if saved_fp != want_fp:
            saved_json = str(data[SPEC_JSON_KEY][()]) \
                if SPEC_JSON_KEY in data.files else "<missing>"
            raise ValueError(
                f"refusing resume: checkpoint spec fingerprint {saved_fp} "
                f"!= requested {want_fp}.\n--- checkpoint spec ---\n"
                f"{saved_json}\n--- requested spec ---\n{spec.to_json()}")
    paths = [_SEP.join(p) for p, _ in flatten_with_path(template)]
    files = set(data.files) - _META_KEYS
    missing = set(paths) - files
    extra = files - set(paths)
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    new_leaves = []
    for key, leaf in zip(paths, leaves(template)):
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            # a meta template (``Model.init_abstract``) restores to the host
            dev = "cpu" if leaf.device.type == "meta" else leaf.device
            t = torch.from_numpy(np.array(arr, copy=True))
            new_leaves.append(t.to(device=dev, dtype=leaf.dtype))
        else:
            new_leaves.append(arr.astype(np.asarray(leaf).dtype))
    return unflatten(template, new_leaves)
