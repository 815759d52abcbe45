"""Carry trees between the JAX package and the port, leaf by leaf.

A JAX params tree (or control variates, or AdamW state) converted to numpy
(``jax.tree.map(np.asarray, tree)``) becomes the same nested dict of torch
tensors, and back.  Leaves keep their shapes and dtypes, so paths, sizes and
flatten order are unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as T

PyTree = Any


def params_from_jax(tree_of_numpy: PyTree, device="cuda") -> PyTree:
    """Numpy (or numpy-convertible) leaves -> torch tensors on ``device``;
    python scalars stay python scalars."""
    dev = resolve_device(device)

    def one(x):
        if isinstance(x, (int, float)):
            return x
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return T.tree_map(one, tree_of_numpy)


def params_to_numpy(tree: PyTree) -> PyTree:
    """Torch tensors -> numpy arrays on the host; python scalars stay."""
    return T.tree_map(lambda x: x.detach().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x, tree)
