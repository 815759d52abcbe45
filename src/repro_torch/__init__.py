"""PyTorch/CUDA port of the EF-BV system (``repro``), slice by slice.

Each sub-package mirrors ``repro`` module for module, with tensors in the
JAX package's layout (params as nested dicts, stacked layers on a leading
L axis, ``x @ W`` weights) so leaf paths, leaf sizes and the wire's
per-leaf padding are identical.  The port imports neither JAX nor
``repro``; only the tests import both.

Entry points take an explicit ``device`` and default to ``"cuda"``; a CUDA
request on a machine without a GPU raises instead of falling back to the
CPU (see :func:`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, refusing a CUDA device when no
    GPU is present -- the port never falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
