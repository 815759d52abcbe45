"""Hand-written CUDA kernels of the port, with their plain PyTorch versions
(``ref.py``) and wrappers (``pack.py``, ``threefry.py``,
``ops.py``: also the ordered worker sum); ``build.py`` compiles ``csrc/`` at first use.

``LAUNCHES`` counts kernel launches by kernel name.  A wrapper adds one
where it launches its kernel and nowhere else (its plain version on a CPU
tensor counts nothing), so a run can show that its main path went through
the kernels.

Sanitize mode (``--sanitize``, JAX's ``repro/analysis/sanitize.py``):
:func:`enable` routes every wrapper to its plain version on CUDA tensors
too, where an out-of-range index raises (the counterpart of Pallas's
interpret mode; ``LAUNCHES`` then stays 0), and marks the process and its
children through ``REPRO_TORCH_SANITIZE=1``.  The NaN half is the
trainer's (``train.trainer.sanitized_step``).  JAX's ``REPRO_SANITIZE``
does not switch it.  Inside :func:`dry_run` (the dry run's scope) a
wrapper given ``meta`` tensors allocates the outputs its kernel writes
and computes nothing; elsewhere it refuses them.
"""

import contextlib
import os
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"pack_update": 0, "qsgd_pack_update": 0,
                            "randk_update": 0, "threefry_uniform": 0,
                            "block_topk": 0, "efbv_update": 0,
                            "threefry_rows": 0, "worker_sum": 0,
                            "shuffle_rows": 0}

#: the environment variable that marks a process as sanitized (and its
#: children: ``torchrun`` ranks, ``--processes`` workers, spawned tests)
SANITIZE_ENV = "REPRO_TORCH_SANITIZE"
_sanitize = False
_dry_run = False


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def active() -> bool:
    """Sanitize mode on?  True once :func:`enable` ran in this process or
    ``REPRO_TORCH_SANITIZE=1`` marks an enabling parent."""
    return _sanitize or os.environ.get(SANITIZE_ENV, "") == "1"


def enable() -> None:
    """Switch this process, and the processes it starts after, into
    sanitize mode (idempotent)."""
    global _sanitize
    _sanitize = True
    os.environ[SANITIZE_ENV] = "1"


def plain_route(device: torch.device) -> bool:
    """Whether a wrapper runs its plain version on ``device``: on the CPU
    always, on the card in sanitize mode."""
    return device.type == "cpu" or (device.type == "cuda" and active())


@contextlib.contextmanager
def dry_run():
    """The dry run's scope (``launch/train.py::dryrun_one``): the wrappers
    take ``meta`` tensors, allocating their kernels' outputs."""
    global _dry_run
    _dry_run = True
    try:
        yield
    finally:
        _dry_run = False


def check_device(name: str, device: torch.device) -> None:
    """The wrappers' device rule past :func:`plain_route`: the card, or
    ``meta`` inside :func:`dry_run` (outputs allocated, nothing
    computed)."""
    if device.type != "cuda" and not (device.type == "meta" and _dry_run):
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
