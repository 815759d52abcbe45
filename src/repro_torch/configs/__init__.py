"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

The port has the architectures of its finished slices; the rest of the JAX
package's registry raises as not yet ported.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCHS = ["qwen2-0.5b"]
NOT_PORTED = ["minitron-8b", "granite-moe-3b-a800m", "mamba2-130m",
              "phi3-medium-14b", "qwen2-vl-2b", "dbrx-132b", "whisper-medium",
              "minicpm-2b", "zamba2-7b"]


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; ported: {ARCHS}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs() -> List[str]:
    return list(ARCHS)


def known_archs() -> List[str]:
    """The JAX package's arch ids: the ported ones and the rest (what an
    experiment spec may name)."""
    return ARCHS + NOT_PORTED
