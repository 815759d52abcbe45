"""Optimizers and learning-rate schedules (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, sgd, adamw, apply_updates, global_norm, clip_by_global_norm,
    chain,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine, wsd, linear_warmup,
)
