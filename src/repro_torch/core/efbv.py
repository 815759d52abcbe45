"""EF-BV (Algorithm 1) on tensors: the worker and master updates
(``repro/core/efbv.py``).

Ported so far: :class:`EFBV` with ``make`` (Remark 1 auto-tuning through
``theory.tune_for``), ``init``, ``worker_update`` and ``master_update``.
Participation, pipelining, downlinks, fleets and per-leaf rules are not
yet ported.

Rounding: the JAX reference runs these updates under ``jit``, where XLA
contracts ``h + c * d`` into a fused multiply-add.  ``torch.add(h, d,
alpha=c)`` computes the same fused result, so it is the spelling here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import theory
from repro_torch.core.compressors import Compressor

PyTree = Any


class EFBVState(NamedTuple):
    h: PyTree        # per-worker control variates, leading axis n
    h_avg: PyTree    # master's control variate (1/n) sum_i h_i
    step: int


@dataclasses.dataclass(frozen=True)
class EFBV:
    """lam scales the control-variate update (variance reduction), nu the
    gradient-estimate update (error feedback).  nu = lam -> EF21;
    nu = 1 -> DIANA."""

    compressor: Compressor
    lam: float
    nu: float

    @staticmethod
    def make(compressor: Compressor, d: int, n: int,
             mode: theory.Mode = "efbv", independent: bool = True) -> "EFBV":
        """Auto-tuned instance (Remark 1)."""
        t = theory.tune_for(compressor, d, n, independent=independent,
                            mode=mode)
        return EFBV(compressor, lam=t.lam, nu=t.nu)

    def init(self, params: PyTree, n: int) -> EFBVState:
        """h_i^0 = 0, stacked on a leading worker axis; h_avg^0 = 0."""
        h = T.tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                             dtype=p.dtype, device=p.device),
                       params)
        return EFBVState(h=h, h_avg=T.tree_map(torch.zeros_like, params),
                         step=0)

    def worker_update(self, h: PyTree, d: PyTree) -> PyTree:
        """h_i <- h_i + lam d_i."""
        return T.tree_map(lambda hj, dj: torch.add(hj, dj, alpha=self.lam),
                          h, d)

    def master_update(self, h_avg: PyTree, d_bar: PyTree
                      ) -> Tuple[PyTree, PyTree]:
        """g <- h + nu d_bar ; h <- h + lam d_bar.  Returns (g, new h_avg)."""
        g = T.tree_map(lambda hj, dj: torch.add(hj, dj, alpha=self.nu),
                       h_avg, d_bar)
        return g, self.worker_update(h_avg, d_bar)
