"""EF-BV (Algorithm 1) on tensors: the worker and master updates
(``repro/core/efbv.py``).

Ported so far: :class:`EFBV` with ``make`` (Remark 1 auto-tuning through
``theory.tune_for``, the pipelined schedule's delay included), ``init``,
``worker_update`` and ``master_update``; the round keys' fold tags;
:class:`Pipeline` (depth 0 or 1); and :class:`Downlink` with a QSGD
broadcast.  Participation, other downlink compressors, fleets and per-leaf
rules are not yet ported.

Rounding: the JAX reference runs these updates under ``jit``, where XLA
contracts ``h + c * d`` into a fused multiply-add.  ``torch.add(h, d,
alpha=c)`` computes the same fused result, so it is the spelling here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core import theory
from repro_torch.core.compressors import QSGD, Compressor, make_compressor

PyTree = Any

# fold_in tags of the round keys, copied from the JAX package: every
# execution path derives a round's draws from them, so they must not move.
#: per-round participation-mask key
PARTICIPATION_FOLD = 0xFEDE4A7E
#: per-round minibatch-resampling key
RESAMPLE_FOLD = 0x5A3D0B17
#: per-round downlink (master -> worker broadcast) key, shared by every
#: worker: the broadcast is one message
DOWNLINK_FOLD = 0xD0401B17
#: the pipelined schedule's priming-payload key
PIPELINE_FOLD = 0xF1FE11E
#: the reference driver's run key
REFERENCE_FOLD = 0x5EED


def downlink_key(round_key):
    """The shared derivation of the broadcast key from a round key."""
    return random.fold_in(round_key, DOWNLINK_FOLD)


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
             mode: theory.Mode = "efbv", independent: bool = True,
             pipeline: Optional[int] = None) -> "EFBV":
        """Auto-tuned instance (Remark 1).  ``pipeline`` is the staleness
        depth of the pipelined schedule: the one-round delay is folded into
        the certified constants (``theory.pipeline_eta`` /
        ``pipeline_omega``); None or 0 changes nothing."""
        t = theory.tune_for(compressor, d, n, independent=independent,
                            mode=mode, pipeline=pipeline)
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


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """The pipelined (one-round-stale) schedule.  ``depth = 0`` is the
    sequential schedule: round t applies round t's messages.  ``depth = 1``
    double-buffers the payload: round t applies the messages compressed at
    round t-1 (``TrainState.inflight``) while its own take their slot.
    Workers advance h_i on their own round-t messages; only the master's
    (g, h_avg) recursion lags one round.  Deeper pipelines are refused."""

    depth: int = 0

    def __post_init__(self):
        if not isinstance(self.depth, int) or self.depth < 0:
            raise ValueError(
                f"pipeline depth must be an int >= 0, got {self.depth!r}")
        if self.depth > 1:
            raise ValueError(
                f"pipeline depth {self.depth} not implemented: the trainers "
                "double-buffer exactly ONE in-flight payload; use 'off' or "
                "'depth:1'")

    @staticmethod
    def parse(spec: str) -> "Pipeline":
        """The CLI syntax: '' | 'off' | 'depth:k' (k in {0, 1}), with the
        JAX package's grammar and errors."""
        if not spec or spec == "off":
            return Pipeline(depth=0)
        name, _, arg = spec.partition(":")
        if name == "depth" and arg:
            try:
                depth = int(arg)
            except ValueError:
                raise ValueError(f"pipeline spec {spec!r} (want off | "
                                 "depth:0 | depth:1)") from None
            return Pipeline(depth=depth)
        raise ValueError(f"pipeline spec {spec!r} (want off | depth:0 | "
                         "depth:1)")

    @property
    def is_off(self) -> bool:
        return self.depth == 0


@dataclasses.dataclass(frozen=True)
class Downlink:
    """Master-side EF-BV state for the server -> worker model broadcast.

    The master keeps a control variate ``w``, the workers' shared
    reconstruction of the model, and each round broadcasts the compressed
    model innovation through the compressor's wire codec:

        q^t   = C_s(x^{t+1} - w^t)          (one message, every worker)
        w^t+1 = w^t + lam_s * q^t

    Workers evaluate their gradients at ``w``.  Ported so far: QSGD as
    C_s."""

    compressor: Compressor
    lam: float = 1.0

    @staticmethod
    def parse(spec: str) -> Optional["Downlink"]:
        """CLI syntax: '' | 'none' -> None (uncompressed dense broadcast);
        'qsgd:S', optionally '@lam' for the downlink scaling
        ('qsgd:16@0.9').  Other compressors are not yet ported."""
        if not spec or spec == "none":
            return None
        comp_spec, _, lam_s = spec.partition("@")
        compressor = make_compressor(comp_spec)
        if not isinstance(compressor, QSGD):
            raise NotImplementedError(
                f"downlink {comp_spec!r} is not yet ported to repro_torch "
                "(ported: qsgd)")
        return Downlink(compressor=compressor,
                        lam=float(lam_s) if lam_s else 1.0)

    def format_for(self, tree: PyTree, *, wire_dtype: str = "float32"):
        """The downlink WireFormat (one broadcast message per round)."""
        from repro_torch.distributed import wire
        return wire.format_for(self.compressor, tree, wire_dtype=wire_dtype)

    def broadcast(self, key, x: PyTree, w: PyTree, *,
                  wire_dtype: str = "float32") -> Tuple[PyTree, list]:
        """One downlink round: returns ``(w_new, payloads)``, with leaf j
        encoded under ``fold_in(key, j)`` and
        ``w_new = w + lam_s * decode(payload)``, computed from the decoded
        payload so master and workers agree bit for bit."""
        from repro_torch.distributed import wire
        payloads, new_leaves = [], []
        for j, (xj, wj) in enumerate(zip(T.leaves(x), T.leaves(w))):
            codec = wire.codec_of(self.compressor, tuple(xj.shape),
                                  xj.numel(), wire_dtype)
            kj = None if key is None else random.fold_in(key, j)
            delta = (xj.float() - wj.float()).reshape(-1)
            payload = codec.encode(kj, delta)
            payloads.append(payload)
            q = codec.decode(payload).reshape(xj.shape)
            new_leaves.append((wj.float() + self.lam * q).to(wj.dtype))
        return T.unflatten(w, new_leaves), payloads
