"""EF-BV (Algorithm 1) on tensors, with EF21 / DIANA as parametrizations
(``repro/core/efbv.py``).

The whole module: :class:`EFBV` (``make`` with Remark 1's auto-tuning,
heterogeneous fleets, per-leaf rules, partial participation and the
pipelined schedule's delay; ``ef21`` / ``diana``; ``init``; the worker and
master updates; ``compress_delta`` and ``compress_round``;
``step`` and ``step_federated``), the round keys' fold tags,
:class:`Participation`, :class:`Pipeline`, :class:`Downlink` with any zoo
compressor, the proximal operators, and the reference driver
:func:`run_reference` (Algorithm 1 over n workers in one process, the
workers batched as JAX's ``vmap`` runs them: one ``Compressor.batch`` call
per leaf, and one ordered-sum kernel per leaf for the mean and the master
update, so a round's launches do not grow with n).

Rounding: the JAX reference runs these updates under ``jit`` (the trainers,
and ``run_reference``'s ``lax.scan``), where XLA contracts ``h + c * d``
into a fused multiply-add.  ``torch.add(h, d, alpha=c)`` computes the same
fused result, so it is the spelling here, with ``x - gamma * g`` as
``torch.add(x, g, alpha=-gamma)``.  A Python constant is rounded to f32
first, as JAX rounds a weakly typed one.  The mean over workers sums in
the order of XLA's CPU reduce (worker order from +0.0 up to 32 workers,
windows of 32 beyond: ``kernels.ops.worker_sum``, the ``worker_sum``
kernel on the card, its plain loop on the CPU) and multiplies by
f32(1/n), as XLA rewrites ``jnp.mean``'s division by a constant; the same
bits on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch import tree as T
from repro_torch.core import theory
from repro_torch.core.compressors import (Compressor, Identity, _f32,
                                          expand_fleet, jsign,
                                          parse_downlink, parse_pipeline)
from repro_torch.kernels import ops, ref

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


@dataclasses.dataclass(frozen=True)
class Participation:
    """Per-round client sampling (the federated execution mode):

    * ``full``      -- every worker participates (the paper's setting);
    * ``bernoulli`` -- worker i participates independently with
      probability ``p``;
    * ``fixed``     -- a uniformly random subset of exactly ``s`` workers.

    Masks are {0., 1.}-valued f32, so gating is arithmetic: ``m * d``
    zeroes an absent worker's message and ``where(m > 0, h', h)`` keeps its
    control variate stale, both bitwise identities at m = 1."""

    kind: str = "full"
    p: float = 1.0   # bernoulli inclusion probability
    s: int = 0       # fixed-size participant count

    def __post_init__(self):
        if self.kind not in ("full", "bernoulli", "fixed"):
            raise ValueError(f"participation kind {self.kind!r}")
        if self.kind == "bernoulli" and not 0.0 < self.p <= 1.0:
            raise ValueError(
                f"bernoulli participation needs 0 < p <= 1, got {self.p}")
        if self.kind == "fixed" and self.s < 1:
            raise ValueError(
                f"fixed participation needs s >= 1, got {self.s}")

    @staticmethod
    def parse(spec: str) -> "Participation":
        """The CLI syntax: 'full' | 'bernoulli:p' | 'fixed:s'."""
        name, _, arg = spec.partition(":")
        if name == "full":
            return Participation()
        if name == "bernoulli":
            return Participation(kind="bernoulli", p=float(arg))
        if name == "fixed":
            return Participation(kind="fixed", s=int(arg))
        raise ValueError(f"participation spec {spec!r} (want full | "
                         "bernoulli:p | fixed:s)")

    @property
    def is_full(self) -> bool:
        return self.kind == "full" or (self.kind == "bernoulli"
                                       and self.p >= 1.0)

    def fraction(self, n: int) -> float:
        """Expected fraction of participating workers, E|S_t| / n."""
        if self.kind == "bernoulli":
            return self.p
        if self.kind == "fixed":
            return min(self.s, n) / n
        return 1.0

    def sample_mask(self, key, n: int, device="cuda") -> torch.Tensor:
        """(n,) f32 participation mask of one round on ``device``, bit for
        bit ``jax``'s: ``bernoulli(key, p, (n,))`` or ``permutation(key, n)
        < s`` (the threefry kernel on the card)."""
        if self.kind == "bernoulli":
            return random.bernoulli(key, self.p, n, device).to(torch.float32)
        if self.kind == "fixed":
            if self.s > n:
                raise ValueError(
                    f"fixed:{self.s} participation with only {n} workers")
            return (random.permutation(key, n, device) < self.s).to(
                torch.float32)
        return torch.ones(n, dtype=torch.float32, device=device)


def participation_key(round_key):
    """The shared derivation of the mask key from a round key."""
    return random.fold_in(round_key, PARTICIPATION_FOLD)


def downlink_key(round_key):
    """The shared derivation of the broadcast key from a round key."""
    return random.fold_in(round_key, DOWNLINK_FOLD)


def _sum_weights(c, mask: Optional[torch.Tensor]):
    """The ordered sum's weights for messages y * c (c a float, a fleet's
    (n,) scales, or None) under the mask: None (a plain sum), the mask, c,
    or f32(m_i * c) (XLA's fused reduce folds the constant into the mask's
    product and contracts the product into the add)."""
    if c is None:
        return mask
    return c if mask is None else mask * np.float32(c)


def _mean_coef(coef: float, n: int) -> float:
    """The master update's folded constant: h + coef * mean, the mean
    d_sum * f32(1/n) computed in the same XLA fusion, folds coef * (d_sum *
    (1/n)) into d_sum * f32(f32(coef) * f32(1/n)) and contracts the product
    into the add, one fma(d_sum, that constant, h)."""
    return _f32(_f32(coef) * np.float32(_f32(1.0 / n)))


def _bcast(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The (n,) mask shaped to broadcast over a worker-stacked leaf."""
    return m.reshape((m.shape[0],) + (1,) * (like.dim() - 1))


class EFBVState(NamedTuple):
    h: PyTree        # per-worker control variates, leading axis n
    h_avg: PyTree    # master's control variate (1/n) sum_i h_i
    step: int


@dataclasses.dataclass(frozen=True)
class EFBV:
    """lam scales the control-variate update (variance reduction), nu the
    gradient-estimate update (error feedback).  nu = lam -> EF21;
    nu = 1 -> DIANA.

    ``fleet`` is the heterogeneous setting: worker i runs ``fleet[i]``
    (length n, round-robin expanded), ``compressor`` holds ``fleet[0]``;
    a homogeneous fleet collapses to ``fleet=None``.  ``leaf_rules`` are
    (fnmatch pattern, Compressor) pairs resolved against each leaf's
    '/'-joined path, first match wins; unmatched leaves keep
    ``compressor``."""

    compressor: Compressor
    lam: float
    nu: float
    fleet: Optional[Tuple[Compressor, ...]] = None
    leaf_rules: Optional[Tuple[Tuple[str, Compressor], ...]] = None

    @staticmethod
    def make(compressor, d: int, n: int, mode: theory.Mode = "efbv",
             independent: bool = True,
             participation: Optional[float] = None,
             pipeline: Optional[int] = None,
             leaf_rules: Optional[Tuple[Tuple[str, Compressor], ...]] = None
             ) -> "EFBV":
        """Auto-tuned instance (Remark 1).  ``participation`` is the
        expected per-round participation fraction p: (lam, nu) are then
        tuned for the effective compressor b*C, b ~ Bernoulli(p)
        (``theory.tune_partial``).  ``pipeline`` is the staleness depth of
        the pipelined schedule, folded into the certified constants; None
        or 0 changes nothing.  A sequence of compressors is a fleet,
        round-robin expanded to n members and tuned through
        ``theory.tune_fleet``; ``leaf_rules`` tune for the worst-case
        composition over the base compressor and every rule member
        (``theory.tune_tree``)."""
        if isinstance(compressor, (list, tuple)):
            if leaf_rules:
                raise ValueError("per-leaf codec rules cannot be combined "
                                 "with a heterogeneous worker fleet")
            members = expand_fleet(tuple(compressor), n)
            t = theory.tune_for(members, d, n, independent=independent,
                                mode=mode, participation=participation,
                                pipeline=pipeline)
            fleet = None if len(set(members)) == 1 else members
            return EFBV(members[0], lam=t.lam, nu=t.nu, fleet=fleet)
        if leaf_rules:
            if not independent:
                raise ValueError("per-leaf codec tuning assumes independent "
                                 "per-worker compressors")
            comps = [compressor] + [c for _, c in leaf_rules]
            if any(getattr(c, "joint", False) for c in comps):
                raise ValueError(
                    "jointly-defined compressors (m-nice) cannot be "
                    "leaf-codec rules: their draws couple all workers")
            t = theory.tune_tree([c.eta(d) for c in comps],
                                 [c.omega(d) for c in comps],
                                 n=n, aggregate="worst", mode=mode,
                                 participation=participation,
                                 pipeline=pipeline)
            return EFBV(compressor, lam=t.lam, nu=t.nu,
                        leaf_rules=tuple(leaf_rules))
        t = theory.tune_for(compressor, d, n, independent=independent,
                            mode=mode, participation=participation,
                            pipeline=pipeline)
        return EFBV(compressor, lam=t.lam, nu=t.nu)

    @staticmethod
    def ef21(compressor: Compressor, d: int, n: int) -> "EFBV":
        return EFBV.make(compressor, d, n, mode="ef21")

    @staticmethod
    def diana(compressor: Compressor, d: int, n: int) -> "EFBV":
        return EFBV.make(compressor, d, n, mode="diana")

    def init(self, params: PyTree, n: int) -> EFBVState:
        """h_i^0 = 0, stacked on a leading worker axis; h_avg^0 = 0."""
        h = T.tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                             dtype=p.dtype, device=p.device),
                       params)
        return EFBVState(h=h, h_avg=T.tree_map(torch.zeros_like, params),
                         step=0)

    # ---- the algorithm's pieces ---------------------------------------------

    def _leaf_comps(self, tree: PyTree, sizes) -> list:
        """The compressor of each leaf: ``self.compressor`` everywhere, or
        with ``leaf_rules`` the one the leaf's path resolves to, clamped to
        the leaf's size (one worker's size: ``sizes[j]``)."""
        from repro_torch.distributed import wire
        if not self.leaf_rules:
            return [self.compressor] * len(sizes)
        return [wire.clamp_for_leaf(
            wire.resolve_leaf(self.leaf_rules, p, self.compressor), size)
            for p, size in zip(wire.leaf_paths(tree), sizes)]

    def compress_delta(self, key, grad: PyTree, h: PyTree,
                       compressor: Optional[Compressor] = None) -> PyTree:
        """d_i = C_i(grad_i - h_i), leaf j under ``fold_in(key, j)``.
        ``compressor`` overrides ``self.compressor`` (a fleet member); with
        ``leaf_rules`` (and no override) each leaf runs the compressor its
        path resolves to, clamped to the leaf's size."""
        leaves, h_leaves = T.leaves(grad), T.leaves(h)
        if compressor is None:
            comps = self._leaf_comps(grad, [g.numel() for g in leaves])
        else:
            comps = [compressor] * len(leaves)
        outs = []
        for j, (cj, g, hj) in enumerate(zip(comps, leaves, h_leaves)):
            kj = None if key is None else random.fold_in(key, j)
            outs.append(cj(kj, g - hj))
        return T.unflatten(grad, outs)

    def worker_update(self, h: PyTree, d: PyTree) -> PyTree:
        """h_i <- h_i + lam d_i."""
        return T.tree_map(lambda hj, dj: torch.add(hj, dj, alpha=self.lam),
                          h, d)

    def master_update(self, h_avg: PyTree, d_bar: PyTree
                      ) -> Tuple[PyTree, PyTree]:
        """g <- h + nu d_bar ; h <- h + lam d_bar.  Returns (g, new h_avg).
        Under partial participation absent workers' messages are zero and
        d_bar stays normalised by n, which keeps h_avg = (1/n) sum_i h_i."""
        g = T.tree_map(lambda hj, dj: torch.add(hj, dj, alpha=self.nu),
                       h_avg, d_bar)
        return g, self.worker_update(h_avg, d_bar)

    # ---- the reference round (the workers batched) ---------------------------

    def _fleet_rows(self, n: int, device):
        """[(member, its workers' rows as a numpy array and as an index
        tensor on ``device``)] for each distinct fleet member, in the order
        of first appearance: one batch call each."""
        if len(self.fleet) != n:
            raise ValueError(f"fleet of {len(self.fleet)} members for {n} "
                             "workers (expand_fleet sizes it to n)")
        rows = {}
        for i, c in enumerate(self.fleet):
            rows.setdefault(c, []).append(i)
        return [(c, np.asarray(r), torch.tensor(r, device=device))
                for c, r in rows.items()]

    def _compress_workers(self, keys, grads: PyTree, h: PyTree, n: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[list, PyTree]:
        """(per leaf the terms (y, w, order) of the ordered sum of the
        worker-stacked messages d_i = C_i(grad_i - h_i), the advanced h),
        ``vmap`` over the workers: leaf j of worker i under ``fold_in(keys[i], j)``, one
        ``batch`` call per leaf (a fleet: one per distinct member on its
        workers' rows, scattered back in worker order; JAX loops over a
        fleet, the bits are the same).

        Where the compressor ends in a product by an f32 constant, d = y *
        c (rand-k, comp; a fleet has an (n,) tensor of each worker's c, 1
        for the others), jitted JAX rounds as follows (fault u): under
        ``vmap`` it folds lam into c, h_i' = fma(y, f32(lam * c), h); up to
        32 workers its fused reduce contracts the sum's product, acc =
        fma(y, w, acc) with w = c or f32(m * c), beyond 32 (fault v: XLA
        cuts the reduce into windows) it sums d = y * c, rounded, under
        the mask; across a fleet's stacked workers h_i' = fma(d, lam, h),
        and the sum unmasked contracts too but unrolled at every n
        ("unrolled"), its first pair fma(y_0, c_0, y_1 * c_1) ("pair"),
        masked it reduces m * d.  Otherwise h_i' = fma(d, lam, h) and w =
        m (None: a plain sum).  Under a mask an absent worker keeps its h_i
        verbatim."""
        leaves, h_leaves = T.leaves(grads), T.leaves(h)
        groups = None
        if self.fleet is not None:
            groups = self._fleet_rows(n, leaves[0].device)
            comps = [None] * len(leaves)
        else:
            comps = self._leaf_comps(grads, [g[0].numel() for g in leaves])
        terms, h_out = [], []
        for j, (cj, g, hj) in enumerate(zip(comps, leaves, h_leaves)):
            kj = random.fold_in(keys, j)
            x = g - hj
            order = "reduce"
            if groups is None:
                y, c = cj.batch_parts(kj, x)
                lam = self.lam if c is None else _f32(_f32(self.lam)
                                                      * np.float32(c))
                hn = torch.add(hj, y, alpha=lam)
                if c is not None and n > ref.REDUCE_WINDOW:
                    y, c = y * c, None
            else:
                y, c, order = self._fleet_batch(groups, kj, x)
                d = y if c is None else y * _bcast(c, y)
                hn = torch.add(hj, d, alpha=self.lam)
                if mask is not None:
                    y, c, order = d, None, "reduce"
            if mask is not None:
                hn = torch.where(_bcast(mask, hj) > 0, hn, hj)
            terms.append((y, _sum_weights(c, mask), order))
            h_out.append(hn)
        return terms, T.unflatten(h, h_out)

    @staticmethod
    def _fleet_batch(groups, keys, x: torch.Tensor):
        """(y, c, order) of a fleet's leaf: each distinct member's
        ``batch_parts`` on its workers' rows, scattered back in worker
        order; c the (n,) f32 scales (1 where a member has none), or None
        if no member has one; ``order`` "pair" where worker 0's message
        ends in a product by a constant other than 1 (then XLA's unrolled
        sum contracts that product with the second term; measured on
        fleets led by rand-k, comp and frac-comp, and by top-k and
        natural, which take the plain order, "unrolled")."""
        y = torch.empty_like(x)
        scales = []
        for member, rows, idx in groups:
            ym, cm = member.batch_parts(keys[rows], x[idx])
            y[idx] = ym
            scales.append((idx, cm))
        if all(cm is None for _, cm in scales):
            return y, None, "unrolled"
        c = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        for idx, cm in scales:
            if cm is not None:
                c.index_fill_(0, idx, cm)
        lead = scales[0][1]  # groups[0] holds worker 0
        return y, c, ("pair" if lead is not None and lead != 1.0
                      else "unrolled")

    def _compress_stacked(self, key, grads: PyTree, state: EFBVState,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[list, PyTree]:
        """(per leaf the ordered sum's terms (y, w, order), the advanced h):
        the worker half of a round before the sum over workers, which is
        ``kernels.ops.worker_sum(y, w, order=order)``
        (:meth:`_compress_workers` says which weights and order)."""
        n = T.leaves(grads)[0].shape[0]
        if getattr(self.compressor, "joint", False):
            if mask is not None:
                raise ValueError(
                    "jointly-defined compressors (m-nice) model participation "
                    "themselves; combine them with Participation masks is "
                    "ambiguous")
            keep = self.compressor.members(key, T.leaves(grads)[0].device)
            d = T.tree_map(lambda g, h: self.compressor.joint_batch(
                key, g - h, keep), grads, state.h)
            return ([(dj, None, "reduce") for dj in T.leaves(d)],
                    self.worker_update(state.h, d))
        return self._compress_workers(random.split(key, n), grads, state.h,
                                      n, mask)

    def compress_round(self, key, grads: PyTree, state: EFBVState,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[PyTree, PyTree]:
        """The worker half of one round: ``(d_bar, h_new)`` with d_bar =
        (1/n) sum_i [m_i] C_i(grad_i - h_i) and the advanced control
        variates, without the master update.  Worker i draws under
        ``split(key, n)[i]``; a jointly-defined compressor (m-nice) draws
        every worker's share from ``key`` itself."""
        terms, h_new = self._compress_stacked(key, grads, state, mask)
        n = T.leaves(grads)[0].shape[0]
        return T.unflatten(state.h_avg, [
            ops.worker_sum(y, w, order=order) * _f32(1.0 / n)
            for y, w, order in terms]), h_new

    def _round(self, key, grads: PyTree, state: EFBVState,
               mask: Optional[torch.Tensor]) -> Tuple[PyTree, EFBVState]:
        """compress_round then master_update, fused as XLA fuses them
        (:func:`_mean_coef`): per leaf one pass of the ordered sum over
        the workers that also writes g and the new h_avg."""
        terms, h_new = self._compress_stacked(key, grads, state, mask)
        n = T.leaves(grads)[0].shape[0]
        c_g, c_h = _mean_coef(self.nu, n), _mean_coef(self.lam, n)
        pairs = [ops.worker_sum(y, w, hj, c_g, c_h, order)
                 for hj, (y, w, order) in zip(T.leaves(state.h_avg), terms)]
        g = T.unflatten(state.h_avg, [p[0] for p in pairs])
        h_avg = T.unflatten(state.h_avg, [p[1] for p in pairs])
        return g, EFBVState(h=h_new, h_avg=h_avg, step=state.step + 1)

    def step(self, key, grads: PyTree, state: EFBVState
             ) -> Tuple[PyTree, EFBVState]:
        """One round of Algorithm 1 on worker-stacked gradients: returns
        (g^{t+1}, new state); the caller applies the proximal step."""
        return self._round(key, grads, state, None)

    def step_federated(self, key, grads: PyTree, state: EFBVState,
                       mask: torch.Tensor) -> Tuple[PyTree, EFBVState]:
        """One round under client sampling: only the workers of the (n,)
        {0., 1.} ``mask`` contribute and advance h_i; absent workers' zero
        messages still count in the 1/n.  An all-ones mask gives
        :meth:`step`'s bits."""
        if getattr(self.compressor, "joint", False):
            raise ValueError(
                "jointly-defined compressors (m-nice) model participation "
                "themselves; combine them with Participation masks is "
                "ambiguous")
        return self._round(key, grads, state, mask)


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
        """The CLI syntax: '' | 'off' | 'depth:k' (k in {0, 1}), through
        the spec grammar (``compressors.parse_pipeline``)."""
        return Pipeline(depth=parse_pipeline(spec))

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

    Workers evaluate their gradients at ``w``.  Any zoo compressor is
    C_s.  With the identity on an f32 wire and lam_s = 1 the update
    telescopes to w = x, and the broadcast assigns x verbatim.  The same
    channel feeds serving replicas (:meth:`encode_push`,
    :meth:`apply_push`; ``launch/train.py``'s ``DeltaPusher`` and
    ``ServeReplica``)."""

    compressor: Compressor
    lam: float = 1.0

    @staticmethod
    def parse(spec: str) -> Optional["Downlink"]:
        """CLI syntax: '' | 'none' -> None (uncompressed dense broadcast);
        otherwise any zoo compressor spec, optionally '@lam' for the
        downlink scaling ('topk:64@0.9'), through the spec grammar
        (``compressors.parse_downlink``)."""
        parsed = parse_downlink(spec)
        if parsed is None:
            return None
        compressor, lam = parsed
        return Downlink(compressor=compressor, lam=lam)

    def _is_lossless(self, wire_dtype: str) -> bool:
        return (isinstance(self.compressor, Identity) and self.lam == 1.0
                and wire_dtype == "float32")

    def init(self, params: PyTree) -> PyTree:
        """w^0 = x^0 (workers start from the broadcast initial model)."""
        return T.tree_map(torch.clone, params)

    def format_for(self, tree: PyTree, *, wire_dtype: str = "float32"):
        """The downlink WireFormat (one broadcast message per round)."""
        from repro_torch.distributed import wire
        return wire.format_for(self.compressor, tree, wire_dtype=wire_dtype)

    def broadcast(self, key, x: PyTree, w: PyTree, *,
                  wire_dtype: str = "float32",
                  gather: Optional[Callable] = None,
                  shard: Optional[Callable] = None) -> Tuple[PyTree, list]:
        """One downlink round: returns ``(w_new, payloads)``, with leaf j
        encoded under ``fold_in(key, j)`` and
        ``w_new = w + lam_s * decode(payload)``, computed from the decoded
        payload so master and workers agree bit for bit, rounded as jitted
        JAX rounds it (``LeafCodec.update(contract=True)``): once (fused),
        or twice after a decode that ends in a select (QSGD, natural:
        ``LeafCodec.DECODE_SELECTS``; at lam_s = 0.9 on 4096 values the
        other spelling differed from JAX on 58 and 72); a lossless wire
        (the identity at lam_s = 1 on an f32 wire) assigns ``w_new = x``.

        ``gather(j, t)`` and ``shard(j, t)`` (a mesh rank of the ``model``
        axis: x and w are shards) turn leaf j's shard of x - w into the
        logical leaf before the encode, and the decoded logical innovation
        into this rank's shard."""
        from repro_torch.distributed import wire
        payloads, new_leaves = [], []
        for j, (xj, wj) in enumerate(zip(T.leaves(x), T.leaves(w))):
            delta = xj.float() - wj.float()
            if gather is not None:
                delta = gather(j, delta)
            codec = wire.codec_of(self.compressor, tuple(delta.shape),
                                  delta.numel(), wire_dtype)
            kj = None if key is None else random.fold_in(key, j)
            payload = codec.encode(kj, delta.reshape(-1))
            del delta
            payloads.append(payload)
            if self._is_lossless(wire_dtype):
                new_leaves.append(xj)
                continue
            q = codec.decode(payload)
            q = (q if shard is None else shard(j, q)).reshape(xj.shape)
            new_leaves.append(codec.update(wj, q, self.lam, contract=True))
        return T.unflatten(w, new_leaves), payloads

    # ---- the serving push protocol (compressed-delta model distribution) ----

    def serve_format(self, tree: PyTree, *, wire_dtype: str = "float32",
                     rules=None):
        """The wire format of one serving push for ``tree``: the flat
        per-leaf format of :attr:`compressor`, or with per-leaf codec
        ``rules`` the :class:`~repro_torch.distributed.wire.TreeWire`.
        ``wire.push_bits`` of it is the exact envelope size of a push."""
        from repro_torch.distributed import wire
        return wire.tree_format_for(self.compressor, tree,
                                    wire_dtype=wire_dtype,
                                    rules=tuple(rules) if rules else None)

    def push_kind(self, wire_dtype: str = "float32", rules=None) -> str:
        """'snapshot' for a lossless wire (the payload decodes to the model
        and the replica assigns it), 'delta' otherwise; per-leaf ``rules``
        may map a leaf to a lossy codec, so a ruled push is a delta."""
        if rules:
            return "delta"
        return "snapshot" if self._is_lossless(wire_dtype) else "delta"

    def encode_push(self, key, x: PyTree, w: PyTree, *,
                    wire_dtype: str = "float32", rules=None
                    ) -> Tuple[PyTree, list]:
        """The trainer's half of one serving push: ``(w_new, payloads)``.
        Leaf j's payload is the codec's encode of x - w (of x itself for a
        snapshot) under ``fold_in(key, j)``, the bits :meth:`broadcast`
        puts on the wire; ``w_new`` is :meth:`apply_push` of them, the
        replicas' arithmetic, so pusher and replicas agree bit for bit."""
        fmt = self.serve_format(x, wire_dtype=wire_dtype, rules=rules)
        snapshot = self.push_kind(wire_dtype, rules) == "snapshot"
        payloads = []
        for j, (codec, xj, wj) in enumerate(zip(fmt.leaves, T.leaves(x),
                                                T.leaves(w))):
            kj = None if key is None else random.fold_in(key, j)
            flat = xj.float().reshape(-1) if snapshot \
                else (xj.float() - wj.float()).reshape(-1)
            payloads.append(codec.encode(kj, flat))
            del flat
        return self.apply_push(payloads, w, wire_dtype=wire_dtype,
                               rules=rules), payloads

    def apply_push(self, payloads, w: PyTree, *,
                   wire_dtype: str = "float32", rules=None) -> PyTree:
        """The replica's half of one serving push: per leaf ``w + lam *
        decode(payload)`` (a delta) or ``decode(payload)`` verbatim (a
        snapshot).  JAX applies a push eagerly, outside ``jit``, so the
        delta rounds twice, the product and then the sum
        (``LeafCodec.update(contract=False)``), where :meth:`broadcast`
        rounds as the jitted trainer contracts."""
        fmt = self.serve_format(w, wire_dtype=wire_dtype, rules=rules)
        snapshot = self.push_kind(wire_dtype, rules) == "snapshot"
        new_leaves = []
        for codec, wj, p in zip(fmt.leaves, T.leaves(w), payloads):
            q = codec.decode(p).reshape(wj.shape)
            new_leaves.append(q.to(wj.dtype) if snapshot
                              else codec.update(wj, q, self.lam))
        return T.unflatten(w, new_leaves)


# ------------------------------------------------------------------------------
# proximal operators for the composite term R (problem (1))
# ------------------------------------------------------------------------------

def prox_zero(gamma: float, x: PyTree) -> PyTree:
    return x


def prox_l2(mu_reg: float) -> Callable[[float, PyTree], PyTree]:
    """R = (mu_reg/2)||x||^2  ->  prox = x / (1 + gamma mu_reg), as XLA
    computes it: x times the f32 reciprocal of the constant (on 2**16
    values the division differed from jitted JAX on 3,964, the product on
    none)."""

    def prox(gamma, x):
        r = _f32(np.float32(1.0) / np.float32(1.0 + gamma * mu_reg))
        return T.tree_map(lambda v: v * r, x)

    return prox


def prox_l1(lam_reg: float) -> Callable[[float, PyTree], PyTree]:
    """R = lam_reg ||x||_1  ->  soft threshold."""

    def prox(gamma, x):
        t = _f32(gamma * lam_reg)
        return T.tree_map(
            lambda v: jsign(v) * torch.clamp(v.abs() - t, min=0.0), x)

    return prox


def proximal_step(x: PyTree, g: PyTree, gamma: float,
                  prox: Callable[[float, PyTree], PyTree] = prox_zero
                  ) -> PyTree:
    """x^{t+1} = prox_{gamma R}(x^t - gamma g^{t+1}), the step one fused
    rounding."""
    y = T.tree_map(lambda xv, gv: torch.add(xv, gv, alpha=-gamma), x, g)
    return prox(gamma, y)


# ------------------------------------------------------------------------------
# the reference driver
# ------------------------------------------------------------------------------

class ReferenceRun(NamedTuple):
    """Result of :func:`run_reference`: the final iterate, the final
    :class:`EFBVState`, the downlink's w (None without one), the stacked
    ``record`` values (None when not recording), and under the pipelined
    schedule the last round's aggregate, not yet applied."""

    x: PyTree
    state: EFBVState
    w: Optional[PyTree]
    metrics: Optional[torch.Tensor]
    pending: Optional[PyTree] = None


def run_reference(*, algo: EFBV, grad_fn: Callable, x0: PyTree,
                  gamma: float, steps: int, key, n: int,
                  participation: Optional[Participation] = None,
                  downlink: Optional[Downlink] = None,
                  prox: Callable[[float, PyTree], PyTree] = prox_zero,
                  record: Optional[Callable] = None,
                  wire_dtype: str = "float32",
                  pipeline: Optional[Pipeline] = None) -> ReferenceRun:
    """Algorithm 1 over ``steps`` rounds, the n workers batched on x0's
    device (``vmap`` over the worker axis): JAX's ``run_reference`` round
    for round.

    Round t runs under ``split(key, steps)[t]`` = k: gradients
    ``grad_fn(fold_in(k, RESAMPLE_FOLD), x)`` (at w under a downlink),
    worker i's compressor under ``split(k, n)[i]``, the mask (other than
    full participation) under ``participation_key(k)``, the broadcast under
    ``downlink_key(k)``.  ``pipeline`` depth 1 applies each round's
    aggregate one round late (round 0 applies zeros) and returns the last
    one as ``.pending``."""
    part = participation if participation is not None else Participation()
    depth = 0 if pipeline is None else pipeline.depth
    state = algo.init(x0, n)
    w = downlink.init(x0) if downlink is not None else None
    device = T.leaves(x0)[0].device
    pending = T.tree_map(torch.zeros_like, x0) if depth else None
    x, metrics = x0, []
    for k in random.split(key, steps):
        grads = grad_fn(random.fold_in(k, RESAMPLE_FOLD),
                        w if downlink is not None else x)
        mask = None if part.is_full else part.sample_mask(
            participation_key(k), n, device)
        if depth:
            d_new, h_new = algo.compress_round(k, grads, state, mask)
            g, h_avg_new = algo.master_update(state.h_avg, pending)
            state = EFBVState(h=h_new, h_avg=h_avg_new, step=state.step + 1)
            pending = d_new
        elif mask is None:
            g, state = algo.step(k, grads, state)
        else:
            g, state = algo.step_federated(k, grads, state, mask)
        x = proximal_step(x, g, gamma, prox)
        if downlink is not None:
            w, _ = downlink.broadcast(downlink_key(k), x, w,
                                      wire_dtype=wire_dtype)
        if record is not None:
            metrics.append(torch.as_tensor(record(x)))
    return ReferenceRun(x=x, state=state, w=w,
                        metrics=torch.stack(metrics) if record is not None
                        and metrics else None,
                        pending=pending)
