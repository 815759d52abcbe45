"""Compressors, EF-BV and its tuning theory, and the experiment spec (port
of ``repro.core``).

The spec (``repro/core/spec.py``) lives here: one frozen
:class:`ExperimentSpec` declares a whole experiment -- uplink compressor or
fleet, wire, downlink, participation, (lam, nu) parametrization, problem,
backend, steps, seed, stepsize -- with lossless JSON, CLI-style parsing
and a stable :meth:`ExperimentSpec.fingerprint`, byte for byte those of the
JAX package, so one spec file drives both packages.  :func:`build` turns it
into a :class:`Run`: ``.reference()`` (Algorithm 1 on the built-in convex
problems, :func:`repro_torch.core.efbv.run_reference`), ``.train_step()``
and ``.init_state()`` over the port's trainer, ``.round_bits()`` (the exact
wire accounting) and ``.tuned`` (Remark 1's auto-tuning).

``Run.make_mesh`` gives the spec's mesh geometry
(``distributed.aggregate.make_mesh``; its ``model`` axis runs as tensor
parallelism over a group's model sub-group, ``train_step(group=...,
shards=...)``), and ``Run.state_shardings`` each state leaf's spec.  The
trainer and the layout follow ``spec.backend``: ``shard_map``
(``train.trainer.make_train_step``) or ``fsdp``
(``make_train_step_fsdp``, the master state sharded over the worker
group, on a ``model`` axis too, ``shards=make_fsdp_shards(...)``).

``Run.reference()`` and ``problem_instance()`` run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import math
from typing import Any, Callable, Optional, Sequence, Tuple, Union

from repro_torch.core import theory  # noqa: F401
from repro_torch.core.compressors import (  # noqa: F401
    QSGD, BlockTopK, CompKK, Compressor, FracCompKK, FracTopK, Identity,
    MixKK, MNice, Natural, RandK, ScaledRandK, SignNorm, TopK,
    bias_variance_estimate, expand_fleet, format_compressor, format_downlink,
    format_fleet, format_leaf_rules, format_pipeline, make_compressor,
    make_fleet, parse_compressor, parse_downlink, parse_fleet,
    parse_leaf_rules, parse_pipeline, scaled,
)
from repro_torch.core.efbv import (  # noqa: F401
    EFBV, Downlink, EFBVState, Participation, Pipeline, ReferenceRun,
    downlink_key, participation_key, prox_l1, prox_l2, prox_zero,
    proximal_step, run_reference,
)
from repro_torch.core.theory import (  # noqa: F401
    Tuning, tune, tune_for, tune_partial,
)
from repro_torch.data.synthetic import Quadratic  # noqa: F401

SPEC_VERSION = 1

MODES = ("efbv", "ef21", "diana", "none")
AGG_MODES = ("dense_psum", "sparse_allgather")
BACKENDS = ("reference", "shard_map", "fsdp")
WIRE_DTYPES = ("float32", "bfloat16", "float16")
#: problems the reference backend builds itself; anything else is a model
#: arch id (trainer backends only)
REFERENCE_PROBLEMS = ("quadratic", "logreg")

PyTree = Any


class SpecError(ValueError):
    """An ExperimentSpec that does not describe a runnable experiment."""


def _choice(field: str, value: str, allowed: Sequence[str]) -> None:
    if value not in allowed:
        raise SpecError(f"spec.{field} = {value!r} not in {tuple(allowed)}")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Parsed form of ``ExperimentSpec.serve``, the replica-fleet serving
    leg that ``launch.train.run_fleet`` runs (the ``serve`` subcommand).

    replicas, slots (continuous-batching slots per replica), prompt (0 =
    BOS-only), gen, max_len (prompt + gen must fit) and pushes, as
    ','-separated 'key:value' entries."""

    replicas: int = 2
    slots: int = 2
    prompt: int = 4
    gen: int = 8
    max_len: int = 32
    pushes: int = 3

    def __post_init__(self):
        for f in ("replicas", "slots", "gen", "max_len", "pushes"):
            v = getattr(self, f)
            if not isinstance(v, int) or v <= 0:
                raise SpecError(f"serve.{f} must be a positive int, got "
                                f"{v!r}")
        if not isinstance(self.prompt, int) or self.prompt < 0:
            raise SpecError(f"serve.prompt must be an int >= 0, got "
                            f"{self.prompt!r}")
        if self.prompt + self.gen > self.max_len:
            raise SpecError(
                f"serve.prompt + serve.gen = {self.prompt + self.gen} "
                f"overruns the decode cache (serve.max_len = {self.max_len});"
                " shorten the request or raise max_len")

    @classmethod
    def parse(cls, s: str) -> Optional["ServeSpec"]:
        """'' -> None; 'replicas:4,gen:16' -> ServeSpec(replicas=4, gen=16).
        Unknown keys raise with the known field list."""
        if not s:
            return None
        known = {f.name: f.default for f in dataclasses.fields(cls)}
        kw: dict = {}
        for entry in s.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if ":" not in entry:
                raise SpecError(f"serve entry {entry!r} is not 'key:value'")
            key, val = entry.split(":", 1)
            key = key.strip().replace("-", "_")
            if key not in known:
                raise SpecError(f"unknown serve field {key!r}; known: "
                                f"{sorted(known)}")
            if key in kw:
                raise SpecError(f"serve field {key!r} given twice")
            try:
                kw[key] = int(val)
            except ValueError:
                raise SpecError(f"serve.{key} wants an int, got "
                                f"{val!r}") from None
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The full experiment, as data (``repro.core.ExperimentSpec``, field
    for field).  Frozen and hashable; every field is a JSON scalar, so
    ``to_json`` / ``from_json`` round-trip losslessly and
    :meth:`fingerprint` is stable across field ordering.

    compressor (';' for a fleet), mode (efbv | ef21 | diana | none), agg
    (dense_psum | sparse_allgather), wire_dtype, downlink ('' = dense),
    participation (full | bernoulli:p | fixed:s), resample (stochastic
    local gradients), backend (reference | shard_map | fsdp), problem
    (quadratic | logreg, or a model arch), smoke (an arch's reduced
    config; part of the identity), mesh ('2x1', trainers), n workers, d
    (the problem dimension, and the tuning dimension), steps, gamma (0 =
    auto-tune), seed; and three fields added after spec_version 1 that
    serialize only when set: pipeline ('off' | 'depth:1'), leaf_codecs
    and serve."""

    compressor: str = "block_topk:256,16"
    mode: str = "efbv"
    agg: str = "dense_psum"
    wire_dtype: str = "float32"
    downlink: str = ""
    participation: str = "full"
    resample: bool = False
    backend: str = "reference"
    problem: str = "quadratic"
    smoke: bool = False
    mesh: str = ""
    n: int = 8
    d: int = 64
    steps: int = 100
    gamma: float = 0.0
    seed: int = 0
    pipeline: str = "off"
    leaf_codecs: str = ""
    serve: str = ""

    def __post_init__(self):
        from repro_torch.distributed import wire

        _choice("mode", self.mode, MODES)
        _choice("agg", self.agg, AGG_MODES)
        _choice("backend", self.backend, BACKENDS)
        _choice("wire_dtype", self.wire_dtype, WIRE_DTYPES)
        for f in ("n", "d", "steps"):
            if not isinstance(getattr(self, f), int) or getattr(self, f) <= 0:
                raise SpecError(f"spec.{f} must be a positive int, got "
                                f"{getattr(self, f)!r}")
        if self.gamma < 0:
            raise SpecError(f"spec.gamma must be >= 0 (0 = auto-tune), got "
                            f"{self.gamma}")

        members = self.fleet_specs()
        if not members:
            raise SpecError("spec.compressor is empty")
        for m in members:  # raises ValueError with the registry's message
            make_compressor(m)
        if len(members) > self.n:
            raise SpecError(f"fleet of {len(members)} members for only "
                            f"{self.n} workers")
        if len(set(members)) > 1 and self.agg == "sparse_allgather":
            raise SpecError(
                "heterogeneous fleet + sparse wire: mixed payload shapes "
                "cannot stack over the all-gather; set agg='dense_psum' "
                f"or use a uniform compressor (got {self.compressor!r})")

        if self.smoke and self.problem in REFERENCE_PROBLEMS:
            raise SpecError("spec.smoke selects a model arch's reduced "
                            "config; the built-in problems "
                            f"{REFERENCE_PROBLEMS} are sized by spec.d/n")

        if self.leaf_codecs:
            if len(set(members)) > 1:
                raise SpecError(
                    "spec.leaf_codecs assigns compressors per LEAF of one "
                    "uplink compressor; a heterogeneous fleet assigns them "
                    "per WORKER -- use one or the other (got compressor="
                    f"{self.compressor!r})")
            if self.mode == "none":
                raise SpecError("spec.leaf_codecs configures the compression "
                                "layer's wire; mode='none' has no "
                                "compression layer")
            wire.parse_leaf_rules(self.leaf_codecs)  # raises on a bad rule

        if self.serve:
            ServeSpec.parse(self.serve)  # raises on a bad serve string
            if self.problem in REFERENCE_PROBLEMS:
                raise SpecError(
                    "spec.serve sizes the model-serving fleet; the built-in "
                    f"problems {REFERENCE_PROBLEMS} have no decode loop -- "
                    "set problem to a model arch")

        part = Participation.parse(self.participation)
        if part.kind == "fixed" and part.s > self.n:
            raise SpecError(f"participation 'fixed:{part.s}' needs at least "
                            f"that many workers, spec.n = {self.n}")
        Downlink.parse(self.downlink)  # raises on a bad compressor spec
        pipe = Pipeline.parse(self.pipeline)  # raises on a bad depth spec

        if self.backend == "reference":
            if pipe.depth:
                raise SpecError(
                    "the pipelined schedule double-buffers the trainer's "
                    "wire payload; the reference backend runs the exact "
                    "sequential recursion (set pipeline='off', or "
                    "backend='shard_map' / 'fsdp')")
            if self.problem not in REFERENCE_PROBLEMS:
                raise SpecError(
                    f"the reference backend runs the built-in problems "
                    f"{REFERENCE_PROBLEMS}, got {self.problem!r}; model "
                    "archs need backend='shard_map' or 'fsdp'")
            if self.mesh:
                raise SpecError("spec.mesh is a trainer-backend field; the "
                                "reference backend takes n directly (set "
                                "mesh='')")
            if self.resample and self.problem == "quadratic":
                raise SpecError("the quadratic problem has exact gradients "
                                "only; resample=True needs problem='logreg' "
                                "or a trainer backend")
        else:
            if not self.mesh:
                raise SpecError(f"backend {self.backend!r} needs a device "
                                "mesh, e.g. mesh='2x2'")
            workers = self.mesh_workers()
            if workers != self.n:
                raise SpecError(
                    f"spec.n = {self.n} but mesh {self.mesh!r} has {workers} "
                    "workers (product of the non-'model' axes)")
            if self.problem not in REFERENCE_PROBLEMS:
                from repro_torch.configs import known_archs
                archs = known_archs()
                if self.problem not in archs:
                    raise SpecError(
                        f"unknown problem {self.problem!r}: want one of "
                        f"{REFERENCE_PROBLEMS} or a model arch in "
                        f"{sorted(archs)}")

    # ---- derived views -----------------------------------------------------

    def fleet_specs(self) -> Tuple[str, ...]:
        """The ';'-separated compressor members (length 1 = homogeneous)."""
        return tuple(s.strip() for s in self.compressor.split(";")
                     if s.strip())

    def serve_spec(self) -> Optional[ServeSpec]:
        """The parsed serving leg (None when ``serve`` is unset)."""
        return ServeSpec.parse(self.serve)

    def mesh_dims(self) -> Tuple[int, ...]:
        try:
            return tuple(int(x) for x in self.mesh.split("x"))
        except ValueError:
            raise SpecError(f"spec.mesh {self.mesh!r} is not an 'AxBxC' "
                            "integer shape") from None

    def mesh_workers(self) -> int:
        """Worker count of the mesh: product of the non-'model' axes."""
        return mesh_worker_count(self.mesh_dims())

    # ---- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        d = {"spec_version": SPEC_VERSION, **dataclasses.asdict(self)}
        # fields added after spec_version 1 serialize only when set, so
        # every earlier spec file and fingerprint stays byte-stable
        if self.pipeline == "off":
            del d["pipeline"]
        if self.leaf_codecs == "":
            del d["leaf_codecs"]
        if self.serve == "":
            del d["serve"]
        return d

    def to_json(self, indent: Optional[int] = 1) -> str:
        """Lossless JSON form (``from_json(to_json(s)) == s``)."""
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        version = d.pop("spec_version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise SpecError(f"spec_version {version!r} != {SPEC_VERSION} "
                            "(this build cannot read that spec)")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise SpecError(f"unknown spec fields {unknown}; known: "
                            f"{sorted(known)}")
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def fingerprint(self) -> str:
        """Stable 16-hex-digit sha256 of the canonical sorted-key JSON,
        defaults included: two specs are equal iff their fingerprints
        are."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    @classmethod
    def parse(cls, argv: Union[str, Sequence[str]]) -> "ExperimentSpec":
        """A spec from CLI-style strings: '--key value', '--key=value' or
        'key=value' ('-' and '_' interchangeable in keys); a boolean field
        also takes the bare '--resample' form."""
        toks = argv.split() if isinstance(argv, str) else list(argv)
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}
        kw: dict = {}
        i = 0
        while i < len(toks):
            tok = toks[i]
            key = tok[2:] if tok.startswith("--") else tok
            if "=" in key:
                key, val = key.split("=", 1)
                i += 1
            else:
                if not tok.startswith("--"):
                    raise SpecError(f"cannot parse token {tok!r}: want "
                                    "'--key value' or 'key=value'")
                nxt = toks[i + 1] if i + 1 < len(toks) else None
                if isinstance(defaults.get(key.replace("-", "_")), bool) and (
                        nxt is None or nxt.startswith("--") or "=" in nxt):
                    val = "true"
                    i += 1
                else:
                    if nxt is None:
                        raise SpecError(f"flag {tok!r} is missing a value")
                    val = nxt
                    i += 2
            key = key.replace("-", "_")
            if key not in defaults:
                raise SpecError(f"unknown spec field {key!r}; known: "
                                f"{sorted(defaults)}")
            kw[key] = _coerce(key, val, defaults[key])
        return cls(**kw)


def mesh_worker_count(dims: Sequence[int]) -> int:
    """The EF-BV worker count of a mesh shape: the product of the
    non-'model' axes, axes being the trailing names of ('pod', 'data',
    'model')."""
    dims = tuple(dims)
    axes = ("pod", "data", "model")[-len(dims):]
    return int(math.prod(s for s, a in zip(dims, axes) if a != "model"))


def _coerce(key: str, val: str, default: Any) -> Any:
    if isinstance(default, bool):
        low = str(val).lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise SpecError(f"spec.{key} wants a boolean, got {val!r}")
    try:
        if isinstance(default, int):
            return int(val)
        if isinstance(default, float):
            return float(val)
    except ValueError:
        raise SpecError(f"spec.{key} wants {type(default).__name__}, got "
                        f"{val!r}") from None
    return val


class Run:
    """A built experiment (construct via :func:`build`): the spec's
    ``algo``, ``participation``, ``downlink`` and ``pipeline``; the
    reference driver (:meth:`reference`); the trainer (:meth:`train_step`,
    :meth:`init_state`); the exact wire accounting (:meth:`round_bits`);
    and the auto-tuning (:attr:`tuned`).  ``algo`` is tuned for the
    sampled regime under partial participation, as JAX's ``Run``."""

    def __init__(self, spec: ExperimentSpec):
        from repro_torch.distributed import wire

        self.spec = spec
        self.participation = Participation.parse(spec.participation)
        self.downlink = Downlink.parse(spec.downlink)
        self.pipeline = Pipeline.parse(spec.pipeline)
        members = tuple(make_compressor(s) for s in spec.fleet_specs())
        self.leaf_rules = (wire.parse_leaf_rules(spec.leaf_codecs)
                           if spec.leaf_codecs else None)
        if spec.mode == "none":
            self.algo = EFBV(Identity(), lam=1.0, nu=1.0)
        else:
            comp = members if len(members) > 1 else members[0]
            self.algo = EFBV.make(
                comp, d=spec.d, n=spec.n, mode=spec.mode,
                participation=(self.participation.fraction(spec.n)
                               if self.federated else None),
                pipeline=self.pipeline.depth or None,
                leaf_rules=self.leaf_rules)
        self.compressor = self.algo.compressor

    def __repr__(self):
        return (f"Run(fingerprint={self.spec.fingerprint()}, "
                f"backend={self.spec.backend!r}, "
                f"compressor={self.spec.compressor!r})")

    @property
    def federated(self) -> bool:
        return not self.participation.is_full

    @property
    def n(self) -> int:
        return self.spec.n

    def _tune(self, **kw):
        """The spec's auto-tuning on the compressor objects ``algo`` was
        tuned with (fleet, per-leaf, participation and pipeline
        composition included)."""
        spec = self.spec
        part = (self.participation.fraction(spec.n) if self.federated
                else None)
        if self.algo.leaf_rules:
            comps = [self.compressor] + [c for _, c in self.algo.leaf_rules]
            return theory.tune_tree(
                [c.eta(spec.d) for c in comps],
                [c.omega(spec.d) for c in comps],
                n=spec.n, aggregate="worst", mode=spec.mode,
                participation=part, pipeline=self.pipeline.depth or None,
                **kw)
        return theory.tune_for(
            self.algo.fleet if self.algo.fleet is not None
            else self.compressor,
            spec.d, spec.n, mode=spec.mode, participation=part,
            pipeline=self.pipeline.depth or None, **kw)

    @property
    def tuned(self):
        """Remark 1's tuning for this spec (None for mode='none')."""
        if self.spec.mode == "none":
            return None
        return self._tune()

    # ---- the built-in problems and the reference driver ---------------------

    def problem_instance(self, device="cuda"):
        """The built-in problem (:class:`Quadratic` or :class:`LogReg`),
        seeded from the spec, its data drawn on ``device``."""
        from repro_torch import random, resolve_device
        from repro_torch.data.synthetic import LogReg, Quadratic, \
            make_synthetic

        spec = self.spec
        dev = resolve_device(device)
        if spec.problem == "quadratic":
            return Quadratic.make(spec.n, spec.d, spec.seed, dev)
        if spec.problem == "logreg":
            A, b = make_synthetic(random.key(spec.seed), N=16 * spec.d,
                                  d=spec.d, device=dev)
            return LogReg.split(A, b, n=spec.n, mu_reg=0.1)
        raise SpecError(f"problem {spec.problem!r} is a model arch: build "
                        "its loss via repro_torch.models and use "
                        ".train_step()")

    def reference(self, grad_fn: Optional[Callable] = None,
                  x0: Optional[PyTree] = None, *,
                  gamma: Optional[float] = None,
                  prox: Optional[Callable] = None,
                  record: Optional[Callable] = None,
                  key=None, device="cuda") -> ReferenceRun:
        """The exact reference recursion of this spec
        (:func:`run_reference`).  With no arguments the built-in problem,
        drawn on ``device``, supplies the gradients (minibatch ones when
        ``spec.resample``), x0 = 0 and, when ``spec.gamma == 0``, Remark
        1's stepsize; a custom ``grad_fn`` (``x -> grads`` or ``(key, x) ->
        grads``) needs ``gamma``.  The run key is ``fold_in(key(seed),
        REFERENCE_FOLD)``."""
        import torch

        from repro_torch import random, resolve_device
        from repro_torch.core import efbv

        spec = self.spec
        if grad_fn is not None and gamma is None and spec.gamma == 0.0:
            raise SpecError("a custom grad_fn needs a stepsize: pass "
                            "gamma= (or set spec.gamma > 0)")
        dev = resolve_device(device)
        prob = self.problem_instance(dev) if grad_fn is None else None
        if grad_fn is None:
            if spec.resample:
                batch = max(1, prob.A.shape[1] // 8)

                def gf(k, x):
                    return prob.minibatch_grads(k, x, batch)
            else:
                def gf(_k, x):
                    return prob.grads(x)
        else:
            try:
                takes_key = len(inspect.signature(grad_fn).parameters) >= 2
            except (TypeError, ValueError):
                takes_key = False
            gf = grad_fn if takes_key else (lambda _k, x: grad_fn(x))

        if x0 is None:
            x0 = torch.zeros(spec.d, dtype=torch.float32, device=dev)
        if gamma is None:
            gamma = spec.gamma if spec.gamma > 0.0 else None
        if gamma is None:
            if spec.mode == "none":
                gamma = 1.0 / prob.L()
            else:
                gamma = self._tune(L=prob.L(), Ltilde=prob.L_tilde()).gamma
        if key is None:
            # decorrelated from the problem data's key (key(seed) itself)
            key = random.fold_in(random.key(spec.seed), efbv.REFERENCE_FOLD)
        return run_reference(
            algo=self.algo, grad_fn=gf, x0=x0, gamma=gamma, steps=spec.steps,
            key=key, n=spec.n, participation=self.participation,
            downlink=self.downlink, prox=prox or prox_zero, record=record,
            wire_dtype=spec.wire_dtype)

    # ---- the trainer -------------------------------------------------------

    def _trainer_backend(self):
        spec = self.spec
        if spec.backend == "reference":
            raise SpecError("backend='reference' has no distributed trainer:"
                            " use .reference(), or set backend='shard_map' "
                            "or 'fsdp'")

    def make_mesh(self):
        """The spec's mesh: its geometry (axis names and sizes, the
        ``model`` axis last), ``distributed.aggregate.make_mesh`` of
        ``spec.mesh``.  The port runs one process per mesh rank, so there
        are no devices to place."""
        from repro_torch.distributed.aggregate import make_mesh

        if self.spec.backend == "reference":
            raise SpecError("the reference backend has no device mesh; use "
                            ".reference()")
        return make_mesh(self.spec.mesh_dims())

    def _check_mesh(self, mesh) -> None:
        if mesh is not None and tuple(mesh.devices_shape) != \
                self.spec.mesh_dims():
            raise SpecError(f"mesh {mesh.devices_shape} is not the spec's "
                            f"{self.spec.mesh!r}")

    def train_step(self, loss_fn: Callable, optimizer, mesh=None,
                   **kw) -> Callable:
        """The train step of this spec over the port's trainer of
        ``spec.backend`` (``repro_torch.train.trainer.make_train_step``,
        or ``make_train_step_fsdp`` for fsdp), threading agg, wire_dtype,
        downlink, participation and pipeline from the spec; ``group=`` in
        ``kw`` runs one process per worker group, with ``shards=`` a rank
        of the mesh's ``model`` axis (shard_map) or the rank's fsdp shards
        (``make_fsdp_shards``).  ``mesh``, when given, must be the
        spec's."""
        from repro_torch.train import trainer

        self._trainer_backend()
        self._check_mesh(mesh)
        make = (trainer.make_train_step_fsdp if self.spec.backend == "fsdp"
                else trainer.make_train_step)
        return make(loss_fn, optimizer, self.algo, n_workers=self.n,
                    agg_mode=self.spec.agg, wire_dtype=self.spec.wire_dtype,
                    downlink=self.downlink, participation=self.participation,
                    pipeline=self.pipeline, **kw)

    def init_state(self, params: PyTree, optimizer, mesh=None, **kw):
        """TrainState for this spec (bidirectional iff a downlink is set;
        the priming in-flight payload iff pipelined); under fsdp over a
        group, ``params`` are the rank's shards and ``shards=`` says
        how."""
        from repro_torch.train.trainer import init_train_state

        self._trainer_backend()
        self._check_mesh(mesh)
        return init_train_state(params, optimizer, n_workers=self.n,
                                bidirectional=self.downlink is not None,
                                algo=self.algo, agg_mode=self.spec.agg,
                                wire_dtype=self.spec.wire_dtype,
                                pipeline=self.pipeline, **kw)

    def state_shardings(self, mesh, param_specs: PyTree, state):
        """Each TrainState leaf's spec on ``mesh``, as tuples of axis
        names, by the backend as JAX's ``Run.state_shardings``:
        ``train.trainer.train_state_shardings`` (shard_map) or
        ``fsdp_state_shardings`` (fsdp: params, w, m, v and h_avg
        sharded over the worker axes too)."""
        from repro_torch.train import trainer

        if self.spec.backend == "reference":
            self._trainer_backend()
        self._check_mesh(mesh)
        fn = (trainer.fsdp_state_shardings if self.spec.backend == "fsdp"
              else trainer.train_state_shardings)
        return fn(mesh, param_specs, state)

    # ---- exact wire accounting ---------------------------------------------

    def round_bits(self, tree: Optional[PyTree] = None, *,
                   participants: Optional[float] = None) -> dict:
        """Exact bits one round puts on the wire, both directions, for a
        gradient tree shaped like ``tree`` (default: the spec's flat (d,)
        vector): ``{'up', 'down', 'total', 'dense_both_ways'}``, n uplink
        payloads (federated: the bitmap and E|S_t| of them) plus one
        broadcast; under per-leaf codec rules the uplink is the
        ``TreeWire``'s (``wire.tree_format_for``)."""
        import torch

        from repro_torch.distributed import wire

        spec = self.spec
        if tree is None:
            tree = torch.zeros(spec.d, dtype=torch.float32, device="meta")
        n = spec.n
        if participants is None and self.federated:
            participants = self.participation.fraction(n) * n
        down_fmt = (None if self.downlink is None else
                    self.downlink.format_for(tree,
                                             wire_dtype=spec.wire_dtype))
        if self.algo.fleet is not None:
            fmts = wire.fleet_formats(self.algo.fleet, tree,
                                      wire_dtype=spec.wire_dtype)
            up = wire.fleet_bits_per_round(fmts)
            if participants is not None:
                # the participation bitmap and each worker's own payload
                # weighted by its inclusion probability E|S_t|/n
                bitmap = 32 * wire.bitmap_words(n)
                per_fleet = sum(f.bits_per_round() for f in fmts)
                if float(participants).is_integer():
                    num = int(participants) * per_fleet
                    up = (bitmap + num // n if num % n == 0
                          else bitmap + num / n)
                else:
                    up = bitmap + participants / n * per_fleet
            dense = fmts[0].dense_bits()
            down = (dense if down_fmt is None
                    else down_fmt.downlink_bits_per_round())
            total = up + down
        else:
            up_fmt = wire.tree_format_for(self.compressor, tree,
                                          wire_dtype=spec.wire_dtype,
                                          rules=self.algo.leaf_rules)
            up = up_fmt.bits_per_round(n_workers=n, participants=participants)
            total = wire.total_round_bits(up_fmt, down_fmt, n_workers=n,
                                          participants=participants)
            down = total - up
            dense = up_fmt.dense_bits()
        return {"up": up, "down": down, "total": total,
                "dense_both_ways": n * dense + dense}


def build(spec: ExperimentSpec) -> Run:
    """Spec (or its dict form) -> executable :class:`Run`."""
    if isinstance(spec, dict):
        spec = ExperimentSpec.from_dict(spec)
    if not isinstance(spec, ExperimentSpec):
        raise SpecError(f"build() wants an ExperimentSpec (or its dict "
                        f"form), got {type(spec).__name__}")
    return Run(spec)
