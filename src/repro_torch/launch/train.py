"""End-to-end training driver of the port (``repro/launch/train.py``).

Examples (one GPU, full-width qwen2-0.5b, two workers): block-top-k up,
dense broadcast down; QSGD both ways; rand-k up (DIANA-style variance
reduction with ``--algo efbv``); the pipelined (one-round-stale)
schedule with block-top-k up and QSGD down; and per-leaf codecs (QSGD on
the embedding, the norm dense, block-top-k elsewhere):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --workers 2 --steps 3 --global-batch 8 --seq 128 \
        --compressor block_topk:256,16 --algo efbv --agg sparse_allgather
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --workers 2 --steps 3 --global-batch 8 --seq 128 \
        --compressor qsgd:16 --algo efbv --agg sparse_allgather \
        --downlink qsgd:16
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --workers 2 --steps 3 --global-batch 8 --seq 128 \
        --compressor randk:1048576 --algo efbv --agg sparse_allgather
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --workers 2 --steps 3 --global-batch 8 --seq 128 \
        --compressor block_topk:256,16 --algo efbv --agg sparse_allgather \
        --downlink qsgd:16 --pipeline depth:1
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --workers 2 --steps 3 --global-batch 8 --seq 128 \
        --compressor block_topk:256,16 --agg sparse_allgather \
        --leaf-codecs '*embed*=qsgd:16;*norm*=identity'

The archs are all of the JAX registry's: dense (qwen2-0.5b, minitron-8b,
phi3-medium-14b, minicpm-2b), moe (granite-moe-3b-a800m, dbrx-132b), ssm
(mamba2-130m), hybrid (zamba2-7b), encdec (whisper-medium: each step's
batch carries ``frames``) and vlm (qwen2-vl-2b: ``vision_embeds`` before
the text), the last two drawn as the JAX driver draws them
(:func:`family_batch_extras`); e.g. the mamba2 smoke config on the CPU with a
checkpoint every step (JAX's npz format, ``{"params": ...}`` with the
spec; ``repro_torch.tree.restore_checkpoint`` reads it back):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --smoke --device cpu --steps 2 --global-batch 8 --seq 64 \
        --compressor block_topk:256,16 --agg sparse_allgather \
        --ckpt-dir build/ckpt --ckpt-every 1

``--schedule auto`` is WSD for minicpm (the header then says
``schedule=wsd``) and cosine otherwise, as in the JAX driver; a moe
arch's step lines carry its ``aux_loss``.

Every zoo compressor trains up (``--compressor``) and down
(``--downlink``), on an f32, bf16 or f16 wire (``--wire-dtype``); a
heterogeneous fleet (``--worker-comps 'topk:64;randk:64'``, round-robin
over the workers) runs under ``--agg dense_psum``.

The n workers run in one process on one device (``train/trainer.py``),
or one process per worker group under ``torchrun`` (two ranks on the CPU
with gloo, as the tests run it):

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --smoke --device cpu \
        --dist-backend gloo --workers 2 --steps 3 --global-batch 8 \
        --seq 32 --compressor block_topk:256,16 --agg sparse_allgather

Each rank joins the process group from ``torchrun``'s environment (or
``--dist-init``, e.g. a ``file://`` store) with the backend that
``--dist-backend`` names, which must be given when ``WORLD_SIZE`` > 1;
rank r runs its n/P workers on ``cuda:LOCAL_RANK`` when there are as many
cards as local ranks, else every rank on ``cuda:0``, which nccl refuses
(``rank_device``).  Rank 0 prints.  ``--workers n`` takes the place of
the JAX driver's ``--mesh nx1``.  Step s runs under the key
``fold_in(key(seed), s)``, as in the JAX driver.  It runs on ``cuda``
unless ``--device cpu`` is given.

As in the JAX driver, the algorithmic flags fold into one
:class:`repro_torch.core.ExperimentSpec` (:func:`spec_from_args`) and the
run -- EF-BV tuning (for the sampled regime under ``--participation``),
downlink, participation, pipeline, trainer -- comes from
``repro_torch.core.build(spec)``; ``--spec path.json`` loads a serialized
spec instead (its algorithmic fields, steps and seed replace the flags;
``--smoke`` and ``--pipeline`` fold into it), and the driver prints the
spec's fingerprint, the JAX driver's for the same experiment:

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --spec examples/specs/pipelined_blocktopk.json --global-batch 8 \
        --seq 32

(that file's 2x2 mesh needs four ranks, below).  ``--mesh WxM`` (or a
spec's ``mesh``) with a ``model`` axis M > 1 runs W workers with M-way
tensor parallelism under ``torchrun``: WORLD_SIZE must be a multiple W'
x M of M with W' dividing W; global rank r is worker-group rank r // M
and model rank r % M, and each rank holds its shards of one worker's
params (``Model.param_specs``).  The SMOKE step of the JAX package on four
gloo ranks on the CPU:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --smoke --device cpu \
        --dist-backend gloo --mesh 2x2 --steps 4 --global-batch 8 \
        --seq 32 --compressor block_topk:256,16 --agg sparse_allgather \
        --downlink qsgd:16

The wire bits are those of the logical gradient, unchanged from ``2x1``.
A model axis whose heads do not split whole is refused
(``Model.model_axis_refusal``).  Flags and spec contents of the JAX driver
that this port does not have yet are refused with a "not yet ported"
error, never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import time

import numpy as np
import torch

from repro_torch import random, resolve_device
from repro_torch import tree as T
from repro_torch.configs import (ARCHS, get_config, get_smoke_config,
                                 known_archs)
from repro_torch.core import (ExperimentSpec, SpecError, build,
                              mesh_worker_count)
from repro_torch.core.efbv import Downlink, Participation, Pipeline
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.distributed import wire
from repro_torch.distributed.aggregate import (BACKENDS, ModelShards,
                                               Pending, WorkerGroup)
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine, wsd

# JAX-driver flags not yet ported, with the value that asks for nothing
# beyond the port (any other value is refused)
NOT_PORTED_FLAGS = {"--trainer": "shard_map", "--sanitize": False}
#: the compressor families the trainer runs, up, down and per leaf: every
#: name of the spec grammar
TRAIN_COMPRESSORS = ("identity", "none", "topk", "randk", "scaled_randk",
                     "comp", "mix", "block_topk", "sign", "natural", "qsgd",
                     "frac_topk", "frac_comp")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", default="",
                    help="path to an ExperimentSpec JSON: the declarative "
                         "form of the algorithmic flags (which it replaces, "
                         "with --steps and --seed); see examples/specs/")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--workers", type=int, default=2,
                    help="EF-BV workers, run one after another on the device "
                         "(over torchrun's ranks: n/P on each)")
    ap.add_argument("--mesh", default="",
                    help="WxM or PxWxM (the JAX driver's --mesh): the "
                         "worker axes' product is the worker count and M the "
                         "'model' axis, tensor parallelism over M ranks a "
                         "worker group ('' = --workers n, mesh nx1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default="", choices=("",) + BACKENDS,
                    help="process-group backend; required when WORLD_SIZE "
                         "> 1 (nothing switches it)")
    ap.add_argument("--dist-init", default="",
                    help="init_method of the process group (default env://, "
                         "torchrun's MASTER_ADDR/MASTER_PORT)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="auto",
                    choices=["auto", "cosine", "wsd"],
                    help="auto = wsd for minicpm (its training recipe), "
                         "cosine otherwise")
    ap.add_argument("--algo", default="efbv",
                    choices=["efbv", "ef21", "diana", "none"])
    ap.add_argument("--compressor", default="block_topk:256,16",
                    help="uplink compressor: name[:a[,b]] with a name of "
                         + ", ".join(TRAIN_COMPRESSORS))
    ap.add_argument("--agg", default="dense_psum",
                    choices=["dense_psum", "sparse_allgather"])
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "bfloat16", "float16"],
                    help="value precision of sparse/dense wire payloads "
                         "(quantized and bit-packed codecs ignore it)")
    ap.add_argument("--downlink", default="",
                    help="compress the master -> worker broadcast with any "
                         "zoo compressor spec, optionally '@lam' (e.g. "
                         "'qsgd:16', 'block_topk:256,16'; '' = dense "
                         "broadcast)")
    ap.add_argument("--worker-comps", default="",
                    help="heterogeneous fleet: ';'-separated compressor "
                         "specs assigned round-robin to the n workers (or "
                         "an explicit length-n list), e.g. "
                         "'topk:64;randk:64'.  Overrides --compressor; "
                         "mixed fleets need --agg dense_psum")
    ap.add_argument("--leaf-codecs", default="",
                    help="per-leaf wire codecs: ';'-separated "
                         "'pattern=comp_spec' rules matched against "
                         "'/'-joined parameter paths (fnmatch; first match "
                         "wins; unmatched leaves use --compressor), e.g. "
                         "'*embed*=qsgd:16;*norm*=identity'.  With --spec, "
                         "a non-default value overrides the spec's "
                         "leaf_codecs field")
    ap.add_argument("--participation", default="full",
                    help="full | bernoulli:p | fixed:s (federated mode: "
                         "absent workers send a decode-zero message and "
                         "keep h_i stale)")
    ap.add_argument("--pipeline", default="off",
                    help="'off' | 'depth:0' | 'depth:1' (the master applies "
                         "the previous round's messages)")
    ap.add_argument("--local-batch-resample", action="store_true")
    ap.add_argument("--shard-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--heterogeneity", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default="",
                    help="save {'params': ...} with the spec as npz "
                         "checkpoints here (JAX's format), every "
                         "--ckpt-every steps and at the end")
    ap.add_argument("--ckpt-every", type=int, default=0)
    for flag, neutral in NOT_PORTED_FLAGS.items():
        if isinstance(neutral, bool):
            ap.add_argument(flag, action="store_true", help="not yet ported")
        else:
            ap.add_argument(flag, type=type(neutral), default=neutral,
                            help="not yet ported")
    args = ap.parse_args(argv)
    for flag, neutral in NOT_PORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) != neutral:
            ap.error(f"{flag} is not yet ported to repro_torch")
    try:
        Downlink.parse(args.downlink)
    except ValueError as e:
        ap.error(f"--downlink: {e}")
    try:
        Pipeline.parse(args.pipeline)
    except ValueError as e:
        ap.error(f"--pipeline: {e}")
    try:
        Participation.parse(args.participation)
    except ValueError as e:
        ap.error(f"--participation: {e}")
    if world_size() > 1 and not args.dist_backend:
        ap.error(f"WORLD_SIZE={world_size()}: --dist-backend "
                 f"{{{','.join(BACKENDS)}}} must be given")
    if args.mesh:
        try:
            [int(x) for x in args.mesh.split("x")]
        except ValueError:
            ap.error(f"--mesh {args.mesh!r} is not an 'AxB' integer shape")
    return args


def workers_of(args) -> int:
    """The run's worker count: the worker axes of ``--mesh``, else
    ``--workers``."""
    if args.mesh:
        return mesh_worker_count([int(x) for x in args.mesh.split("x")])
    return args.workers


def model_axis(spec: ExperimentSpec) -> int:
    """The size of the spec's ``model`` axis (1 for a 1-d mesh)."""
    dims = spec.mesh_dims()
    return dims[-1] if len(dims) > 1 else 1


def world_size() -> int:
    """P, from ``torchrun``'s environment (1 when it sets none)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device: str, backend: str, local_rank: int,
                local_world: int, cards: int) -> torch.device:
    """The device of one rank: the CPU when asked; else ``cuda:LOCAL_RANK``
    when the host has a card per local rank, and ``cuda:0`` for every rank
    when it has fewer.  Ranks that share a card need gloo: nccl refuses two
    ranks on one GPU, so this raises rather than run another backend."""
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError(f"--dist-backend nccl needs CUDA devices, not "
                             f"{dev}")
        return dev
    if cards >= local_world:
        return torch.device("cuda", local_rank)
    if backend == "nccl" and local_world > 1:
        raise ValueError(
            f"--dist-backend nccl: {local_world} ranks would share cuda:0 "
            f"({cards} card(s)), and nccl refuses two ranks on one GPU; run "
            "one rank per card, or --dist-backend gloo")
    return torch.device("cuda", 0)


def join_group(args, n: int, model_size: int = 1):
    """This rank's WorkerGroup of the run's n workers under ``torchrun``,
    with a ``model`` axis of ``model_size`` ranks (None in one process)."""
    if world_size() <= 1:
        return None
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    dev = rank_device(args.device, args.dist_backend,
                      int(os.environ.get("LOCAL_RANK", "0")), local_world,
                      torch.cuda.device_count())
    return WorkerGroup.join(n, backend=args.dist_backend,
                            device=resolve_device(dev),
                            init_method=args.dist_init or None,
                            model_size=model_size)


def mesh_refusal(spec: ExperimentSpec, world: int) -> str:
    """Why ``world`` ranks cannot run the spec's mesh ('' when they can):
    with a ``model`` axis M > 1 the ranks must be W' x M, W' dividing the
    n workers."""
    m = model_axis(spec)
    if m == 1:
        return ""
    if world % m or spec.n % (world // m):
        return (f"mesh {spec.mesh!r} has a 'model' axis of {m}: it runs on "
                f"W' x {m} ranks with W' dividing its {spec.n} workers (e.g."
                f" torchrun --nproc-per-node {spec.n * m}), not on "
                f"WORLD_SIZE={world}")
    return ""


def tuning_dim(cfg) -> int:
    """The tuning dimension of an arch: its dominant layer size (the JAX
    driver's rule, so both drivers tune the same (lam, nu))."""
    return max(cfg.d_model * max(cfg.d_ff, 1), 1)


def spec_from_args(args, n: int) -> ExperimentSpec:
    """The driver's flags folded into the declarative spec, as the JAX
    driver folds them (``--workers n`` is its ``--mesh nx1``; ``--mesh``
    itself is the spec's mesh, n its worker count); the runtime
    knobs -- batch, seq, lr, schedule, logging, device -- stay flags.  The
    tuning dimension is the dominant layer size of the config the run uses
    (smoke or full), so the spec reproduces the same (lam, nu)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return ExperimentSpec(
        compressor=args.worker_comps or args.compressor, mode=args.algo,
        agg=args.agg,
        wire_dtype=args.wire_dtype, downlink=args.downlink,
        participation=args.participation,
        resample=args.local_batch_resample, backend="shard_map",
        problem=args.arch, smoke=args.smoke, mesh=args.mesh or f"{n}x1",
        n=n,
        d=tuning_dim(cfg), steps=args.steps, seed=args.seed,
        pipeline=args.pipeline, leaf_codecs=args.leaf_codecs)


def _unported_spec(spec: ExperimentSpec) -> str:
    """What of a valid spec the port's trainer does not have yet ('' when
    nothing), naming the ROADMAP item that ports it."""
    if spec.backend == "fsdp":
        return ("backend 'fsdp' is not yet ported to repro_torch (ROADMAP "
                "queue 1, item 8)")
    refusal = build_model(run_config(spec)).model_axis_refusal(
        model_axis(spec))
    if refusal:
        return f"mesh {spec.mesh!r}: {refusal}"
    return ""


def experiment(args) -> ExperimentSpec:
    """The run's spec: loaded from ``--spec`` with ``--smoke`` and a
    non-default ``--pipeline`` and ``--leaf-codecs`` folded in (all part of
    the experiment's identity), as the JAX driver's ``main`` does, or
    folded from the flags.
    Exits with the JAX driver's message on a bad spec and with "not yet
    ported" on what the port's trainer does not have."""
    try:
        if args.spec:
            with open(args.spec) as f:
                spec = ExperimentSpec.from_json(f.read())
            if args.smoke and not spec.smoke:
                spec = dataclasses.replace(
                    spec, smoke=True,
                    d=tuning_dim(get_smoke_config(spec.problem))
                    if spec.problem in ARCHS else spec.d)
            if args.pipeline != "off" and spec.pipeline != args.pipeline:
                spec = dataclasses.replace(spec, pipeline=args.pipeline)
            if args.leaf_codecs and spec.leaf_codecs != args.leaf_codecs:
                spec = dataclasses.replace(spec, leaf_codecs=args.leaf_codecs)
            if spec.backend == "reference":
                raise SpecError(
                    "the train driver runs the distributed trainers; a "
                    "backend='reference' spec runs via "
                    "repro_torch.core.build(spec).reference()")
            if spec.problem not in known_archs():
                raise SpecError(
                    f"this driver trains model archs "
                    f"{sorted(known_archs())}; problem={spec.problem!r} "
                    "specs supply their own loss via "
                    "repro_torch.core.build(spec).train_step(...)")
        else:
            spec = spec_from_args(args, workers_of(args))
    except (SpecError, ValueError, OSError) as e:
        raise SystemExit(f"[train] bad experiment spec: {e}")
    unported = _unported_spec(spec) or mesh_refusal(spec, world_size())
    if not unported and args.ckpt_dir and model_axis(spec) > 1:
        # each rank holds shards: a checkpoint of them is not JAX's format
        unported = (f"mesh {spec.mesh!r}: --ckpt-dir on a 'model' axis is "
                    "not yet ported to repro_torch")
    if unported:
        raise SystemExit(f"[train] {unported}")
    return spec


def schedule_kind(flag: str, arch: str) -> str:
    """The run's schedule: ``--schedule``, where ``auto`` is WSD for minicpm
    (its training recipe) and cosine otherwise, as in the JAX driver."""
    if flag == "auto":
        return "wsd" if arch.startswith("minicpm") else "cosine"
    return flag


def make_schedule(kind: str, lr: float, steps: int):
    """The JAX driver's schedules: linear warmup over 5% of the steps, then
    cosine, or WSD with 70% stable and 25% decay."""
    if kind == "wsd":
        return wsd(lr, warmup_steps=max(steps // 20, 1),
                   stable_steps=int(steps * 0.7),
                   decay_steps=max(int(steps * 0.25), 1))
    return cosine(lr, total_steps=steps, warmup_steps=max(steps // 20, 1))


def family_batch_extras(cfg, global_batch: int, step: int) -> dict:
    """The per-family batch inputs beyond tokens and labels, as JAX's
    driver draws them (``repro/train/loop.py::family_batch_extras``): the
    vlm's stub vision-tower output ``vision_embeds`` (B, vision_patches, d)
    or the encdec's stub audio frames ``frames`` (B, encoder_frames, d),
    f32 standard normals from ``np.random.default_rng(step)``, so both
    packages see the same bits; {} for the other families."""
    shape = {"vlm": ("vision_embeds", cfg.vision_patches),
             "encdec": ("frames", cfg.encoder_frames)}.get(cfg.family)
    if shape is None:
        return {}
    name, rows = shape
    return {name: np.random.default_rng(step).standard_normal(
        (global_batch, rows, cfg.d_model), dtype=np.float32)}


def step_batch(data, cfg, global_batch: int, step: int) -> dict:
    """Step ``step``'s batch: ``data.batch(step)`` and the family's extras
    (:func:`family_batch_extras`)."""
    batch = data.batch(step)
    batch.update(family_batch_extras(cfg, global_batch, step))
    return batch


def _quiet(*args, **kwargs):
    """Ranks other than 0 print nothing."""


def run_config(spec: ExperimentSpec):
    """The model config a spec names (its smoke variant under ``smoke``)."""
    return (get_smoke_config(spec.problem) if spec.smoke
            else get_config(spec.problem))


def setup(args, group=None, spec: ExperimentSpec = None):
    """Model, schedule, params, state, data and step function of the run's
    spec (:func:`experiment` of the flags unless ``spec`` is given), its
    algorithm from ``build(spec)``; prints the run header, the spec's
    fingerprint and the wire accounting (rank 0 of a ``group``).  Returns
    (state, step_fn, data); step s takes the key
    ``random.fold_in(random.key(spec.seed), s)``."""
    echo = print if group is None or group.global_rank == 0 else _quiet
    spec = experiment(args) if spec is None else spec
    run_ = build(spec)
    dev = group.device if group is not None else resolve_device(args.device)
    cfg = run_config(spec)
    model = build_model(cfg)
    n = spec.n
    tp = None if group is None else group.model
    if (tp.size if tp is not None else 1) != model_axis(spec):
        raise SystemExit(f"[train] mesh {spec.mesh!r}: the group's model "
                         f"axis is {1 if tp is None else tp.size}")
    algo, downlink = run_.algo, run_.downlink
    participation, pipeline = run_.participation, run_.pipeline
    federated = run_.federated

    sched_kind = schedule_kind(args.schedule, spec.problem)
    sched = make_schedule(sched_kind, args.lr, spec.steps)
    opt = adamw(sched, weight_decay=0.01)

    echo(f"[train] arch={cfg.name} family={cfg.family} "
         f"params~{cfg.param_count():,} workers={n} algo={spec.mode} "
         f"lam={algo.lam:.4g} nu={algo.nu:.4g} agg={spec.agg}"
         + (f" participation={spec.participation}" if federated else "")
         + (f" pipeline={spec.pipeline}" if not pipeline.is_off else "")
         + (f" downlink={spec.downlink}" if downlink else "")
         + (f" fleet={spec.compressor}" if algo.fleet is not None else "")
         + (f" leaf_codecs={spec.leaf_codecs}" if spec.leaf_codecs else "")
         + (f" mesh={spec.mesh}" if tp is not None else "")
         + (f" schedule={sched_kind}" if args.schedule == "auto"
            and sched_kind != "cosine" else "")
         + (f" ranks={group.world * model_axis(spec)} "
            f"backend={group.backend}" if group is not None else "")
         + f" device={dev}")
    echo(f"[train] spec fingerprint={spec.fingerprint()}"
         + (f" (from {args.spec})" if args.spec else ""))

    # JAX's weights, model.init(jax.random.key(seed)); a mesh rank keeps
    # its shards
    params = model.init(random.key(spec.seed), device=dev)
    shards = None
    if tp is not None:
        shards = ModelShards.of(tp, model.param_specs(),
                                model.init_abstract())
        params = shards.shard_tree(params)
    # the wire carries the logical gradient: bits as in one process
    logical = params if shards is None else shards.logical
    up_fmt = wire.tree_format_for(algo.compressor, logical,
                                  wire_dtype=spec.wire_dtype,
                                  rules=algo.leaf_rules) \
        if spec.agg == "sparse_allgather" else None
    exp_s = participation.fraction(n) * n if federated else None
    if up_fmt is not None:
        # exact wire accounting for the codec payload
        up, dense = up_fmt.bits_per_round(), up_fmt.dense_bits()
        kinds = sorted({l.kind for l in up_fmt.leaves})
        echo(f"[train] wire: codec={','.join(kinds)} {up} bits/round/worker "
             f"uplink ({up / 8 / 2**20:.2f} MiB, "
             f"{up / max(dense, 1):.4f}x dense fp32)")
        if federated:
            fed = up_fmt.bits_per_round(n_workers=n, participants=exp_s)
            full = up_fmt.bits_per_round(n_workers=n)
            echo(f"[train] wire: federated round (mask bitmap + "
                 f"E|S_t|={exp_s:g} of {n} payloads) "
                 f"~{fed / 8 / 2**20:.2f} MiB total "
                 f"({fed / max(full, 1):.3f}x the full-participation round)")
    elif algo.fleet is not None:
        fmts = wire.fleet_formats(algo.fleet, logical,
                                  wire_dtype=spec.wire_dtype)
        bits = wire.fleet_bits_per_round(fmts)
        per = sorted({f.bits_per_round() for f in fmts})
        echo(f"[train] wire: mixed fleet of {len(set(algo.fleet))} member "
             f"kinds, per-worker bits in {per}, {bits} bits/round uplink "
             f"(would-be payload; dense_psum carries dense tensors)")
    if downlink is not None:
        # the broadcast payload is real whatever the uplink carries; the
        # total prints as an exact integer (the JAX driver rounds it, :g)
        dfmt = downlink.format_for(logical, wire_dtype=spec.wire_dtype)
        down, dense = dfmt.downlink_bits_per_round(), dfmt.dense_bits()
        total = wire.total_round_bits(up_fmt, dfmt, n_workers=n,
                                      participants=exp_s) \
            if up_fmt is not None else n * dense + down
        dense_total = n * dense + dense
        echo(f"[train] wire: downlink {down} bits/round broadcast "
             f"({down / max(dense, 1):.4f}x dense fp32); total "
             f"{total} bits/round up+down "
             f"({total / max(dense_total, 1):.4f}x dense both ways)")
    state = run_.init_state(params, opt, group=group, shards=shards)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.global_batch, n_workers=n,
                       seed=spec.seed, heterogeneity=args.heterogeneity,
                       resample_from_shard=spec.resample,
                       shard_size=args.shard_size)
    loss_fn = model.loss if tp is None else functools.partial(model.loss,
                                                              tp=tp)
    step_fn = run_.train_step(loss_fn, opt, group=group, shards=shards)
    return state, step_fn, data


def main(argv=None):
    args = parse_args(argv)
    spec = experiment(args)
    group = join_group(args, spec.n, model_axis(spec))
    try:
        return run(args, group, spec)
    finally:
        if group is not None:
            group.close()


def save_params(args, group, spec: ExperimentSpec, step: int,
                state) -> None:
    """``{"params": state.params}`` with the spec, as the JAX driver saves
    it (``tree.save_checkpoint``); over a group rank 0 writes (every rank
    holds the same params)."""
    if group is None or group.global_rank == 0:
        T.save_checkpoint(args.ckpt_dir, step, {"params": state.params},
                          spec=spec)


def run(args, group=None, spec: ExperimentSpec = None):
    """``main`` on a joined group (or None): :func:`setup`, then
    :func:`train_loop`; returns the final loss."""
    spec = experiment(args) if spec is None else spec
    return train_loop(args, group, spec, lambda: setup(args, group, spec))


def train_loop(args, group, spec: ExperimentSpec, make) -> float:
    """The spec's steps on ``make()``'s (state, step_fn, data), as
    :func:`setup` returns them: the step lines, the checkpoints and, over
    a group, its exchange summary (rank 0 prints); returns the final loss.
    Only the loop holds the state, so each step's input state is freed
    once the next is made."""
    echo = print if group is None or group.global_rank == 0 else _quiet
    state, step_fn, data = make()
    n = spec.n
    key = random.key(spec.seed)
    t_start = time.time()
    cfg = run_config(spec)
    moe = cfg.family == "moe"
    for step in range(spec.steps):
        state, metrics = step_fn(state, step_batch(data, cfg,
                                                   args.global_batch, step),
                                 random.fold_in(key, step))
        if step % args.log_every == 0 or step == spec.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            part = f"|S|={int(m['participants'])}/{n} " \
                if "participants" in m else ""
            aux = f"aux_loss={m['aux_loss']:.4f} " if moe else ""
            echo(f"[train] step {step:5d} loss={m['loss']:.4f} "
                 f"|g|={m['g_norm']:.3f} |upd|={m['update_norm']:.4f} "
                 f"h_res={m['h_residual']:.3f} {part}{aux}"
                 f"({(time.time() - t_start) / (step + 1):.2f}s/step)")
        if args.ckpt_dir and args.ckpt_every \
                and (step + 1) % args.ckpt_every == 0:
            save_params(args, group, spec, step + 1, state)
            echo(f"[train] checkpoint @ {step + 1}")
    if args.ckpt_dir:
        save_params(args, group, spec, spec.steps, state)
    if group is not None:
        if isinstance(state.inflight, Pending):
            # the last round's exchange, which a next round would apply:
            # drained before the group closes
            state.inflight.wait()
        st = group.stats
        echo(f"[train] exchange: ranks={group.world} "
             f"backend={group.backend} {st['exchanges']} exchanges, "
             f"{st['bytes'] // max(st['exchanges'], 1)} B per rank per "
             f"round, {1e3 * st['exchange_s'] / max(spec.steps, 1):.2f} ms "
             "host time in the collective (wait() when pipelined) per step "
             "on rank 0")
        if group.model is not None:
            ms = group.model.stats
            steps = max(spec.steps, 1)
            echo(f"[train] model axis: {group.model.size} ranks a worker, "
                 f"{ms['model_calls'] // steps} collectives and "
                 f"{ms['model_bytes'] // steps} B sent per rank per step, "
                 f"{1e3 * ms['model_s'] / steps:.2f} ms host time in them "
                 "per step on rank 0")
    echo(f"[train] done: final loss {float(metrics['loss']):.4f}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
