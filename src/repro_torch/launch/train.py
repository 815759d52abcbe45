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
Every family runs on a model axis, heads whole or not (``models/model.py``
says how); one that does not split a sharded dim (M = 3) is refused
(``Model.model_axis_refusal``).  qwen2 with half a KV head a rank, and
mamba2 with its SSD block gathered on use:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --smoke --device cpu \
        --dist-backend gloo --mesh 1x4 --steps 2 --global-batch 8 \
        --seq 32 --compressor block_topk:256,16 --agg sparse_allgather \
        --downlink qsgd:16
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch mamba2-130m --smoke \
        --device cpu --dist-backend gloo --mesh 1x2 --steps 2 \
        --global-batch 8 --seq 64 --compressor block_topk:256,16 \
        --agg sparse_allgather

``--trainer fsdp`` (a spec's ``backend: fsdp``) runs the fsdp trainer
(``train.trainer.make_train_step_fsdp``): under ``torchrun`` each rank
keeps only its parts of params, AdamW's m and v, h_avg and w, as JAX's
``fsdp_specs`` lays them out over the workers, gathers w before its
workers run, and a checkpoint gathers the params on every rank before
rank 0 writes them; in one process it is the shard_map step.  On a mesh
with a ``model`` axis the parts are those of the rank's model shards
(``aggregate.FsdpShards``), the workers hold model shards as on the mesh
without fsdp, and the master trees reassemble bit for bit into that
mesh run's:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --smoke --device cpu \
        --dist-backend gloo --workers 2 --steps 3 --global-batch 8 \
        --seq 32 --compressor block_topk:256,16 --agg sparse_allgather \
        --downlink qsgd:16 --trainer fsdp
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --smoke --device cpu \
        --dist-backend gloo --mesh 2x2 --steps 3 --global-batch 8 \
        --seq 32 --compressor block_topk:256,16 --agg sparse_allgather \
        --downlink qsgd:16 --trainer fsdp --ckpt-dir build/ckpt/fsdp22

``--ckpt-dir`` writes JAX's npz of the whole params on any mesh: a mesh
rank's shards, or an fsdp rank's parts, are gathered first.

The ``finetune`` subcommand is JAX's ``launch/finetune.py``: the staged
fine-tuning harness (:class:`FinetuneLoop`, JAX's ``train/loop.py``) of a
spec file, its flags the runtime knobs (:class:`FinetuneSettings`), plus
``--device`` and ``--dist-*``; ``--processes`` is the worker group's size:
a JAX process owning a row of M devices of the mesh is M ranks here, so
``torchrun`` starts ``--processes`` x M ranks (M the spec's ``model``
axis).  The JAX CLI reads the spec's mesh before
JAX starts to force its host device count (``_mesh_from_argv``); the
port sets no such flag, so it has no counterpart:

    PYTHONPATH=src python -m repro_torch.launch.train finetune \
        --spec examples/specs/finetune_moe.json --device cpu --steps 2
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train finetune --device cpu \
        --spec examples/specs/zoo_qwen2_fsdp.json --steps 2 \
        --processes 4 --dist-backend gloo
    # a spec written with "mesh": "2x2", "n": 2: 2 processes x 2 ranks
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train finetune --device cpu \
        --spec build/spec/zoo_qwen2_fsdp_2x2.json --steps 2 \
        --processes 2 --dist-backend gloo

The ``serve`` subcommand is JAX's ``launch/serve.py``: with ``--spec``
the simulated replica fleet of a spec's ``serve`` leg (:func:`run_fleet`:
versioned compressed-delta pushes of the downlink's w, replicas that
hot-swap between decode steps and resync from checkpoints after a gap),
else greedy decode of random prompts on the continuous-batching engine
(:class:`DecodeEngine`):

    PYTHONPATH=src python -m repro_torch.launch.train serve \
        --spec examples/specs/serve_delta.json --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train serve \
        --arch mamba2-130m --smoke --batch 2 --prompt-len 4 --gen 6

``--sanitize`` (``train`` and ``finetune``, JAX's ``make sanitize-smoke``)
checks every step's outputs for NaN, re-running a step that made one op by
op to raise ``FloatingPointError`` at the op, and runs every kernel
wrapper's plain version, index bounds checked, on the card too; the mode
reaches ``torchrun`` ranks and spawned processes through
``REPRO_TORCH_SANITIZE=1``:

    PYTHONPATH=src python -m repro_torch.launch.train finetune \
        --spec examples/specs/finetune_moe.json --device cpu --steps 2 \
        --global-batch 8 --seq 32 --eval-every 2 --sanitize

The ``dryrun`` subcommand is JAX's ``launch/dryrun.py``: one rank's
train step, prefill or decode step of each (arch, shape, mesh) run on the
``meta`` device over a fake process group of the production mesh's 256
or 512 ranks, reporting per-rank memory, flops, bytes and collective
bytes (:func:`dryrun_one`):

    PYTHONPATH=src python -m repro_torch.launch.train dryrun \
        --arch qwen2-0.5b --shape train_4k --mesh single

Every flag of JAX's ``train``, ``finetune`` and ``serve`` drivers is
parsed as JAX parses it.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import kernels, random, resolve_device
from repro_torch import tree as T
from repro_torch.configs import (ARCHS, get_config, get_smoke_config,
                                 known_archs)
from repro_torch.core import (ExperimentSpec, SpecError, build,
                              mesh_worker_count)
from repro_torch.core.efbv import (Downlink, Participation, Pipeline,
                                   downlink_key)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.distributed import wire
from repro_torch.distributed.aggregate import (BACKENDS, ModelShards,
                                               Pending, WorkerGroup,
                                               make_multihost_mesh,
                                               model_size, num_workers)
from repro_torch.models.layers import spec_dim
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine, wsd
from repro_torch.train.trainer import make_fsdp_shards, sanitized_step

#: what ``--sanitize`` switches on, printed as JAX's drivers print theirs
SANITIZE_LINE = ("sanitize mode: NaN check of every step's outputs, op by "
                 "op on a NaN + every kernel wrapper on its plain version "
                 "with index bounds checked (no launches)")
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
    ap.add_argument("--trainer", default="shard_map",
                    choices=["shard_map", "fsdp"],
                    help="fsdp: the master state (params, AdamW's m and v, "
                         "h_avg, w) sharded over the worker group's ranks "
                         "(spec backend 'fsdp')")
    add_sanitize_flag(ap)
    args = ap.parse_args(argv)
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


def add_sanitize_flag(ap) -> None:
    """JAX's ``--sanitize`` flag (``make sanitize-smoke``)."""
    ap.add_argument("--sanitize", action="store_true",
                    help="debug run: every step's outputs checked for NaN "
                         "(on one the step re-runs op by op and raises "
                         "FloatingPointError at the op that made it) + every "
                         "kernel wrapper on its plain version with index "
                         "bounds checked (repro_torch.kernels.enable)")


def start_sanitize(args, who: str) -> None:
    """``--sanitize``: sanitize mode for this process and its children
    (``kernels.enable``), said on rank 0 as JAX's drivers say it."""
    if args.sanitize:
        kernels.enable()
        if os.environ.get("RANK", "0") == "0":
            print(f"[{who}] {SANITIZE_LINE}")


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
        resample=args.local_batch_resample,
        backend="fsdp" if args.trainer == "fsdp" else "shard_map",
        problem=args.arch, smoke=args.smoke, mesh=args.mesh or f"{n}x1",
        n=n,
        d=tuning_dim(cfg), steps=args.steps, seed=args.seed,
        pipeline=args.pipeline, leaf_codecs=args.leaf_codecs)


def _placement_refusal(spec: ExperimentSpec) -> str:
    """Why a valid spec's state cannot be placed on its mesh ('' when it
    can): a ``model`` axis that does not split a sharded dim, which JAX's
    driver refuses too (``Model.model_axis_refusal``)."""
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
    Exits with the JAX driver's message on a bad spec, and names the leaf
    a ``model`` axis cannot split."""
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
    refusal = _placement_refusal(spec) or mesh_refusal(spec, world_size())
    if refusal:
        raise SystemExit(f"[train] {refusal}")
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

    # JAX's weights, model.init(jax.random.key(seed)); a mesh rank, and a
    # rank of the fsdp trainer, keeps its shards
    params = model.init(random.key(spec.seed), device=dev)
    shards = make_shards(spec, group, model)
    if shards is not None:
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
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["finetune"]:
        return finetune_main(argv[1:])
    if argv[:1] == ["serve"]:
        return serve_main(argv[1:])
    if argv[:1] == ["dryrun"]:
        return dryrun_main(argv[1:])
    args = parse_args(argv)
    start_sanitize(args, "train")
    spec = experiment(args)
    group = join_group(args, spec.n, model_axis(spec))
    try:
        return run(args, group, spec)
    finally:
        if group is not None:
            group.close()


def make_shards(spec: ExperimentSpec, group, model):
    """This rank's layout of the master state: the fsdp trainer's parts
    (``make_fsdp_shards``, on a ``model`` axis too), a mesh rank's model
    shards, or None (one process; nothing is sharded)."""
    if spec.backend == "fsdp":
        return make_fsdp_shards(group, build(spec).make_mesh(),
                                model.param_specs(), model.init_abstract())
    if group is not None and group.model is not None:
        return ModelShards.of(group.model, model.param_specs(),
                              model.init_abstract())
    return None


def resident_bytes(state) -> int:
    """The bytes a rank holds of the master trees (params, AdamW's m and
    v, h_avg, w), counted leaf by leaf."""
    trees = (state.params, state.opt_state["m"], state.opt_state["v"],
             state.h_avg, state.w)
    return sum(x.numel() * x.element_size() for t in trees if t is not None
               for x in T.leaves(t))


def save_params(args, group, spec: ExperimentSpec, step: int, state,
                step_fn) -> None:
    """``{"params": ...}`` with the spec, as the JAX driver saves it
    (``tree.save_checkpoint``); over a group rank 0 writes (every rank
    holds the same params, or under fsdp its shards, which every rank
    gathers first: :func:`whole_params`)."""
    params = whole_params(step_fn, state.params)
    if group is None or group.global_rank == 0:
        T.save_checkpoint(args.ckpt_dir, step, {"params": params},
                          spec=spec)


def whole_params(step_fn, tree):
    """A master tree (params, w) of ``step_fn``'s state whole: the tree
    itself, or gathered from the shards the step's ``shards`` attribute
    names (a collective: every rank of the group calls it)."""
    shards = getattr(step_fn, "shards", None)
    return tree if shards is None else shards.gather_tree(tree)


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
    if kernels.active():
        step_fn = sanitized_step(step_fn)
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
            save_params(args, group, spec, step + 1, state, step_fn)
            echo(f"[train] checkpoint @ {step + 1}")
    if args.ckpt_dir:
        save_params(args, group, spec, spec.steps, state, step_fn)
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
        shards = getattr(step_fn, "shards", None)
        steps = max(spec.steps, 1)
        fsdp = shards is not None and not shards.shards_worker_state
        if fsdp:
            stages = [("worker group", shards.axis.stats)]
            if shards.model_axis is not None:
                stages.append(("model axis", shards.model_axis.stats))
            echo(f"[train] fsdp: {group.world} ranks a worker group hold "
                 "the master state's parts, "
                 f"{resident_bytes(state)} B resident on rank 0 (params, "
                 "m, v, h_avg, w); gathers per rank per step: "
                 + "; ".join(
                     f"{name} {st['model_calls'] // steps} calls, "
                     f"{st['model_bytes'] // steps} B sent, "
                     f"{1e3 * st['model_s'] / steps:.2f} ms host time"
                     for name, st in stages))
        if group.model is not None:
            ms = group.model.stats
            dims = shards.model.dims if fsdp else shards.dims
            held = sum(d is not None for d in dims)
            echo(f"[train] model axis: {group.model.size} ranks a worker, "
                 f"each holding its shards of {held} of "
                 f"{len(dims)} leaves, "
                 f"{ms['model_calls'] // steps} collectives and "
                 f"{ms['model_bytes'] // steps} B sent per rank per step, "
                 f"{1e3 * ms['model_s'] / steps:.2f} ms host time in them "
                 "per step on rank 0")
    echo(f"[train] done: final loss {float(metrics['loss']):.4f}")
    return float(metrics["loss"])


# ---------------------------------------------------------------------------
# the staged fine-tuning harness (``repro/train/loop.py``) and its CLI
# (``repro/launch/finetune.py``), this driver's ``finetune`` subcommand
# ---------------------------------------------------------------------------

#: the eval stream's seed is ``spec.seed ^ EVAL_SEED_XOR``, decorrelated
#: from the training stream's
EVAL_SEED_XOR = 0xE7A1


@dataclasses.dataclass(frozen=True)
class FinetuneSettings:
    """The runtime knobs of a fine-tune run (JAX's, field for field); none
    enters the spec's fingerprint.  ``num_processes`` is the size of the
    worker group the run is on: 1 in one process, P under ``torchrun``
    (P x M ranks on a ``model`` axis of M)."""

    global_batch: int = 8
    seq_len: int = 32
    lr: float = 1e-4
    schedule: str = "auto"       # auto | cosine | wsd
    eval_every: int = 0          # 0 = final eval only
    eval_batches: int = 2
    log_every: int = 10
    heterogeneity: float = 0.5
    shard_size: int = 64         # for spec.resample fixed-shard minibatches
    num_processes: int = 1
    ckpt_dir: str = ""
    ckpt_every: int = 0


def expert_sparse_rules(params, base, *, n_experts: int,
                        experts_per_tok: int) -> str:
    """The ``leaf_codecs`` rule string that composes MoE expert sparsity
    with the base compressor's budget (JAX's): each expert leaf (wg, wu,
    wd of a MoE subtree) gets ``topk:K``, K the base compressor's dense
    entry budget on that leaf times ``experts_per_tok / n_experts``
    (at least 1), the rules sorted by path.  ``base`` must be a TopK or a
    BlockTopK, the compressors with an entry budget."""
    from repro_torch.core.compressors import BlockTopK, TopK
    from repro_torch.models.layers import EXPERT_LEAVES, _is_moe_subtree

    def dense_entries(size: int) -> int:
        if isinstance(base, BlockTopK):
            nb = -(-size // base.block)
            return nb * min(base.kb, base.block)
        if isinstance(base, TopK):
            return min(base.k, size)
        raise ValueError(
            f"expert_sparse_rules rescales an entry budget; base compressor "
            f"{base!r} has none (use topk:k or block_topk:b,kb)")

    leaves = {}

    def walk(node, prefix):
        if not isinstance(node, dict):
            return
        if _is_moe_subtree(node):
            for name in EXPERT_LEAVES:
                leaves["/".join(prefix + [name])] = int(node[name].numel())
        for k, v in node.items():
            walk(v, prefix + [k])

    walk(params, [])
    if not leaves:
        raise ValueError("expert_sparse_rules: no MoE subtree "
                         "(router + wg/wu/wd) found in the parameter tree")
    return ";".join(
        f"{path}=topk:"
        f"{max(1, dense_entries(leaves[path]) * experts_per_tok // n_experts)}"
        for path in sorted(leaves))


class FinetuneLoop:
    """The four stages of a fine-tune run of one spec (JAX's
    ``FinetuneLoop``): :meth:`setup` (model, schedule, AdamW, state and the
    step of the spec's backend; a moe arch's workers zero their inactive
    experts' gradients, ``layers.zero_inactive_expert_grads``),
    :meth:`build_data` (the training stream and a held-out one),
    :meth:`train` (periodic eval and checkpoints) and :meth:`evaluate`
    (the held-out loss at the workers' model); :meth:`run` chains them.
    Each stage runs the one before it when it has not run.

    ``group`` (a :class:`WorkerGroup`, under ``torchrun``) runs the
    workers over its ranks, on a ``model`` axis each worker over M ranks
    (tensor parallelism), and under fsdp the master state as each rank's
    parts; ``settings.num_processes`` must be the worker group's size (1
    without one): a JAX process owns a row of the mesh, M ranks here.
    ``config`` replaces the spec's config (e.g. the arch cut in depth).
    It runs on ``device`` (``cuda`` unless the caller asks for the CPU),
    or the group's."""

    def __init__(self, spec: ExperimentSpec, settings=None, *, config=None,
                 verbose: bool = True, device="cuda", group=None):
        self.check(spec, config)
        self.spec = spec
        self.settings = settings or FinetuneSettings()
        self.verbose = verbose
        self.cfg = config if config is not None else run_config(spec)
        self.run_obj = build(spec)
        self.group = group
        self.device = group.device if group is not None \
            else resolve_device(device)
        self.mesh = None
        self.data = None
        self.eval_data = None
        self.state = None
        self.history = []

    @staticmethod
    def check(spec: ExperimentSpec, config=None) -> None:
        """JAX's refusals of a spec the harness cannot run (SpecError)."""
        if spec.backend == "reference":
            raise SpecError(
                "the fine-tune harness drives the distributed trainers; a "
                "backend='reference' spec runs via build(spec).reference()")
        if config is None and spec.problem not in ARCHS:
            raise SpecError(
                f"the fine-tune harness trains model archs {sorted(ARCHS)}; "
                f"problem={spec.problem!r} needs an explicit config=")

    def _log(self, msg: str):
        if self.verbose and (self.group is None
                             or self.group.global_rank == 0):
            print(f"[finetune] {msg}")

    # ---- stage 1: setup ----------------------------------------------------

    def setup(self):
        """The mesh (its process-major layout checked for the group's
        size), model, schedule (``auto``: WSD for minicpm, else cosine),
        AdamW (weight decay 0.01), the state from JAX's weights at
        ``random.key(spec.seed)`` and the step of ``spec.backend``."""
        from repro_torch.models.layers import zero_inactive_expert_grads

        spec, st = self.spec, self.settings
        run_ = self.run_obj
        # JAX's geometry first (its message for a bad --processes): the
        # leading axis must tile the processes.  A JAX process owning a
        # row of M devices is M ranks here, one per model index, so the
        # process count is the worker group's size
        self.mesh = make_multihost_mesh(spec.mesh_dims(),
                                        num_processes=st.num_processes)
        world = 1 if self.group is None else self.group.world
        if st.num_processes != world:
            raise SpecError(
                f"num_processes={st.num_processes}, but the run is on a "
                f"worker group of {world} process(es): launch that many "
                "ranks a model index under torchrun")
        m = model_size(self.mesh)
        tp = None if self.group is None else self.group.model
        if (1 if tp is None else tp.size) != m:
            raise SpecError(
                f"mesh {spec.mesh!r} has a 'model' axis of {m}: it runs on "
                f"{st.num_processes} x {m} ranks under torchrun (W' x M, "
                f"W' = --processes), not on "
                f"{world * (1 if tp is None else tp.size)}")
        self.n = num_workers(self.mesh)
        self.model = build_model(self.cfg)
        refusal = self.model.model_axis_refusal(m)
        if refusal:
            raise ValueError(f"mesh {spec.mesh!r}: {refusal}")
        kind = schedule_kind(st.schedule, spec.problem)
        self.opt = adamw(make_schedule(kind, st.lr, spec.steps),
                         weight_decay=0.01)
        self.key = random.key(spec.seed)
        params = self.model.init(self.key, device=self.device)
        self.shards = make_shards(spec, self.group, self.model)
        if self.shards is not None:
            params = self.shards.shard_tree(params)
        self.state = run_.init_state(params, self.opt, group=self.group,
                                     shards=self.shards)
        # the worker side of the expert-sparsity contract: inactive
        # experts' slabs pinned to exact zero before compression
        grad_transform = (zero_inactive_expert_grads
                          if self.cfg.family == "moe" else None)
        loss_fn = self.model.loss if tp is None \
            else functools.partial(self.model.loss, tp=tp)
        self.step_fn = run_.train_step(loss_fn, self.opt,
                                       group=self.group, shards=self.shards,
                                       grad_transform=grad_transform)
        if kernels.active():
            self.step_fn = sanitized_step(self.step_fn)
        algo = run_.algo
        self._log(f"arch={self.cfg.name} family={self.cfg.family} "
                  f"params~{self.cfg.param_count():,} workers={self.n} "
                  f"backend={spec.backend} mesh={spec.mesh} "
                  f"processes={st.num_processes} algo={spec.mode} "
                  f"lam={algo.lam:.4g} nu={algo.nu:.4g}"
                  + (" grad_transform=expert_sparsity"
                     if grad_transform else "")
                  + f" device={self.device}")
        self._log(f"spec fingerprint={spec.fingerprint()}")
        rb = self.wire_report()
        # exact integers (JAX's line rounds them, :g)
        self._log(f"wire: up={rb['up']} down={rb['down']} "
                  f"total={rb['total']} bits/round "
                  f"({rb['total'] / max(rb['dense_both_ways'], 1):.6f}x "
                  "dense both ways)")
        return self

    def wire_report(self) -> dict:
        """Exact up + down bits of one round on the model's parameter tree
        (``Run.round_bits``: ``{'up', 'down', 'total',
        'dense_both_ways'}``)."""
        if self.state is None:
            raise RuntimeError("wire_report() needs setup() first")
        return self.run_obj.round_bits(self.model.init_abstract())

    # ---- stage 2: data -----------------------------------------------------

    def build_data(self):
        """``SyntheticLM`` streams over the n workers: the training stream
        at ``spec.seed`` and the held-out one at ``spec.seed ^
        EVAL_SEED_XOR``; every rank makes the whole global batch and its
        step takes its workers' rows."""
        spec, st = self.spec, self.settings
        if self.mesh is None:
            self.setup()

        def stream(seed):
            return SyntheticLM(
                vocab=self.cfg.vocab, seq_len=st.seq_len,
                global_batch=st.global_batch, n_workers=self.n, seed=seed,
                heterogeneity=st.heterogeneity,
                resample_from_shard=spec.resample, shard_size=st.shard_size)

        self.data = stream(spec.seed)
        self.eval_data = stream(spec.seed ^ EVAL_SEED_XOR)
        return self

    def _batch(self, data, step: int) -> dict:
        return step_batch(data, self.cfg, self.settings.global_batch, step)

    # ---- stage 3: the compressed train loop --------------------------------

    def train(self, steps=None):
        """``steps`` (default ``spec.steps``) steps, step s under
        ``fold_in(key(spec.seed), s)``; an eval every
        ``settings.eval_every`` steps, a checkpoint every
        ``settings.ckpt_every`` and at the end (``{"params": ...}``,
        JAX's npz format, gathered whole under fsdp)."""
        spec, st = self.spec, self.settings
        if self.data is None:
            self.build_data()
        steps = spec.steps if steps is None else steps
        t0 = time.time()
        metrics = {}
        for step in range(steps):
            self.state, metrics = self.step_fn(
                self.state, self._batch(self.data, step),
                random.fold_in(self.key, step))
            if step % st.log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                self._log(f"step {step:5d} loss={m['loss']:.4f} "
                          f"|g|={m['g_norm']:.3f} "
                          f"h_res={m['h_residual']:.3f} "
                          f"({(time.time() - t0) / (step + 1):.2f}s/step)")
            if st.eval_every and (step + 1) % st.eval_every == 0:
                self.evaluate(step=step + 1)
            if st.ckpt_dir and st.ckpt_every \
                    and (step + 1) % st.ckpt_every == 0:
                self._save(step + 1)
                self._log(f"checkpoint @ {step + 1}")
        self._final = {k: float(v) for k, v in metrics.items()}
        self._steps_per_sec = steps / max(time.time() - t0, 1e-9)
        if st.ckpt_dir:
            self._save(steps)
        return self

    def _save(self, step: int) -> None:
        params = whole_params(self.step_fn, self.state.params)
        if self.group is None or self.group.global_rank == 0:
            T.save_checkpoint(self.settings.ckpt_dir, step,
                              {"params": params}, spec=self.spec)

    # ---- stage 4: eval -----------------------------------------------------

    @torch.no_grad()
    def evaluate(self, step=None) -> float:
        """The mean held-out loss over ``settings.eval_batches`` batches of
        the eval stream, at the workers' model: w under a downlink, the
        params otherwise, whole (gathered under fsdp)."""
        if self.eval_data is None:
            self.build_data()
        tree = self.state.w if self.state.w is not None else self.state.params
        params = whole_params(self.step_fn, tree)
        losses = []
        for b in range(self.settings.eval_batches):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self._batch(self.eval_data, b).items()}
            losses.append(float(self.model.loss(params, batch)[0]))
        del params
        loss = float(np.mean(losses))
        self.history.append({"step": float(self.state.step),
                             "eval_loss": loss})
        self._log(f"eval @ {int(self.state.step)}: loss={loss:.4f} "
                  f"({self.settings.eval_batches} held-out batches)")
        return loss

    # ---- all four stages ---------------------------------------------------

    def run(self) -> dict:
        self.setup()
        self.build_data()
        self.train()
        eval_loss = self.evaluate()
        return {
            "fingerprint": self.spec.fingerprint(),
            "arch": self.cfg.name,
            "family": self.cfg.family,
            "final_loss": self._final["loss"],
            "eval_loss": eval_loss,
            "steps_per_sec": round(self._steps_per_sec, 4),
            "round_bits": self.wire_report(),
        }


def finetune(spec: ExperimentSpec, settings=None, *, config=None,
             verbose: bool = True, device="cuda", group=None) -> dict:
    """All four stages of :class:`FinetuneLoop`; returns the summary."""
    return FinetuneLoop(spec, settings, config=config, verbose=verbose,
                        device=device, group=group).run()


def parse_finetune_args(argv=None):
    """The flags of JAX's ``launch/finetune.py`` (same names, defaults and
    choices), and the port's ``--device``, ``--dist-backend`` and
    ``--dist-init``.  ``--processes`` is the worker group's size: P ranks
    under ``torchrun``."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train finetune")
    ap.add_argument("--spec", required=True,
                    help="path to the ExperimentSpec JSON driving the run "
                         "(committed examples live in examples/specs/)")
    ap.add_argument("--steps", type=int, default=0,
                    help="train this many steps instead of spec.steps "
                         "(0 = the spec's own budget; a truncated run keeps "
                         "the spec identity)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--schedule", default="auto",
                    choices=["auto", "cosine", "wsd"])
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out eval cadence (0 = final eval only)")
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--heterogeneity", type=float, default=0.5)
    ap.add_argument("--shard-size", type=int, default=64)
    ap.add_argument("--processes", type=int, default=1,
                    help="the worker group's size: the ranks torchrun "
                         "starts, divided by the spec's model axis (1 in "
                         "one process)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    add_sanitize_flag(ap)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default="", choices=("",) + BACKENDS,
                    help="process-group backend; required when WORLD_SIZE "
                         "> 1")
    ap.add_argument("--dist-init", default="",
                    help="init_method of the process group (default env://)")
    args = ap.parse_args(argv)
    if world_size() > 1 and not args.dist_backend:
        ap.error(f"WORLD_SIZE={world_size()}: --dist-backend "
                 f"{{{','.join(BACKENDS)}}} must be given")
    return args


def finetune_main(argv=None) -> float:
    """``python -m repro_torch.launch.train finetune --spec ...``: JAX's
    ``launch/finetune.py`` ``main`` (the spec file is the experiment, the
    flags its runtime knobs); returns the eval loss."""
    args = parse_finetune_args(argv)
    start_sanitize(args, "finetune")
    settings = FinetuneSettings(
        global_batch=args.global_batch, seq_len=args.seq, lr=args.lr,
        schedule=args.schedule, eval_every=args.eval_every,
        eval_batches=args.eval_batches, log_every=args.log_every,
        heterogeneity=args.heterogeneity, shard_size=args.shard_size,
        num_processes=args.processes, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every)
    try:
        with open(args.spec) as f:
            spec = ExperimentSpec.from_json(f.read())
        FinetuneLoop.check(spec)
    except (SpecError, ValueError, OSError) as e:
        raise SystemExit(f"[finetune] bad experiment spec: {e}")
    group = join_group(args, spec.n, model_axis(spec))
    try:
        loop = FinetuneLoop(spec, settings, device=args.device, group=group)
        loop.setup()
        loop.build_data()
        loop.train(steps=args.steps or None)
        eval_loss = loop.evaluate()
        loop._log(f"done: final loss {loop._final['loss']:.4f} "
                  f"eval loss {eval_loss:.4f} "
                  f"({loop._steps_per_sec:.3f} steps/s)")
        if isinstance(loop.state.inflight, Pending):
            loop.state.inflight.wait()
        return eval_loss
    finally:
        if group is not None:
            group.close()



# -----------------------------------------------------------------------------
# serving (``repro/launch/serve.py``), the ``serve`` subcommand
# -----------------------------------------------------------------------------
#
# The trainer's downlink control variate w (``core.efbv.Downlink``) is the
# workers' shared reconstruction of the model, which is what a serving
# replica needs: :class:`DeltaPusher` (the trainer's side: versioned
# compressed pushes and a checkpoint a version), :class:`ServeReplica` (w
# advanced by ``Downlink.apply_push``, a push staged into a shadow and
# committed between decode steps, stale pushes refused, a gap resynced
# from the newest checkpoint), :class:`DecodeEngine` (continuous batching
# over the cache's lanes) and :func:`run_fleet` (the simulated fleet of a
# spec's ``serve`` leg).


@dataclasses.dataclass
class Request:
    """One decode request: ``prompt`` then ``gen`` greedy tokens.  ``out``
    collects the generated ids, ``versions[i]`` the model version (the tag
    given to :meth:`DecodeEngine.step`) that produced ``out[i]``."""

    rid: int
    prompt: np.ndarray
    gen: int
    frames: object = None
    out: list = dataclasses.field(default_factory=list)
    versions: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def total_steps(self) -> int:
        return len(self.prompt) + self.gen


class DecodeEngine:
    """Greedy decode over ``slots`` cache lanes, requests admitted and
    retired at every step (JAX's ``DecodeEngine``).

    Axis 1 of every cache leaf is the lane; one batched
    ``Model.decode_step`` advances every lane at its own position (JAX runs
    ``vmap`` of the one-lane step), and the lanes do not interact, so a
    request decodes the same ids whatever its neighbours do.  The input at
    position p is ``prompt[p]`` while p < len(prompt), else the previous
    output (0 for an empty prompt at p = 0); the output ids are those of
    positions len(prompt) .. len(prompt) + gen - 1.  An admitted lane is
    zeroed in every cache leaf (the SSM state accumulates), and an encdec
    request's ``frames`` fill its cross-attention cache."""

    def __init__(self, model, *, slots: int, max_len: int, device="cuda"):
        if slots <= 0:
            raise ValueError(f"need at least one slot, got {slots}")
        self.model = model
        self.cfg = model.cfg
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.cache = model.init_cache(slots, max_len, self.device)
        self.pos = np.zeros(slots, np.int64)
        self.last_tok = np.zeros(slots, np.int64)
        self.active = [None] * slots
        self.queue = collections.deque()
        self.finished = []
        self.tokens_decoded = 0
        self._next_rid = 0

    def submit(self, prompt, gen: int, *, frames=None) -> Request:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) + gen > self.max_len:
            raise ValueError(
                f"request needs {len(prompt)} prompt + {gen} generated = "
                f"{len(prompt) + gen} positions but the decode cache holds "
                f"{self.max_len}; shorten the request or build the engine "
                "with a larger max_len")
        req = Request(rid=self._next_rid, prompt=prompt, gen=int(gen),
                      frames=frames)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def _admit(self, params) -> None:
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            self.active[s] = req
            self.pos[s] = 0
            self.last_tok[s] = 0
            for leaf in T.leaves(self.cache):
                leaf[:, s] = 0
            if req.frames is not None:
                frames = torch.as_tensor(req.frames, device=self.device)
                c1 = self.model.encode_cross_cache(
                    params, frames[None],
                    self.model.init_cache(1, self.max_len, self.device))
                for k in ("cross_k", "cross_v"):
                    self.cache[k][:, s] = c1[k][:, 0]

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.active)

    def step(self, params, *, version: int = -1) -> int:
        """Admit what fits, advance every lane one token, retire finished
        requests; ``version`` tags this step's tokens.  Returns the request
        tokens decoded (idle lanes do not count)."""
        self._admit(params)
        toks = np.zeros(self.slots, np.int64)
        for s, req in enumerate(self.active):
            if req is not None:
                p = self.pos[s]
                toks[s] = req.prompt[p] if p < len(req.prompt) \
                    else self.last_tok[s]
        logits, self.cache = self.model.decode_step(
            params, self.cache,
            torch.from_numpy(toks).to(self.device)[:, None],
            torch.from_numpy(self.pos.copy()).to(self.device))
        out = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        decoded = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            decoded += 1
            p = int(self.pos[s])
            if p >= len(req.prompt):
                req.out.append(int(out[s]))
                req.versions.append(version)
            self.last_tok[s] = int(out[s])
            self.pos[s] = p + 1
            if p + 1 == req.total_steps:
                req.done = True
                self.finished.append(req)
                self.active[s] = None
        self.tokens_decoded += decoded
        return decoded

    def run(self, params, *, version: int = -1) -> int:
        """Drain the queue and the lanes; returns the tokens decoded."""
        n = 0
        while not self.idle:
            n += self.step(params, version=version)
        return n


def push_key(key, version: int):
    """The key of push ``version``: training round ``version``'s downlink
    key, ``downlink_key(fold_in(key, version))``, so a push and that
    round's broadcast put the same bits on the wire."""
    return downlink_key(random.fold_in(key, version))


def _synchronize(tree) -> None:
    """Wait for the card that holds ``tree``'s first leaf (no-op on the
    CPU), so a host timer covers the device work."""
    leaves = T.leaves(tree)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class DeltaPusher:
    """The trainer's side of the push protocol: the fleet's shared
    reconstruction ``w``, strictly versioned :class:`wire.DeltaEnvelope`s,
    and a checkpoint of w a version (``tree.save_checkpoint``) as the
    replicas' resync source."""

    def __init__(self, downlink: Downlink, params0, *, key,
                 wire_dtype: str = "float32", rules=None, ckpt_dir=None,
                 spec=None):
        self.downlink = downlink
        self.wire_dtype = wire_dtype
        self.rules = rules
        self.key = key
        self.ckpt_dir = ckpt_dir
        self.spec = spec
        self.version = 0
        self.w = downlink.init(params0)
        if ckpt_dir is not None:
            T.save_checkpoint(ckpt_dir, 0, self.w, spec=spec)

    def push(self, x) -> "wire.DeltaEnvelope":
        """Compress x - w (a lossless wire: x itself) into the next
        envelope and advance w as every replica will."""
        v = self.version + 1
        self.w, payloads = self.downlink.encode_push(
            push_key(self.key, v), x, self.w, wire_dtype=self.wire_dtype,
            rules=self.rules)
        env = wire.DeltaEnvelope(
            version=v, base_version=self.version, payloads=payloads,
            kind=self.downlink.push_kind(self.wire_dtype, self.rules))
        self.version = v
        if self.ckpt_dir is not None:
            T.save_checkpoint(self.ckpt_dir, v, self.w, spec=self.spec)
        return env


class ServeReplica:
    """One serving replica: its reconstruction ``params`` (w) and a
    versioned hot-swap.  :meth:`stage` decodes a push into a shadow while
    the current model serves; :meth:`commit` swaps it in between decode
    steps, one rebind, so every token comes from one version.  A push at
    or below the replica's version is stale (refused, idempotent); a
    delta whose ``base_version`` is not the replica's is a gap: the
    replica resyncs from the newest checkpoint, then chains the push on if
    it still applies.  A snapshot push assigns, so it repairs a gap by
    itself."""

    def __init__(self, downlink: Downlink, params0, *,
                 wire_dtype: str = "float32", rules=None, ckpt_dir=None,
                 spec=None, version: int = 0):
        self.downlink = downlink
        self.wire_dtype = wire_dtype
        self.rules = rules
        self.ckpt_dir = ckpt_dir
        self.spec = spec
        self.version = version
        self.params = params0
        self._shadow = None
        self.stage_s = []
        self.swap_s = []
        self.resyncs = 0

    def stage(self, env) -> str:
        """Decode a push into the shadow: 'staged', 'stale' or 'gap'."""
        if env.version <= self.version:
            return "stale"
        if env.kind == "delta" and env.base_version != self.version:
            return "gap"
        t0 = time.perf_counter()
        w_new = self.downlink.apply_push(env.payloads, self.params,
                                         wire_dtype=self.wire_dtype,
                                         rules=self.rules)
        _synchronize(w_new)
        self.stage_s.append(time.perf_counter() - t0)
        self._shadow = (env.version, w_new)
        return "staged"

    def commit(self) -> bool:
        """Swap the staged model in: one rebind, nothing decoded here."""
        if self._shadow is None:
            return False
        t0 = time.perf_counter()
        self.version, self.params = self._shadow
        self._shadow = None
        self.swap_s.append(time.perf_counter() - t0)
        return True

    def resync(self) -> int:
        """Stage the newest checkpoint (the pusher writes w each version,
        so this re-pins w bit for bit); :meth:`commit` applies it."""
        if self.ckpt_dir is None:
            raise RuntimeError(
                "replica hit a version gap but has no ckpt_dir to resync "
                "from; construct ServeReplica(..., ckpt_dir=...) or ship "
                "snapshot pushes")
        got = T.restore_latest(self.ckpt_dir, self.params, spec=self.spec)
        if got is None:
            raise RuntimeError(f"no checkpoint to resync from in "
                               f"{self.ckpt_dir!r}")
        self.resyncs += 1
        self._shadow = got
        return got[0]

    def push(self, env) -> str:
        """Stage and commit in one call: 'applied', 'stale' or 'resync'."""
        st = self.stage(env)
        if st == "staged":
            self.commit()
            return "applied"
        if st == "gap":
            self.resync()
            self.commit()
            if self.stage(env) == "staged":  # the push chains on the restore
                self.commit()
            return "resync"
        return st


def _train_move(x, key):
    """One simulated training update: leaf j plus ``0.01 * normal(
    fold_in(key, j))``, each op rounded on its own as JAX's eager code
    rounds it."""
    new = []
    for j, leaf in enumerate(T.leaves(x)):
        z = random.normal(random.fold_in(key, j), leaf.numel(), leaf.device)
        new.append((leaf.float() + 0.01 * z.reshape(leaf.shape))
                   .to(leaf.dtype))
        del z
    return T.unflatten(x, new)


def _assert_fleet_pinned(pusher: DeltaPusher, replicas) -> None:
    """Every replica at the pusher's version, its w bitwise the pusher's."""
    want = T.leaves(pusher.w)
    for r, rep in enumerate(replicas):
        if rep.version != pusher.version:
            raise AssertionError(f"replica {r} at version {rep.version}, "
                                 f"trainer at {pusher.version}")
        for j, (a, b) in enumerate(zip(T.leaves(rep.params), want)):
            if a.dtype != b.dtype or not torch.equal(
                    a.contiguous().view(torch.uint8),
                    b.contiguous().view(torch.uint8)):
                raise AssertionError(
                    f"replica {r} leaf {j} diverged from the trainer's w "
                    f"at version {pusher.version}")


def run_fleet(spec: ExperimentSpec, *, ckpt_dir=None, quiet: bool = False,
              device="cuda") -> dict:
    """The simulated replica fleet of ``spec``'s ``serve`` leg (JAX's
    ``run_fleet``): the pusher sends ``pushes`` compressed deltas of a
    simulated training trajectory while every replica decodes its
    requests (two waves of ``slots``), a push staged while the old version
    serves and committed between steps.  Asserts every replica's w bitwise
    the pusher's after every push; returns JAX's metrics under its keys.
    As in JAX, the fleet runs in this one process and reads no ``mesh``."""
    sv = spec.serve_spec()
    if sv is None:
        raise SpecError("run_fleet needs a spec with a serve leg (e.g. "
                        "serve='replicas:2,slots:2,prompt:4,gen:8')")
    dev = resolve_device(device)
    cfg = run_config(spec)
    model = build_model(cfg)
    root = random.key(spec.seed)
    k_params, k_prompt, k_train = random.split(root, 3)
    params = model.init(k_params, device=dev)
    downlink = Downlink.parse(spec.downlink) or Downlink.parse("identity")
    rules = wire.parse_leaf_rules(spec.leaf_codecs) \
        if spec.leaf_codecs else None
    pusher = DeltaPusher(downlink, params, key=root,
                         wire_dtype=spec.wire_dtype, rules=rules,
                         ckpt_dir=ckpt_dir, spec=spec)
    # exact per-push wire accounting (the envelope, header included)
    fmt = downlink.serve_format(params, wire_dtype=spec.wire_dtype,
                                rules=rules)
    del params
    delta_bits = wire.push_bits(fmt)
    ckpt_bits = wire.checkpoint_push_bits(fmt)
    replicas = [ServeReplica(downlink, pusher.w, wire_dtype=spec.wire_dtype,
                             rules=rules, ckpt_dir=ckpt_dir, spec=spec)
                for _ in range(sv.replicas)]
    engines = [DecodeEngine(model, slots=sv.slots, max_len=sv.max_len,
                            device=dev) for _ in range(sv.replicas)]
    for r, eng in enumerate(engines):
        for q in range(2 * sv.slots):  # 2 waves: admission mid-flight
            kq = random.fold_in(k_prompt, r * 1000 + q)
            eng.submit(random.randint(kq, sv.prompt, 0, cfg.vocab, dev)
                       .cpu().numpy(), sv.gen)

    x = pusher.w
    steps_per_phase = max(1, (2 * sv.slots * (sv.prompt + sv.gen))
                          // (sv.pushes * max(1, sv.slots)))
    t0 = time.perf_counter()
    for v in range(1, sv.pushes + 1):
        x = _train_move(x, random.fold_in(k_train, v))
        env = pusher.push(x)
        for rep, eng in zip(replicas, engines):
            st = rep.stage(env)
            if st != "staged":
                raise AssertionError(f"replica refused push {v}: {st}")
            for _ in range(steps_per_phase):  # the old version serves on
                if eng.idle:
                    break
                eng.step(rep.params, version=rep.version)
            rep.commit()
        _assert_fleet_pinned(pusher, replicas)
    for rep, eng in zip(replicas, engines):
        eng.run(rep.params, version=rep.version)
    _synchronize(pusher.w)
    wall_s = time.perf_counter() - t0

    tokens = sum(eng.tokens_decoded for eng in engines)
    swaps = [s for rep in replicas for s in rep.swap_s]
    stages = [s for rep in replicas for s in rep.stage_s]
    metrics = {
        "fingerprint": spec.fingerprint(),
        "replicas": sv.replicas,
        "pushes": sv.pushes,
        "requests": sum(len(eng.finished) for eng in engines),
        "tokens": tokens,
        "tok_per_s": tokens / max(wall_s, 1e-9),
        "delta_bits_per_push": delta_bits,
        "checkpoint_bits_per_push": ckpt_bits,
        "push_ratio": delta_bits / ckpt_bits,
        "swap_ms_max": 1e3 * max(swaps, default=0.0),
        "stage_ms_max": 1e3 * max(stages, default=0.0),
    }
    if not quiet:
        print(f"[serve-fleet] arch={cfg.name} replicas={sv.replicas} "
              f"pushes={sv.pushes} device={dev.type}: "
              f"{metrics['tok_per_s']:.1f} tok/s, delta {delta_bits} vs "
              f"checkpoint {ckpt_bits} bits/push "
              f"({metrics['push_ratio']:.6f}x), swap "
              f"{metrics['swap_ms_max']:.3f} ms max, stage "
              f"{metrics['stage_ms_max']:.3f} ms max; spec fingerprint="
              f"{metrics['fingerprint']}")
    return metrics


def parse_serve_args(argv=None):
    """The flags of JAX's ``launch/serve.py`` (same names, defaults and the
    ``--prompt-len + --gen <= --max-len`` check), and the port's
    ``--device``."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train serve")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec", default=None, metavar="SPEC_JSON",
                    help="run the replica-fleet driver for this spec file "
                         "(needs a 'serve' field) instead of the "
                         "single-model decode")
    ap.add_argument("--ckpt-dir", default=None,
                    help="fleet mode: checkpoint directory for the "
                         "per-version resync source")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.prompt_len + args.gen > args.max_len:
        ap.error(
            f"--prompt-len {args.prompt_len} + --gen {args.gen} = "
            f"{args.prompt_len + args.gen} tokens would overrun the decode "
            f"cache (--max-len {args.max_len}); shorten the request or "
            "raise --max-len")
    return args


def serve_main(argv=None):
    """``python -m repro_torch.launch.train serve``: JAX's ``launch/serve.py``
    ``main``.  ``--spec`` runs the fleet (returns its metrics); otherwise
    greedy decode of ``--batch`` random prompts (encdec with random
    frames) on the engine, returning the (batch, gen) generated ids."""
    args = parse_serve_args(argv)
    dev = resolve_device(args.device)
    if args.spec is not None:
        try:
            with open(args.spec) as f:
                spec = ExperimentSpec.from_json(f.read())
            if spec.serve_spec() is None:
                raise SpecError("the serve driver needs a spec with a "
                                "'serve' field")
        except (SpecError, ValueError, OSError) as e:
            raise SystemExit(f"[serve] bad experiment spec: {e}")
        return run_fleet(spec, ckpt_dir=args.ckpt_dir, device=dev)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    # independent streams for the params, the prompts and the frames
    k_params, k_prompt, k_frames = random.split(random.key(args.seed), 3)
    params = model.init(k_params, device=dev)
    B = args.batch
    prompts = random.randint(k_prompt, B * args.prompt_len, 0, cfg.vocab,
                             dev).reshape(B, args.prompt_len).cpu().numpy()
    frames = None
    if cfg.family == "encdec":
        frames = random.normal(k_frames, B * cfg.encoder_frames
                               * cfg.d_model, dev).reshape(
            B, cfg.encoder_frames, cfg.d_model) * 0.1
    engine = DecodeEngine(model, slots=B, max_len=args.max_len, device=dev)
    reqs = [engine.submit(prompts[i], args.gen,
                          frames=None if frames is None else frames[i])
            for i in range(B)]
    t0 = time.time()
    engine.run(params)
    dt = time.time() - t0
    gen = np.stack([np.asarray(r.out, np.int64) for r in reqs], 0)
    total_tokens = B * (args.prompt_len + args.gen)
    print(f"[serve] arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen}: {total_tokens / dt:.1f} tok/s ({dev.type})")
    print(f"[serve] sample continuation (req 0): {gen[0][:16].tolist()}")
    return gen



# -----------------------------------------------------------------------------
# the dry run (``repro/launch/dryrun.py`` and ``launch/shapes.py``), the
# ``dryrun`` subcommand
# -----------------------------------------------------------------------------
#
# JAX lowers and compiles each (arch, shape, mesh) on 512 fake devices and
# reads XLA's buffer assignment and HLO.  A torch step has no HLO: here one
# rank's program runs on the ``meta`` device (shapes and dtypes, no
# storage) over torch's fake process group of the mesh's 256 or 512 ranks,
# and :class:`MetaTrace` watches every op: the storages it allocates and
# frees, its flops, the bytes it reads and writes, and the collectives.

#: JAX's dry-run compressor: about 1.6% density, paper-style k << d
DRYRUN_COMPRESSOR = "block_topk:4096,64"
LONG_CTX_WINDOW = 4096

#: H100 SXM5 80GB data-sheet peaks, not measured: dense bf16 tensor-core
#: flops (NVIDIA H100 data sheet, SXM5: 989.4 TFLOP/s without sparsity),
#: HBM3 bytes (3.35 TB/s), NVLink 4 bytes one way (900 GB/s both ways)
H100_BF16_FLOPS = 989.4e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """An input shape of the dry run (JAX's): the sequence, the global
    batch, and the program: ``train`` (the step), ``prefill`` (the
    forward's last logits) or ``decode`` (one token on a KV cache)."""

    name: str
    seq: int
    global_batch: int
    kind: str


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def adapt_config(cfg, shape: ShapeSpec):
    """(the config the shape runs, note), or (None, skip reason): JAX's
    policy -- long_500k runs the ssm natively, every attention arch as a
    sliding-window variant, and skips the encdec."""
    if shape.name != "long_500k":
        return cfg, ""
    if cfg.family == "encdec":
        return None, ("skip: enc-dec decoder is not a 500k-token generator "
                      "(DESIGN §6)")
    if cfg.family in ("ssm",):
        return cfg, "native sub-quadratic (recurrent state)"
    if cfg.attn_window == 0:
        cfg = dataclasses.replace(cfg, attn_window=LONG_CTX_WINDOW,
                                  name=cfg.name + "-swa")
        return cfg, f"sliding-window({LONG_CTX_WINDOW}) variant"
    return cfg, "windowed"


def _rank_rows(B: int, n: int) -> int:
    """A rank's rows of a global batch of B: B / n when the n workers split
    it (sharded over the worker axes), else all B (replicated), as JAX's
    ``_maybe_worker_sharded``."""
    return B // n if B % n == 0 else B


def batch_struct(cfg, shape: ShapeSpec, mesh, device="meta") -> dict:
    """One rank's train or prefill batch (its rows, :func:`_rank_rows`):
    ``tokens`` (and for train ``labels``) int32, the vlm's f32
    ``vision_embeds`` before the text, the encdec's f32 ``frames``."""
    b = _rank_rows(shape.global_batch, num_workers(mesh))
    out, text = {}, shape.seq
    if cfg.family == "vlm":
        text = shape.seq - cfg.vision_patches
        out["vision_embeds"] = torch.empty(
            (b, cfg.vision_patches, cfg.d_model), device=device)
    if cfg.family == "encdec":
        out["frames"] = torch.empty((b, cfg.encoder_frames, cfg.d_model),
                                    device=device)
    out["tokens"] = torch.empty((b, text), dtype=torch.int32, device=device)
    if shape.kind == "train":
        out["labels"] = torch.empty((b, text), dtype=torch.int32,
                                    device=device)
    return out


def _shard_cache(cache, specs, tp):
    """A cache tree's shards on the model axis ``tp`` (its specs)."""
    if isinstance(cache, dict):
        return {k: _shard_cache(v, specs[k], tp) for k, v in cache.items()}
    dim = spec_dim(specs)
    return cache if tp is None or dim is None else tp.shard(cache, dim)


def decode_structs(cfg, shape: ShapeSpec, mesh, model, tp=None,
                   device="meta"):
    """(cache, token, pos) of one rank's decode: the cache of its lanes
    (:func:`_rank_rows`) at the shape's context, sharded by
    ``model.cache_specs`` on the model axis ``tp``; the (lanes, 1) int32
    token; the 0-d int32 position, as JAX's ``decode_structs``."""
    b = _rank_rows(shape.global_batch, num_workers(mesh))
    cache = _shard_cache(model.init_cache(b, shape.seq, device=device),
                         model.cache_specs(), tp)
    token = torch.empty((b, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    return cache, token, pos


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors."""
    return sum(t.numel() * t.element_size() for t in T.leaves(tree)
               if isinstance(t, torch.Tensor))


#: c10d ops by the collective's kind (JAX's names)
COLLECTIVE_KINDS = {"allgather_": "all-gather", "_allgather_base_":
                    "all-gather", "allgather_into_tensor_coalesced_":
                    "all-gather", "allreduce_": "all-reduce",
                    "allreduce_coalesced_": "all-reduce",
                    "reduce_scatter_": "reduce-scatter",
                    "_reduce_scatter_base_": "reduce-scatter",
                    "alltoall_": "all-to-all", "alltoall_base_":
                    "all-to-all", "broadcast_": "broadcast",
                    "send": "send", "recv_": "recv"}
#: ops whose outputs are views: they move no bytes
_NO_BYTES = ("empty", "empty_like", "new_empty", "empty_strided", "zeros",
             "zeros_like", "new_zeros", "full", "full_like", "new_full")


class MetaTrace:
    """A dispatch mode over one rank's program on the ``meta`` device: the
    bytes of the storages its ops allocate, live at once (``live``, the
    peak ``peak``: a storage counts from its allocation until it dies,
    autograd's saved tensors included), matmul flops (torch's flop
    formulas: matmuls, convolutions, fused attention), the bytes each op
    reads and writes, the collectives' output bytes by kind, the host reads
    the meta device cannot answer (skipped, counted by op and caller), and
    with ``record`` every op (name, shapes, dtypes, flops)."""

    def __init__(self, record: bool = False):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        self.live = self.peak = self.flops = self.bytes = 0
        self.coll = collections.Counter()
        self.host_reads = collections.Counter()
        self.ops = [] if record else None
        self._seen = set()
        trace, registry = self, flop_registry

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return trace._dispatch(registry, func, args, kwargs or {})

        self.mode = Mode()

    def exclude(self, *trees) -> None:
        """Count the storages of ``trees`` (the arguments) as held already:
        an op that writes into one allocates nothing."""
        for t in trees:
            for x in T.leaves(t):
                if isinstance(x, torch.Tensor):
                    self._seen.add(x.untyped_storage()._cdata)

    def _track(self, t: torch.Tensor) -> None:
        import weakref

        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _dispatch(self, registry, func, args, kwargs):
        from torch.utils._pytree import tree_leaves

        name = func._overloadpacket.__name__
        if name == "_local_scalar_dense":
            self.host_reads[f"{name} at {_caller()}"] += 1
            return 0
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        flops = 0
        if func.namespace == "c10d":
            kind = COLLECTIVE_KINDS.get(name, name)
            self.coll[kind] += sum(t.numel() * t.element_size()
                                   for t in outs)
        else:
            packet = func._overloadpacket
            if packet in registry:
                flops = int(registry[packet](*args, **kwargs, out_val=out))
                self.flops += flops
            if not func.is_view and name not in _NO_BYTES:
                ins = [t for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
        if self.ops is not None:
            self.ops.append({
                "op": str(func),
                "shapes": [list(t.shape) for t in outs],
                "dtypes": [str(t.dtype).replace("torch.", "") for t in outs],
                "flops": flops})
        return out

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _caller() -> str:
    """The innermost frame of the port outside the dry run: where a host
    read was asked for."""
    here = os.path.abspath(__file__)
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if f"{os.sep}repro_torch{os.sep}" in path and path != here:
            return f"{path[path.rindex('repro_torch'):]}:{f.f_lineno}"
        f = f.f_back
    return "?"


def dryrun_program(arch: str, shape: ShapeSpec, mesh, *,
                   agg_mode: str = "dense_psum",
                   compressor: str = DRYRUN_COMPRESSOR,
                   trainer: str = "shard_map", device="meta", group=None,
                   config=None):
    """One rank's program of ``arch`` at ``shape`` on ``mesh``: (args, run,
    note, cfg), ``args`` the trees it holds ({"params", "m", "v", "h",
    "h_avg", "batch"} for train, {"params", "batch"} for prefill,
    {"params", "cache", "token", "pos"} for decode), ``run()`` the step
    (JAX's ``build_lowered``: the train step at JAX's defaults -- AdamW on
    cosine(3e-4, 10000, 200), EF-BV tuned at d = d_model * d_ff, the
    ``trainer`` and ``agg_mode`` -- the prefill forward, or the decode step
    and its argmax); (None, None, skip reason, None) where JAX skips.  On
    ``meta`` the params are shapes only; elsewhere (the card) the init at
    ``random.key(0)``.  ``group``: this rank's WorkerGroup on the mesh (None
    on one rank)."""
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.efbv import EFBV
    from repro_torch.train.trainer import (init_train_state,
                                           make_train_step,
                                           make_train_step_fsdp)

    cfg, note = adapt_config(config or get_config(arch), shape)
    if cfg is None:
        return None, None, note, None
    dev = resolve_device(device)
    model = build_model(cfg)
    n = num_workers(mesh)
    tp = None if group is None else group.model
    params = model.init_abstract() if dev.type == "meta" \
        else model.init(random.key(0), device=dev)
    if shape.kind == "train":
        logical = model.init_abstract()
        if trainer == "fsdp":
            shards = make_fsdp_shards(group, mesh, model.param_specs(),
                                      logical)
        else:
            shards = None if tp is None else ModelShards.of(
                tp, model.param_specs(), logical)
        if shards is not None:
            params = shards.shard_tree(params)
        opt = adamw(cosine(3e-4, total_steps=10_000, warmup_steps=200))
        comp = make_compressor(compressor)
        algo = EFBV.make(comp, d=cfg.d_model * cfg.d_ff if cfg.d_ff
                         else cfg.d_model ** 2, n=n, mode="efbv")
        state = init_train_state(params, opt, n_workers=n, algo=algo,
                                 agg_mode=agg_mode, group=group,
                                 shards=shards)
        del params
        make = make_train_step_fsdp if trainer == "fsdp" else make_train_step
        loss_fn = model.loss if tp is None else functools.partial(
            model.loss, tp=tp)
        step_fn = make(loss_fn, opt, algo, n_workers=n, agg_mode=agg_mode,
                       group=group, shards=shards)
        rows = batch_struct(cfg, shape, mesh, dev)
        workers = range(n) if group is None else group.workers
        lo = workers[0] * (shape.global_batch // n)
        # the global batch, of which the step copies this rank's rows
        batch = {k: torch.zeros((shape.global_batch,) + tuple(v.shape[1:]),
                                dtype=v.dtype, device=dev)
                 for k, v in rows.items()}
        key = random.fold_in(random.key(0), 0)
        args = {"params": state.params, "m": state.opt_state["m"],
                "v": state.opt_state["v"], "h": state.h,
                "h_avg": state.h_avg,
                "batch": {k: v[lo:lo + rows[k].shape[0]]
                          for k, v in batch.items()}}
        return args, lambda: step_fn(state, batch, key), note, cfg
    if tp is not None:
        params = ModelShards.of(tp, model.param_specs(),
                                model.init_abstract()).shard_tree(params)
    if shape.kind == "prefill":
        batch = batch_struct(cfg, shape, mesh, dev)

        def run():
            with torch.no_grad():
                return model.forward(params, batch, tp)[:, -1]
        return {"params": params, "batch": batch}, run, note, cfg
    cache, token, pos = decode_structs(cfg, shape, mesh, model, tp, dev)

    def run():
        logits, new = model.decode_step(params, cache, token, pos, tp)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return ({"params": params, "cache": cache, "token": token, "pos": pos},
            run, note, cfg)


def dryrun_group(mesh, rank: int = 0):
    """Rank ``rank``'s WorkerGroup of ``mesh`` over torch's fake process
    group (``aggregate.DRYRUN_BACKEND``: every collective returns at once,
    moving nothing), on the ``meta`` device; None for a one-rank mesh."""
    import math as _math
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = _math.prod(mesh.devices_shape)
    if world == 1:
        return None
    from repro_torch.distributed.aggregate import DRYRUN_BACKEND

    return WorkerGroup.join(num_workers(mesh), backend=DRYRUN_BACKEND,
                            device="meta", model_size=model_size(mesh),
                            rank=rank, world=world, store=FakeStore())


def mesh_label(mesh) -> str:
    return "x".join(str(x) for x in mesh.devices_shape)


def dryrun_one(arch: str, shape, *, multi_pod: bool = False, mesh=None,
               agg_mode: str = "dense_psum",
               compressor: str = DRYRUN_COMPRESSOR,
               trainer: str = "shard_map", hlo_dir: str = "",
               verbose: bool = True, execute: bool = True,
               config=None) -> dict:
    """JAX's ``run_one`` for one (arch, shape, mesh): the record of rank 0's
    program on the ``meta`` device (:func:`dryrun_program`) over the fake
    process group of the production mesh (or ``mesh``; ``shape`` a name of
    :data:`SHAPES` or a :class:`ShapeSpec`).  The record has JAX's keys,
    ``build_s`` and ``run_s`` in place of ``lower_s`` and ``compile_s``;
    ``memory``: the per-rank bytes of the arguments (``trees``: each state
    tree, the batch or cache), of the outputs, and the peak of the storages
    the program allocates while live (``temp_size_in_bytes``); ``roofline``:
    the per-rank flops, bytes and collective bytes by kind, each over the
    H100's data-sheet peak.  ``execute=False`` builds the arguments only.
    ``hlo_dir`` keeps each run's op trace gzipped (JSON lines: op, shapes,
    dtypes, flops).  ``config`` replaces the arch's full config (a smoke
    config, say)."""
    from repro_torch.distributed.aggregate import make_production_mesh

    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_label(mesh),
           "agg_mode": agg_mode, "compressor": compressor,
           "trainer": trainer}
    t0 = time.time()
    group = None
    try:
        group = dryrun_group(mesh)
        cfg0 = config or get_config(arch)
        args, run, note, cfg = dryrun_program(
            arch, shape, mesh, agg_mode=agg_mode, compressor=compressor,
            trainer=trainer, group=group, config=config)
        rec.update({"note": note, "n_workers": num_workers(mesh),
                    "n_devices": int(np.prod(mesh.devices_shape)),
                    "params": cfg0.param_count(),
                    "active_params": cfg0.active_param_count()})
        if args is None:
            rec["status"] = "skipped"
            rec["skip"] = note
            return rec
        trees = {k: tree_bytes(v) for k, v in args.items()}
        arg_bytes = sum(trees.values())
        rec["build_s"] = round(time.time() - t0, 2)
        if not execute:
            rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                             "trees": trees}
            rec["status"] = "built"
            return rec
        t1 = time.time()
        trace = MetaTrace(record=bool(hlo_dir))
        trace.exclude(args)
        with kernels.dry_run(), trace:
            out = run()
            out_bytes = tree_bytes(out)
            del out
        rec["run_s"] = round(time.time() - t1, 2)
        rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                         "output_size_in_bytes": out_bytes,
                         "temp_size_in_bytes": trace.peak,
                         "trees": trees}
        t_c = trace.flops / H100_BF16_FLOPS
        t_m = trace.bytes / H100_HBM_BYTES_PER_S
        coll = sum(trace.coll.values())
        t_x = coll / H100_NVLINK_BYTES_PER_S
        terms = {"compute": t_c, "memory": t_m, "collective": t_x}
        rec["roofline"] = {
            "flops_per_rank": trace.flops, "bytes_per_rank": trace.bytes,
            "coll_bytes_per_rank": coll,
            "coll_breakdown": dict(trace.coll),
            "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
            "bottleneck": max(terms, key=terms.get),
            "peaks": {"bf16_flops_per_s": H100_BF16_FLOPS,
                      "hbm_bytes_per_s": H100_HBM_BYTES_PER_S,
                      "nvlink_bytes_per_s_one_way": H100_NVLINK_BYTES_PER_S,
                      "source": "H100 SXM5 80GB data sheet; not measured"}}
        rec["host_reads_skipped"] = dict(trace.host_reads)
        if hlo_dir:
            import gzip
            os.makedirs(hlo_dir, exist_ok=True)
            fname = (f"{arch}_{shape.name}_{rec['mesh']}_{agg_mode}"
                     ".ops.jsonl.gz")
            with gzip.open(os.path.join(hlo_dir, fname), "wt") as gz:
                for op in trace.ops:
                    gz.write(json.dumps(op) + "\n")
        rec["status"] = "ok"
        if verbose:
            m = rec["memory"]
            print(f"[dryrun] {arch:22s} {shape.name:12s} {rec['mesh']:8s} OK "
                  f"build={rec['build_s']:.1f}s run={rec['run_s']:.1f}s "
                  f"bottleneck={rec['roofline']['bottleneck']} "
                  f"args={m['argument_size_in_bytes'] / 2**30:.2f}GiB "
                  f"temp={m['temp_size_in_bytes'] / 2**30:.2f}GiB")
    except Exception as e:  # noqa: BLE001 -- recorded, as JAX's run_one
        import traceback
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[dryrun] {arch:22s} {shape.name:12s} {rec['mesh']:8s} "
                  f"FAIL {rec['error'][:200]}")
            traceback.print_exc(limit=6)
    finally:
        if group is not None:
            group.close()
    return rec


def parse_dryrun_args(argv=None):
    """The flags of JAX's ``launch/dryrun.py`` (same names and defaults)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train dryrun",
        description="multi-pod dry run: one rank's program of every (arch x "
                    "shape x mesh) on the meta device, with roofline terms")
    ap.add_argument("--arch", default="all", help=f"one of {ARCHS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--agg", default="dense_psum")
    ap.add_argument("--compressor", default=DRYRUN_COMPRESSOR)
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--hlo-dir", default="",
                    help="keep each combination's op trace (gzipped JSON "
                         "lines: op, shapes, dtypes, flops); a torch step has "
                         "no HLO")
    return ap.parse_args(argv)


def dryrun_main(argv=None) -> list:
    """``python -m repro_torch.launch.train dryrun``: JAX's dry-run
    ``main``; appends a JSON record a combination to ``--out``."""
    args = parse_dryrun_args(argv)
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    recs = []
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = dryrun_one(arch, shape, multi_pod=mp,
                                     agg_mode=args.agg,
                                     compressor=args.compressor,
                                     hlo_dir=args.hlo_dir)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    recs.append(rec)
    return recs

if __name__ == "__main__":
    main()
