"""End-to-end training driver of the port (``repro/launch/train.py``).

Examples (one GPU, full-width qwen2-0.5b, two workers): block-top-k up,
dense broadcast down; QSGD both ways; rand-k up (DIANA-style variance
reduction with ``--algo efbv``); and the pipelined (one-round-stale)
schedule with block-top-k up and QSGD down:

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
(``rank_device``).  Rank 0 prints.  ``--workers`` takes the place of the
JAX driver's ``--mesh``.  Step s runs under the key ``fold_in(key(seed),
s)``, as in the JAX driver.  It runs on ``cuda`` unless ``--device cpu``
is given.  Flags of the JAX driver that this port does not have yet are
parsed and refused with a "not yet ported" error, never ignored; so are
the zoo compressors whose training rounds are not yet ported
(``TRAIN_COMPRESSORS``).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import random, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.compressors import Identity, make_compressor
from repro_torch.core.efbv import EFBV, Downlink, Participation, Pipeline
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.distributed import wire
from repro_torch.distributed.aggregate import BACKENDS, Pending, WorkerGroup
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine
from repro_torch.train.trainer import init_train_state, make_train_step

# JAX-driver flags not yet ported, with the value that asks for nothing
# beyond the port (any other value is refused)
NOT_PORTED_FLAGS = {
    "--spec": "", "--mesh": "", "--worker-comps": "", "--leaf-codecs": "",
    "--trainer": "shard_map", "--ckpt-dir": "", "--ckpt-every": 0,
    "--sanitize": False,
}
#: the --compressor families the trainer runs; the rest of the zoo is
#: ported as compressors and wire codecs, but its training rounds are not
#: yet held against the JAX trainer (ROADMAP queue 3)
TRAIN_COMPRESSORS = ("block_topk", "qsgd", "randk", "identity", "none")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--workers", type=int, default=2,
                    help="EF-BV workers, run one after another on the device "
                         "(over torchrun's ranks: n/P on each)")
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
                    help="auto = cosine for every ported arch; wsd is not "
                         "yet ported")
    ap.add_argument("--algo", default="efbv",
                    choices=["efbv", "ef21", "diana", "none"])
    ap.add_argument("--compressor", default="block_topk:256,16")
    ap.add_argument("--agg", default="dense_psum",
                    choices=["dense_psum", "sparse_allgather"])
    ap.add_argument("--downlink", default="",
                    help="compress the master -> worker broadcast: "
                         "'qsgd:S[@lam]' ('' = dense broadcast)")
    ap.add_argument("--participation", default="full",
                    help="full | bernoulli:p | fixed:s (federated mode: "
                         "absent workers send a decode-zero message and "
                         "keep h_i stale)")
    ap.add_argument("--pipeline", default="off",
                    help="'off' | 'depth:0' | 'depth:1' (the master applies "
                         "the previous round's messages)")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--local-batch-resample", action="store_true")
    ap.add_argument("--shard-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--heterogeneity", type=float, default=0.5)
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
    if args.schedule == "wsd":
        ap.error("--schedule wsd is not yet ported to repro_torch")
    name = args.compressor.partition(":")[0]
    if name not in TRAIN_COMPRESSORS:
        ap.error(f"--compressor {name} is not yet ported to repro_torch's "
                 f"trainer (it trains {', '.join(TRAIN_COMPRESSORS)}; see "
                 "ROADMAP queue 3)")
    if args.wire_dtype != "float32":
        ap.error(f"--wire-dtype {args.wire_dtype} is not yet ported to "
                 "repro_torch (float32 only)")
    try:
        Downlink.parse(args.downlink)
    except (NotImplementedError, ValueError) as e:
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
    return args


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


def join_group(args):
    """This rank's WorkerGroup under ``torchrun`` (None in one process)."""
    if world_size() <= 1:
        return None
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    dev = rank_device(args.device, args.dist_backend,
                      int(os.environ.get("LOCAL_RANK", "0")), local_world,
                      torch.cuda.device_count())
    return WorkerGroup.join(args.workers, backend=args.dist_backend,
                            device=resolve_device(dev),
                            init_method=args.dist_init or None)


def tuning_dim(cfg) -> int:
    """The tuning dimension of an arch: its dominant layer size (the JAX
    driver's rule, so both drivers tune the same (lam, nu))."""
    return max(cfg.d_model * max(cfg.d_ff, 1), 1)


def _quiet(*args, **kwargs):
    """Ranks other than 0 print nothing."""


def setup(args, group=None):
    """Model, schedule, EF-BV tuning, params, state, data and step function
    for the parsed flags; prints the run header and the wire accounting
    (rank 0 of a ``group``).  Returns (state, step_fn, data); step s takes
    the key ``random.fold_in(random.key(args.seed), s)``."""
    echo = print if group is None or group.rank == 0 else _quiet
    dev = group.device if group is not None else resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    n = args.workers
    pipeline = Pipeline.parse(args.pipeline)
    participation = Participation.parse(args.participation)
    federated = not participation.is_full

    # the JAX driver's auto schedule is cosine for every arch but minicpm
    sched = cosine(args.lr, total_steps=args.steps,
                   warmup_steps=max(args.steps // 20, 1))
    opt = adamw(sched, weight_decay=0.01)

    if args.algo == "none":
        algo = EFBV(Identity(), lam=1.0, nu=1.0)
    else:
        algo = EFBV.make(make_compressor(args.compressor), d=tuning_dim(cfg),
                         n=n, mode=args.algo,
                         pipeline=pipeline.depth or None)
    downlink = Downlink.parse(args.downlink)
    echo(f"[train] arch={cfg.name} family={cfg.family} "
         f"params~{cfg.param_count():,} workers={n} algo={args.algo} "
         f"lam={algo.lam:.4g} nu={algo.nu:.4g} agg={args.agg}"
         + (f" participation={args.participation}" if federated else "")
         + (f" pipeline={args.pipeline}" if not pipeline.is_off else "")
         + (f" downlink={args.downlink}" if downlink else "")
         + (f" ranks={group.world} backend={group.backend}"
            if group is not None else "")
         + f" device={dev}")

    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    up_fmt = wire.format_for(algo.compressor, params) \
        if args.agg == "sparse_allgather" else None
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
    if downlink is not None:
        # the broadcast payload is real whatever the uplink carries; the
        # total prints as an exact integer (the JAX driver rounds it, :g)
        dfmt = downlink.format_for(params)
        down, dense = dfmt.downlink_bits_per_round(), dfmt.dense_bits()
        total = wire.total_round_bits(up_fmt, dfmt, n_workers=n,
                                      participants=exp_s) \
            if up_fmt is not None else n * dense + down
        dense_total = n * dense + dense
        echo(f"[train] wire: downlink {down} bits/round broadcast "
             f"({down / max(dense, 1):.4f}x dense fp32); total "
             f"{total} bits/round up+down "
             f"({total / max(dense_total, 1):.4f}x dense both ways)")
    state = init_train_state(params, opt, n_workers=n,
                             bidirectional=downlink is not None, algo=algo,
                             agg_mode=args.agg, wire_dtype=args.wire_dtype,
                             pipeline=pipeline, group=group)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.global_batch, n_workers=n,
                       seed=args.seed, heterogeneity=args.heterogeneity,
                       resample_from_shard=args.local_batch_resample,
                       shard_size=args.shard_size)
    step_fn = make_train_step(model.loss, opt, algo, n_workers=n,
                              agg_mode=args.agg, wire_dtype=args.wire_dtype,
                              downlink=downlink, pipeline=pipeline,
                              participation=participation, group=group)
    return state, step_fn, data


def main(argv=None):
    args = parse_args(argv)
    group = join_group(args)
    try:
        return run(args, group)
    finally:
        if group is not None:
            group.close()


def run(args, group=None):
    """The training loop of ``main`` on a joined group (or None); returns
    the final loss."""
    echo = print if group is None or group.rank == 0 else _quiet
    state, step_fn, data = setup(args, group)
    n = args.workers
    key = random.key(args.seed)
    t_start = time.time()
    for step in range(args.steps):
        state, metrics = step_fn(state, data.batch(step),
                                 random.fold_in(key, step))
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            part = f"|S|={int(m['participants'])}/{n} " \
                if "participants" in m else ""
            echo(f"[train] step {step:5d} loss={m['loss']:.4f} "
                 f"|g|={m['g_norm']:.3f} |upd|={m['update_norm']:.4f} "
                 f"h_res={m['h_residual']:.3f} {part}"
                 f"({(time.time() - t_start) / (step + 1):.2f}s/step)")
    if group is not None:
        if isinstance(state.inflight, Pending):
            # the last round's exchange, which a next round would apply:
            # drained before the group closes
            state.inflight.wait()
        st = group.stats
        echo(f"[train] exchange: ranks={group.world} "
             f"backend={group.backend} {st['exchanges']} exchanges, "
             f"{st['bytes'] // max(st['exchanges'], 1)} B per rank per "
             f"round, {1e3 * st['exchange_s'] / max(args.steps, 1):.2f} ms "
             "host time in the collective (wait() when pipelined) per step "
             "on rank 0")
    echo(f"[train] done: final loss {float(metrics['loss']):.4f}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
