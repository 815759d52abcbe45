"""A 3-step, 2-worker EF-BV smoke round in both packages, from the same
params, the same batches and the same step keys: block-top-k up with a
dense broadcast, QSGD(16) both ways (the bidirectional round), rand-k
up (randk:4096) with a dense broadcast, and the pipelined (depth:1)
round with block-top-k up and QSGD(16) down.

The JAX round is assembled from its public pieces (``model.loss``,
``compress_local``, ``combine_global``, ``adamw``, ``broadcast_global``,
and for the pipelined round ``init_inflight``), jitted, on one device,
with the JAX trainer's keys (worker i compresses under
``fold_in(step_key, i)``, the downlink under
``downlink_key(step_key)``) and gradients at w; the port's is
``train.trainer.make_train_step``.  Tolerances:

* f32 activations: per-step loss rtol 1e-5; after three steps fewer than
  0.1% of the params differ by more than 1e-5, and none by more than
  3 lr = 9e-4.  Matmul sums differ in order, so gradients differ in their
  last bits; block-top-k can then pick the other value of a near-tie,
  which AdamW turns into an update of about lr at that coordinate.
* bf16 activations: loss atol 1e-2 (bf16 rounds at different points in
  the two frameworks).
* The same for the QSGD round: its uniforms are bit-equal, but the norms
  differ in their last bits (torch and XLA reduce in different orders) and
  so do the gradients, so now and then a level rounds the other way.
* The same for the rand-k round: its positions are bit-equal; the JAX
  round's h update is its jitted oracle's FMA (fault (f)), the port's the
  kernel's multiply then add, one ulp apart at most.
* The same for the pipelined round, which applies round t-1's messages
  (the decode-zero priming payload at round 0) and otherwise differs from
  the bidirectional round only in its uplink codec.

Bits per round are exact, and ``SyntheticLM`` batches identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import compressors as jcomp
from repro.core.efbv import EFBV as JEFBV
from repro.core.efbv import Downlink as JDownlink
from repro.core.efbv import downlink_key as jdownlink_key
from repro.data import SyntheticLM as JSyntheticLM
from repro.distributed import aggregate as jagg
from repro.distributed import wire as jwire
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply_updates
from repro.optim import cosine as jcosine
from repro.train.trainer import init_inflight as jinit_inflight
from repro_torch import random as R
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.core import compressors as tcomp
from repro_torch.core.efbv import EFBV, Downlink, Pipeline
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.distributed import wire as twire
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine
from repro_torch.train.trainer import init_train_state, make_train_step

N, STEPS, SEQ, BATCH = 2, 3, 16, 8
SMOKE_BITS = 5_776_384
SMOKE_QSGD_BITS = 11_553_216
SMOKE_RANDK_BITS = 2_244_608
SMOKE_QSGD_DOWN_BITS = 11_553_216
SEED = 0
#: uplink compressor of each round; the QSGD and the pipelined ones have a
#: QSGD(16) downlink
SPECS = {"block_topk": "block_topk:256,16", "qsgd": "qsgd:16",
         "randk": "randk:4096", "pipelined": "block_topk:256,16"}
BIDIRECTIONAL = ("qsgd", "pipelined")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread, for the reason test_torch_model.py's
    copy gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_round(jcfg, params, batches, lam, nu, kind="block_topk"):
    model = jbuild_model(jcfg)
    bidirectional = kind in BIDIRECTIONAL
    pipelined = kind == "pipelined"
    algo = JEFBV(jcomp.make_compressor(SPECS[kind]), lam=lam, nu=nu)
    downlink = JDownlink(jcomp.QSGD(16)) if bidirectional else None
    opt = jadamw(jcosine(3e-4, total_steps=STEPS, warmup_steps=1),
                 weight_decay=0.01)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    # the pipelined trainer's un-vmapped workers pack with stream=True
    local = jax.jit(lambda k, g, h: jagg.compress_local(
        algo, k, g, h, mode="sparse_allgather", stream=pipelined))
    chunks = jwire.pipeline_chunks(N) if pipelined else 1
    combine = jax.jit(lambda m, ha: jagg.combine_global(
        algo, m, ha, n_workers=N, mode="sparse_allgather", chunks=chunks))
    broadcast = jax.jit(lambda k, x, w: jagg.broadcast_global(
        downlink, jdownlink_key(k), x, w)[0])
    key = jax.random.key(SEED)

    @jax.jit
    def optimize(g, opt_state, params):
        updates, opt_state = opt.update(g, opt_state, params)
        return japply_updates(params, updates), opt_state

    zeros = jax.tree.map(jnp.zeros_like, params)
    hs, h_avg, opt_state = [zeros] * N, zeros, opt.init(params)
    w = params
    inflight = jinit_inflight(algo, params, N, agg_mode="sparse_allgather") \
        if pipelined else None
    losses = []
    for step, batch in enumerate(batches):
        step_key = jax.random.fold_in(key, step)
        per = BATCH // N
        msgs, step_losses = [], []
        for i in range(N):
            bi = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, grads = grad_fn(w if bidirectional else params, bi)
            msg, hs[i] = local(jax.random.fold_in(step_key, i),
                               jax.tree.map(lambda a: a.astype(jnp.float32),
                                            grads), hs[i])
            msgs.append(msg)
            step_losses.append(float(loss))
        stacked = jax.tree.map(lambda *x: jnp.stack(x), *msgs)
        g, h_avg = combine(inflight if pipelined else stacked, h_avg)
        if pipelined:
            inflight = stacked
        params, opt_state = optimize(g, opt_state, params)
        if bidirectional:
            w = broadcast(step_key, params, w)
        losses.append(float(np.mean(step_losses)))
    return losses, params


def _torch_round(tcfg, params_np, batches, lam, nu, kind="block_topk"):
    model = build_model(tcfg)
    bidirectional = kind in BIDIRECTIONAL
    pipeline = Pipeline(1) if kind == "pipelined" else None
    algo = EFBV(tcomp.make_compressor(SPECS[kind]), lam=lam, nu=nu)
    opt = adamw(cosine(3e-4, total_steps=STEPS, warmup_steps=1),
                weight_decay=0.01)
    state = init_train_state(T.params_from_jax(params_np, "cpu"), opt,
                             n_workers=N, bidirectional=bidirectional,
                             algo=algo, agg_mode="sparse_allgather",
                             pipeline=pipeline)
    step = make_train_step(
        model.loss, opt, algo, n_workers=N, agg_mode="sparse_allgather",
        downlink=Downlink(tcomp.QSGD(16)) if bidirectional else None,
        pipeline=pipeline)
    key = R.key(SEED)
    losses = []
    for s, batch in enumerate(batches):
        state, metrics = step(state, batch, R.fold_in(key, s))
        losses.append(float(metrics["loss"]))
    return losses, state


def _both_rounds(adt, kind):
    jcfg = dataclasses.replace(jget_smoke_config("qwen2-0.5b"),
                               activation_dtype=adt)
    tcfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                               activation_dtype=adt)
    params_np = jax.tree.map(
        np.asarray, jbuild_model(jcfg).init(jax.random.key(0)))
    data = SyntheticLM(vocab=jcfg.vocab, seq_len=SEQ, global_batch=BATCH,
                       n_workers=N, seed=0)
    batches = [data.batch(s) for s in range(STEPS)]
    # lam != 1 so the h updates' rounding is exercised
    lam, nu = 0.37, 0.61
    jl, jparams = _jax_round(jcfg, params_np, batches, lam, nu, kind)
    tl, state = _torch_round(tcfg, params_np, batches, lam, nu, kind)
    return jl, jparams, tl, state


def _assert_round_close(adt, jl, jparams, tl, state):
    assert state.step == STEPS and all(np.isfinite(tl))
    if adt == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        diff = np.concatenate([
            np.abs(b.numpy() - np.asarray(a)).reshape(-1) for a, b in
            zip(jax.tree.leaves(jparams), T.leaves(state.params))])
        assert np.mean(diff > 1e-5) < 1e-3 and diff.max() <= 9e-4
    else:
        np.testing.assert_allclose(tl, jl, atol=1e-2)


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_smoke_round_matches_jax(adt):
    _assert_round_close(adt, *_both_rounds(adt, "block_topk"))


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_bidirectional_smoke_round_matches_jax(adt):
    """QSGD(16) up and down: gradients at w, the broadcast after AdamW."""
    jl, jparams, tl, state = _both_rounds(adt, "qsgd")
    _assert_round_close(adt, jl, jparams, tl, state)
    assert state.w is not None
    assert all(not torch.equal(a, b) for a, b in
               zip(T.leaves(state.w), T.leaves(state.params)))


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_randk_smoke_round_matches_jax(adt):
    """rand-k (DIANA-style, unbiased) up, dense broadcast down."""
    _assert_round_close(adt, *_both_rounds(adt, "randk"))


def test_bits_per_round_exact_in_both_packages():
    jtree = jbuild_model(jget_smoke_config("qwen2-0.5b")).init_abstract()
    ttree = build_model(get_smoke_config("qwen2-0.5b")).init_abstract()
    jbits = jwire.format_for(jcomp.BlockTopK(256, 16), jtree).bits_per_round()
    tbits = twire.format_for(tcomp.BlockTopK(256, 16), ttree).bits_per_round()
    assert jbits == tbits == SMOKE_BITS


@pytest.mark.parametrize("seed,resample", [(0, False), (5, False), (1, True)])
def test_synthetic_batches_identical(seed, resample):
    kw = dict(vocab=1024, seq_len=24, global_batch=8, n_workers=2, seed=seed,
              heterogeneity=0.5, resample_from_shard=resample, shard_size=16)
    j, t = JSyntheticLM(**kw), SyntheticLM(**kw)
    for step in (0, 1, 7):
        jb, tb = j.batch(step), t.batch(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


def test_schedule_and_tuning_match_jax():
    """The port's warmup-cosine lr equals ``jax.jit(schedule)``, the lr of
    JAX's jitted optimizer step (ROADMAP fault x), at chosen steps."""
    jsched = jax.jit(jcosine(3e-4, total_steps=50, warmup_steps=2))
    tsched = cosine(3e-4, total_steps=50, warmup_steps=2)
    for s in (0, 1, 2, 3, 25, 49, 60):
        assert tsched(s) == float(jsched(jnp.asarray(s, jnp.int32)))


def test_cli_smoke_run_prints_exact_bits(capsys):
    loss = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--workers", "2",
                         "--steps", "2", "--global-batch", "4", "--seq", "16",
                         "--compressor", "block_topk:256,16",
                         "--agg", "sparse_allgather", "--device", "cpu",
                         "--log-every", "1"])
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert f" {SMOKE_BITS} bits/round/worker" in out
    assert out.count("[train] step") == 2


def test_cli_bidirectional_smoke_prints_exact_bits(capsys):
    loss = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--workers", "2",
                         "--steps", "2", "--global-batch", "4", "--seq", "16",
                         "--compressor", "qsgd:16", "--agg",
                         "sparse_allgather", "--downlink", "qsgd:16",
                         "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert f" {SMOKE_QSGD_BITS} bits/round/worker uplink" in out
    assert f"downlink {SMOKE_QSGD_BITS} bits/round broadcast" in out
    assert f"total {3 * SMOKE_QSGD_BITS} bits/round up+down" in out
    assert out.count("[train] step") == 2


def test_cli_randk_smoke_prints_exact_bits(capsys):
    loss = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--workers", "2",
                         "--steps", "2", "--global-batch", "4", "--seq", "16",
                         "--compressor", "randk:4096", "--algo", "efbv",
                         "--agg", "sparse_allgather", "--device", "cpu",
                         "--log-every", "1"])
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert f"codec=randk_sparse {SMOKE_RANDK_BITS} bits/round/worker " \
        "uplink" in out and "0.0486x dense fp32" in out
    assert out.count("[train] step") == 2


@pytest.mark.parametrize("compressor", ["block_topk:256,16", "qsgd:16",
                                        "randk:4096", "pipelined"])
def test_cli_run_leaves_no_tensor_in_reference_cycles(compressor, capsys):
    """Every tensor a run allocates is freed by reference counting: none
    waits in a reference cycle for the garbage collector (a cycle would
    keep whole trees of transients alive and raise the peak memory).
    ``pipelined``: block-top-k up, QSGD(16) down, ``--pipeline depth:1``."""
    import gc
    pipelined = compressor == "pipelined"
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "2", "--steps",
            "2", "--global-batch", "4", "--seq", "16", "--compressor",
            SPECS[compressor] if pipelined else compressor, "--agg",
            "sparse_allgather", "--device", "cpu"]
    if compressor.startswith("qsgd") or pipelined:
        argv += ["--downlink", "qsgd:16"]
    if pipelined:
        argv += ["--pipeline", "depth:1"]
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        tlaunch.main(argv)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    capsys.readouterr()
    assert cyclic == []


@pytest.mark.parametrize("flag", [
    ["--downlink", "block_topk:256,16"], ["--leaf-codecs", "*embed*=qsgd:16"],
    ["--worker-comps", "topk:64;randk:64"], ["--trainer", "fsdp"],
    ["--ckpt-every", "2"], ["--compressor", "sign"],
    ["--wire-dtype", "bfloat16"],
    ["--schedule", "wsd"], ["--ckpt-dir", "ckpt"], ["--sanitize"]])
def test_cli_refuses_unported_flags(flag, capsys):
    """Every flag of the JAX driver is ported and parses as JAX's does: a
    non-QSGD downlink, per-leaf codecs, a worker fleet, every zoo
    compressor, bf16/f16 wires, checkpoints, the WSD schedule, the fsdp
    trainer and, since the twentieth slice, ``--sanitize``; no flag exits
    with "not yet ported"."""
    if flag[0] in ("--downlink", "--leaf-codecs", "--worker-comps",
                   "--compressor", "--wire-dtype", "--ckpt-dir",
                   "--ckpt-every", "--schedule", "--trainer"):
        args = tlaunch.parse_args(["--smoke", "--device", "cpu", *flag])
        assert str(getattr(args, flag[0][2:].replace("-", "_"))) == flag[1]
        assert "not yet ported" not in capsys.readouterr().err
        return
    args = tlaunch.parse_args(["--smoke", "--device", "cpu", *flag])
    assert args.sanitize is True
    assert "not yet ported" not in capsys.readouterr().err


# -- the pipelined schedule ---------------------------------------------------

@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_pipelined_smoke_round_matches_jax(adt):
    """depth:1 with block-top-k up and QSGD(16) down: the JAX round applies
    ``init_inflight``'s priming payload at round 0 and round t-1's stacked
    messages after it; the port's step does the same."""
    jl, jparams, tl, state = _both_rounds(adt, "pipelined")
    _assert_round_close(adt, jl, jparams, tl, state)
    assert state.inflight is not None and len(state.inflight) == len(
        T.leaves(state.params))


def _port_run(agg, pipeline, steps=2, downlink=True):
    """``steps`` port steps on the f32 smoke config (block-top-k up, QSGD(16)
    down when ``downlink``), from params of a fixed seed; returns the
    states after each step and the metrics."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              activation_dtype="float32")
    model = build_model(cfg)
    algo = EFBV(tcomp.BlockTopK(256, 16), lam=0.37, nu=0.61)
    opt = adamw(cosine(3e-4, total_steps=STEPS, warmup_steps=1),
                weight_decay=0.01)
    params = model.init(R.key(3), device="cpu")
    down = Downlink(tcomp.QSGD(16)) if downlink else None
    state = init_train_state(params, opt, n_workers=N,
                             bidirectional=downlink, algo=algo,
                             agg_mode=agg, pipeline=pipeline)
    step = make_train_step(model.loss, opt, algo, n_workers=N, agg_mode=agg,
                           downlink=down, pipeline=pipeline)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                       n_workers=N, seed=0)
    states, metrics = [], []
    for s in range(steps):
        state, m = step(state, data.batch(s), R.fold_in(R.key(SEED), s))
        # the step updates h in place: keep a copy of each step's state
        states.append(type(state)(*[T.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, f)
            for f in state]))
        metrics.append(m)
    return states, metrics


def _tree_bitwise(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    bits = lambda x: x.view(torch.int32) \
        if x.dtype == torch.float32 else x  # noqa: E731
    return len(la) == len(lb) and all(
        (x == y) if not isinstance(x, torch.Tensor) else
        (x.shape == y.shape and torch.equal(bits(x), bits(y)))
        for x, y in zip(la, lb))


def test_pipelined_round0_applies_zero_then_diverges():
    """Round 0 applies the decode-zero priming payload: g = h_avg0 + nu * 0
    is exactly zero and h_avg stays zero, while every worker's h advances
    on its own message exactly as in the sequential round.  From round 1
    the master applies round 0's messages, so the runs differ."""
    seq, seq_m = _port_run("sparse_allgather", None)
    pip, pip_m = _port_run("sparse_allgather", Pipeline(1))
    assert float(pip_m[0]["g_norm"]) == 0.0 < float(seq_m[0]["g_norm"])
    assert all(not x.any() for x in T.leaves(pip[0].h_avg))
    assert _tree_bitwise(pip[0].h, seq[0].h)
    assert float(pip_m[0]["loss"]) == float(seq_m[0]["loss"])
    assert not _tree_bitwise(pip[1].params, seq[1].params)
    assert float(pip_m[1]["g_norm"]) > 0.0


@pytest.mark.parametrize("agg", ["dense_psum", "sparse_allgather"])
def test_pipeline_depth0_equals_off_bitwise(agg):
    """``Pipeline(0)`` is the sequential step, bit for bit: every state
    leaf and every metric of two steps."""
    off, off_m = _port_run(agg, None, downlink=False)
    zero, zero_m = _port_run(agg, Pipeline(0), downlink=False)
    for a, b in zip(off, zero):
        assert a.inflight is None and b.inflight is None
        assert _tree_bitwise(a, b)
    for a, b in zip(off_m, zero_m):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_pipelined_state_needs_algo_and_inflight():
    params = {"w": torch.zeros(4, 8)}
    opt = adamw(cosine(3e-4, total_steps=2, warmup_steps=1))
    with pytest.raises(ValueError, match="algo"):
        init_train_state(params, opt, n_workers=N, pipeline=Pipeline(1))
    state = init_train_state(params, opt, n_workers=N)
    algo = EFBV(tcomp.BlockTopK(8, 2), lam=0.37, nu=0.61)
    step = make_train_step(lambda p, b: (p["w"].sum(), {}), opt, algo,
                           n_workers=N, pipeline=Pipeline(1))
    with pytest.raises(ValueError, match="pipeline"):
        step(state, {"tokens": np.zeros((2, 4), np.int32)}, R.key(0))


def test_cli_pipelined_smoke_prints_exact_bits(capsys):
    loss = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--workers", "2",
                         "--steps", "2", "--global-batch", "4", "--seq", "16",
                         "--compressor", "block_topk:256,16", "--agg",
                         "sparse_allgather", "--downlink", "qsgd:16",
                         "--pipeline", "depth:1", "--device", "cpu",
                         "--log-every", "1"])
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert " pipeline=depth:1 " in out
    assert f" {SMOKE_BITS} bits/round/worker uplink" in out
    assert f"downlink {SMOKE_QSGD_DOWN_BITS} bits/round broadcast" in out
    assert f"total {2 * SMOKE_BITS + SMOKE_QSGD_DOWN_BITS} bits/round " \
        "up+down" in out
    assert "step     0 loss=" in out and "|g|=0.000 " in out
    assert out.count("[train] step") == 2


@pytest.mark.parametrize("spec", ["depth:2", "async"])
def test_cli_refuses_bad_pipeline(spec, capsys):
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--smoke", "--device", "cpu", "--pipeline", spec])
    assert "--pipeline" in capsys.readouterr().err


# -- the fsdp trainer and the fine-tuning harness ----------------------------

import os  # noqa: E402

from repro.launch import finetune as jfinetune  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.core import ExperimentSpec as JSpec  # noqa: E402
from repro.core import SpecError as JSpecError  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.core import ExperimentSpec, SpecError  # noqa: E402
from repro_torch.core.efbv import Participation  # noqa: E402
from repro_torch.train.trainer import make_train_step_fsdp  # noqa: E402

SPECS_DIR = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "specs")
#: the one-process fsdp cases: (uplink, agg, downlink, pipeline,
#: participation)
FSDP_ONE = {
    "block_topk_qsgd_down": ("block_topk:256,16", "sparse_allgather",
                             "qsgd:16", None, None),
    "pipelined": ("block_topk:256,16", "sparse_allgather", "qsgd:16",
                  Pipeline(1), None),
    "federated": ("block_topk:256,16", "sparse_allgather", "", None,
                  "fixed:1"),
}


def _one_process_run(make, case, steps=2):
    comp, agg, down, pipeline, part = FSDP_ONE[case]
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              activation_dtype="float32")
    model = build_model(cfg)
    algo = EFBV(tcomp.make_compressor(comp), lam=0.37, nu=0.61)
    opt = adamw(cosine(3e-4, total_steps=STEPS, warmup_steps=1),
                weight_decay=0.01)
    state = init_train_state(model.init(R.key(3), device="cpu"), opt,
                             n_workers=N, bidirectional=bool(down),
                             algo=algo, agg_mode=agg, pipeline=pipeline)
    step = make(model.loss, opt, algo, n_workers=N, agg_mode=agg,
                downlink=Downlink.parse(down), pipeline=pipeline,
                participation=Participation.parse(part) if part else None)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                       n_workers=N, seed=0)
    metrics = []
    for s in range(steps):
        state, m = step(state, data.batch(s), R.fold_in(R.key(SEED), s))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("case", list(FSDP_ONE))
def test_fsdp_step_is_the_shard_map_step_in_one_process(case):
    """In one process nothing is sharded: the fsdp step is the shard_map
    step bit for bit, every state leaf and every metric of two steps
    (block-top-k up with QSGD down, pipelined, federated)."""
    a, am = _one_process_run(make_train_step, case)
    b, bm = _one_process_run(make_train_step_fsdp, case)
    assert _tree_bitwise(a, b) and am == bm
    if case == "federated":
        assert [m["participants"] for m in bm] == [1.0, 1.0]


def test_fsdp_step_matches_jax_fsdp_trainer():
    """The port's fsdp step against JAX's ``make_train_step_fsdp`` on a 1x1
    mesh (jitted, vmap over the one worker, FSDP shardings), block-top-k
    up and QSGD(16) down, f32 activations, three steps from JAX's weights:
    the file's f32 tolerances (loss rtol 1e-5; under 0.1% of the params
    more than 1e-5 apart, none more than 3 lr)."""
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.train import (fsdp_state_shardings as jfsdp_shardings,
                             init_train_state as jinit_state,
                             make_train_step_fsdp as jmake_fsdp)

    jcfg = dataclasses.replace(jget_smoke_config("qwen2-0.5b"),
                               activation_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                               activation_dtype="float32")
    jmodel, model = jbuild_model(jcfg), build_model(tcfg)
    params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    data = SyntheticLM(vocab=jcfg.vocab, seq_len=SEQ, global_batch=4,
                       n_workers=1, seed=0)
    lam, nu = 0.37, 0.61

    mesh = jmake_mesh((1, 1))
    jalgo = JEFBV(jcomp.BlockTopK(256, 16), lam=lam, nu=nu)
    jopt = jadamw(jcosine(3e-4, total_steps=STEPS, warmup_steps=1),
                  weight_decay=0.01)
    jstate = jinit_state(jax.tree.map(jnp.asarray, params_np), jopt, mesh,
                         bidirectional=True)
    sh = jfsdp_shardings(mesh, jmodel.param_specs(), jstate)
    jstate = jax.tree.map(jax.device_put, jstate, sh)
    jstep = jmake_fsdp(jmodel.loss, jopt, jalgo, mesh,
                       agg_mode="sparse_allgather",
                       downlink=JDownlink(jcomp.QSGD(16)))
    key = jax.random.key(SEED)
    jl = []
    for s in range(STEPS):
        jstate, m = jstep(jstate, data.batch(s), jax.random.fold_in(key, s))
        jl.append(float(m["loss"]))

    algo = EFBV(tcomp.BlockTopK(256, 16), lam=lam, nu=nu)
    opt = adamw(cosine(3e-4, total_steps=STEPS, warmup_steps=1),
                weight_decay=0.01)
    state = init_train_state(T.params_from_jax(params_np, "cpu"), opt,
                             n_workers=1, bidirectional=True, algo=algo,
                             agg_mode="sparse_allgather")
    step = make_train_step_fsdp(model.loss, opt, algo, n_workers=1,
                                agg_mode="sparse_allgather",
                                downlink=Downlink(tcomp.QSGD(16)))
    tl = []
    for s in range(STEPS):
        state, m = step(state, data.batch(s), R.fold_in(R.key(SEED), s))
        tl.append(float(m["loss"]))
    _assert_round_close("float32", jl, jstate.params, tl, state)


def test_trainer_fsdp_folds_into_the_spec_as_jax():
    """``--trainer fsdp`` is the spec's ``backend='fsdp'``, the JAX
    driver's fingerprint (``--workers 2`` is its ``--mesh 2x1``)."""
    flags = ["--arch", "qwen2-0.5b", "--smoke", "--compressor",
             "block_topk:256,16", "--agg", "sparse_allgather", "--downlink",
             "qsgd:16", "--steps", "3", "--trainer", "fsdp"]
    spec = tlaunch.spec_from_args(tlaunch.parse_args(
        flags + ["--device", "cpu", "--workers", "2"]), 2)
    jspec = jtrain.spec_from_args(jtrain.parse_args(flags + ["--mesh",
                                                             "2x1"]), 2)
    assert spec.backend == "fsdp"
    assert spec.fingerprint() == jspec.fingerprint()


def test_finetune_loop_matches_jax_loop():
    """All four stages on ``zoo_mamba2_fsdp.json`` at 1x1 (n = 1), two steps
    of batch 2 and seq 32, in both packages: the fingerprint, the round's
    bits and the eval stream's seed exactly JAX's, the final and eval
    losses within bf16's 1e-2 (the smoke config's activations); the
    staged prerequisite and both refusals with JAX's messages."""
    raw = open(os.path.join(SPECS_DIR, "zoo_mamba2_fsdp.json")).read()
    jspec = dataclasses.replace(JSpec.from_json(raw), mesh="1x1", n=1,
                                steps=2)
    spec = dataclasses.replace(ExperimentSpec.from_json(raw), mesh="1x1",
                               n=1, steps=2)
    kw = dict(global_batch=2, seq_len=32, eval_batches=1, log_every=1)
    jl = jloop.FinetuneLoop(jspec, jloop.FinetuneSettings(**kw),
                            verbose=False)
    tl = tlaunch.FinetuneLoop(spec, tlaunch.FinetuneSettings(**kw),
                              verbose=False, device="cpu")
    with pytest.raises(RuntimeError, match="setup"):
        tl.wire_report()
    want, got = jl.run(), tl.run()
    assert got["fingerprint"] == want["fingerprint"] == jspec.fingerprint()
    assert got["round_bits"] == want["round_bits"]
    assert (got["arch"], got["family"]) == (want["arch"], "ssm")
    np.testing.assert_allclose(
        [got["final_loss"], got["eval_loss"]],
        [want["final_loss"], want["eval_loss"]], atol=1e-2)
    assert tl.eval_data.seed == jl.eval_data.seed == \
        spec.seed ^ tlaunch.EVAL_SEED_XOR
    assert tl.data.seed == spec.seed
    assert [h["step"] for h in tl.history] == [2.0]
    for kw in (dict(compressor="topk:4", backend="reference",
                    problem="quadratic", d=32, n=2, steps=2),
               dict(compressor="topk:4", backend="shard_map",
                    problem="quadratic", d=32, n=1, mesh="1x1", steps=2)):
        with pytest.raises(JSpecError) as je:
            jloop.FinetuneLoop(JSpec(**kw))
        with pytest.raises(SpecError) as te:
            tlaunch.FinetuneLoop(ExperimentSpec(**kw), device="cpu")
        assert str(te.value) == str(je.value)


def test_finetune_cli_flags_equal_jax(capsys):
    """``repro_torch.launch.train finetune`` takes JAX's
    ``launch/finetune.py`` flags with the same defaults and values, and
    the port's device and process-group flags, ``--sanitize`` among them,
    and an unreadable spec exits with JAX's message."""
    spec = os.path.join(SPECS_DIR, "finetune_moe.json")
    extra = {"device": "cuda", "dist_backend": "", "dist_init": ""}
    for argv in (["--spec", spec],
                 ["--spec", spec, "--steps", "3", "--global-batch", "4",
                  "--seq", "64", "--lr", "0.002", "--schedule", "wsd",
                  "--eval-every", "2", "--eval-batches", "1",
                  "--log-every", "1", "--heterogeneity", "0.25",
                  "--shard-size", "16", "--processes", "2", "--ckpt-dir",
                  "ck", "--ckpt-every", "5"],
                 ["--spec", spec, "--sanitize"]):
        want = vars(jfinetune.parse_args(argv))
        got = vars(tlaunch.parse_finetune_args(argv))
        assert got == {**want, **extra}
    with pytest.raises(SystemExit, match=r"\[finetune\] bad experiment"):
        tlaunch.main(["finetune", "--spec", spec + ".missing"])


# -- the fine-tuning harness on a 2x2 mesh (a 'model' axis of 2) ------------

import json  # noqa: E402
import math  # noqa: E402

from conftest import run_with_devices  # noqa: E402

#: (spec file, backend, activation dtype) of each 2x2 fine-tune case: the
#: committed specs on ``"mesh": "2x2", "n": 2``, and the qwen2 one under
#: the shard_map trainer.  granite-moe runs its smoke config in f32: in
#: bf16 the two packages route a near-tied token to other experts (fault
#: z, measured by ``test_fault_z_moe_bf16_routes_flip_only_at_near_ties``),
#: and its losses part by up to 2.6e-2 already at 2x1 without a model axis
#: (final 7.4990 vs JAX's 7.5106, eval 7.4548 vs 7.4289), where in f32
#: they agree within 1e-6 (7.499927 vs 7.499926)
LOOP_2X2 = {"finetune_moe": ("finetune_moe", "fsdp", "float32"),
            "zoo_qwen2_fsdp": ("zoo_qwen2_fsdp", "fsdp", "bfloat16"),
            "zoo_qwen2_shard_map": ("zoo_qwen2_fsdp", "shard_map",
                                    "bfloat16")}
#: the losses' tolerance by activation dtype
LOOP_2X2_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
LOOP_2X2_KW = dict(global_batch=4, seq_len=32, eval_batches=1, log_every=1,
                   num_processes=2)
#: the steps each case trains of its spec's budget (the spec, and so its
#: fingerprint, unchanged: a truncated run, as ``finetune --steps 2``)
LOOP_2X2_STEPS = 2
#: the fingerprints of the committed fsdp specs on ``"mesh": "2x2", "n":
#: 2``, as ``chip_smoke.py`` runs them on the card
FSDP_SPECS_2X2 = {"finetune_moe": "3bf8fba981e36383",
                  "zoo_qwen2_fsdp": "14ee601318e673be"}


def _loop_2x2_specs():
    """Each case's spec as JSON: the committed file on a 2x2 mesh of two
    workers, the case's backend."""
    out = {}
    for case, (name, backend, _) in LOOP_2X2.items():
        raw = open(os.path.join(SPECS_DIR, f"{name}.json")).read()
        spec = dataclasses.replace(ExperimentSpec.from_json(raw),
                                   mesh="2x2", n=2, backend=backend)
        out[case] = spec.to_json()
    return out


_JAX_LOOP_2X2 = """
import dataclasses
import json
from repro.configs import get_smoke_config
from repro.core import ExperimentSpec
from repro.train import loop
out = {}
for case, raw in SPECS.items():
    spec = ExperimentSpec.from_json(raw)
    cfg = dataclasses.replace(get_smoke_config(spec.problem),
                              activation_dtype=ADT[case])
    fl = loop.FinetuneLoop(spec, loop.FinetuneSettings(**KW), config=cfg,
                           verbose=False)
    fl.setup().build_data().train(steps=STEPS)
    ev = fl.evaluate()
    out[case] = {"fingerprint": spec.fingerprint(),
                 "round_bits": fl.wire_report(),
                 "final_loss": fl._final["loss"], "eval_loss": ev,
                 "eval_seed": fl.eval_data.seed}
print("LOOP_2X2 " + json.dumps(out))
"""


def _loop_2x2_rank(store, specs):
    """One rank of four (2 processes x a model axis of 2): every case's
    FinetuneLoop on the same group, and its moe h's expert slabs."""
    from repro_torch.distributed.aggregate import WorkerGroup

    group = WorkerGroup.join(2, backend="gloo", device="cpu",
                             init_method=f"file://{store}/loop22",
                             model_size=2)
    out = {}
    try:
        for case, raw in specs.items():
            spec = ExperimentSpec.from_json(raw)
            cfg = dataclasses.replace(get_smoke_config(spec.problem),
                                      activation_dtype=LOOP_2X2[case][2])
            fl = tlaunch.FinetuneLoop(
                spec, tlaunch.FinetuneSettings(**LOOP_2X2_KW), config=cfg,
                verbose=False, group=group)
            fl.setup().build_data().train(steps=LOOP_2X2_STEPS)
            r = {"fingerprint": spec.fingerprint(),
                 "round_bits": fl.wire_report(),
                 "final_loss": fl._final["loss"],
                 "eval_loss": fl.evaluate(),
                 "eval_seed": fl.eval_data.seed}
            r["h_shapes"] = [tuple(x.shape) for x in T.leaves(fl.state.h)]
            out[case] = r
        out["fixed_routing"] = _fixed_routing_step_2x2(
            specs["finetune_moe"], group)
    finally:
        group.close()
    return out


def _fixed_routing_step_2x2(raw, group):
    """One fsdp step of granite-moe's smoke config on this 2x2 rank under
    fixed routing (zeroed routers: every token to experts 0 and 1) with
    the spec's expert-sparse leaf rules and ``zero_inactive_expert_grads``:
    whether each expert leaf's h (this rank's model shard of its worker's)
    moved in the idle experts' slabs and in the routed ones."""
    import functools

    from repro_torch.core import build
    from repro_torch.models import layers as tL
    from repro_torch.optim.optimizers import sgd
    from repro_torch.optim.schedules import constant

    spec = ExperimentSpec.from_json(raw)
    run = build(spec)
    cfg = get_smoke_config(spec.problem)
    model = build_model(cfg)
    shards = tlaunch.make_shards(spec, group, model)
    params = shards.shard_tree(tL.fixed_routing_params(
        model.init(R.key(0), device="cpu")))
    opt = sgd(constant(0.05))
    state = run.init_state(params, opt, group=group, shards=shards)
    step = run.train_step(functools.partial(model.loss, tp=group.model),
                          opt, group=group, shards=shards,
                          grad_transform=tL.zero_inactive_expert_grads)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=16,
                       n_workers=2, seed=0)
    state, _ = step(state, data.batch(0), R.fold_in(R.key(spec.seed), 0))
    return {k: (bool(h[:, :, 2:].any()), bool(h[:, :, :2].any()),
                tuple(h.shape))
            for k, h in state.h["layers"]["moe"].items()
            if k in tL.EXPERT_LEAVES}


def test_finetune_loop_2x2_matches_jax_loop(tmp_path):
    """``FinetuneLoop`` on ``finetune_moe.json`` and ``zoo_qwen2_fsdp.json``
    at mesh 2x2 (n = 2, the fsdp trainer; qwen2 also under shard_map) on
    four gloo ranks, 2 processes of 2 ranks, two steps of the spec's
    budget, against JAX's on four fake host devices at
    ``num_processes=2``: the fingerprint (the fsdp specs' pinned in
    ``FSDP_SPECS_2X2``), the round's bits
    and the eval stream's seed exactly JAX's, the final and eval losses
    within bf16's 1e-2 (f32's 1e-4 for granite-moe, ``LOOP_2X2``); every
    rank's h holds its worker's model shards; and one fsdp step of
    granite-moe under fixed routing on the same ranks leaves the idle
    experts' slabs of every rank's h exactly zero (as
    ``test_fsdp_step_keeps_inactive_expert_slabs_of_h_zero`` at 4x1)."""
    from test_torch_model import _spawn_ranks

    specs = _loop_2x2_specs()
    code = _JAX_LOOP_2X2.replace("SPECS", repr(specs)).replace(
        "KW", repr(LOOP_2X2_KW)).replace(
            "ADT", repr({k: v[2] for k, v in LOOP_2X2.items()})).replace(
                "STEPS", repr(LOOP_2X2_STEPS))
    want = json.loads(run_with_devices(code, 4).split("LOOP_2X2 ", 1)[1])
    ranks = _spawn_ranks(tmp_path, 4, _loop_2x2_rank, specs)
    for case, w in want.items():
        spec = ExperimentSpec.from_json(specs[case])
        got = ranks[0][case]
        assert got["fingerprint"] == w["fingerprint"] == spec.fingerprint()
        if case in FSDP_SPECS_2X2:
            assert spec.fingerprint() == FSDP_SPECS_2X2[case]
        assert got["round_bits"] == w["round_bits"], case
        assert got["eval_seed"] == w["eval_seed"] == \
            spec.seed ^ tlaunch.EVAL_SEED_XOR
        np.testing.assert_allclose(
            [got["final_loss"], got["eval_loss"]],
            [w["final_loss"], w["eval_loss"]],
            atol=LOOP_2X2_ATOL[LOOP_2X2[case][2]], err_msg=case)
        # every rank: one worker, its model shards (half of each sharded
        # leaf of the logical tree)
        model = build_model(get_smoke_config(spec.problem))
        logical = [tuple(x.shape) for x in T.leaves(model.init_abstract())]
        for r in ranks:
            # fixed routing on the model axis: the idle experts' slabs of
            # h exactly zero, the routed ones moved
            for k, (idle, routed, shape) in r["fixed_routing"].items():
                assert (idle, routed) == (False, True), (k, shape)
            shapes = r[case]["h_shapes"]
            assert [s[0] for s in shapes] == [1] * len(logical)
            assert any(s[1:] != l for s, l in zip(shapes, logical))
            assert all(math.prod(s[1:]) in (math.prod(l), math.prod(l) // 2)
                       for s, l in zip(shapes, logical))


@pytest.mark.parametrize("processes", [0, 3, 4])
def test_finetune_loop_2x2_refuses_processes_as_jax(processes):
    """A --processes that JAX's multihost mesh cannot take on a 2x2 mesh
    of 2 workers (it takes 1 or 2) fails with JAX's message."""
    raw = _loop_2x2_specs()["zoo_qwen2_fsdp"]
    kw = dict(LOOP_2X2_KW, num_processes=processes)
    with pytest.raises(ValueError) as je:
        jloop.FinetuneLoop(JSpec.from_json(raw),
                           jloop.FinetuneSettings(**kw)).setup()
    with pytest.raises(ValueError) as te:
        tlaunch.FinetuneLoop(ExperimentSpec.from_json(raw),
                             tlaunch.FinetuneSettings(**kw),
                             device="cpu").setup()
    assert str(te.value) == str(je.value)


# -- sanitize mode (JAX's ``--sanitize``, ``make sanitize-smoke``) ----------
#
# The two commands of JAX's ``make sanitize-smoke`` on the CPU: each port run
# under --sanitize ends with the losses of the same run without it, bit for
# bit, and with JAX's sanitized run's within the smoke rounds' tolerances
# (the 2x2 driver's 1.5e-3, bf16's 1e-2 for the finetune command).

SANITIZE_TRAIN = ["--arch", "qwen2-0.5b", "--smoke", "--mesh", "2x2",
                  "--steps", "2", "--global-batch", "8", "--seq", "32",
                  "--compressor", "block_topk:256,16", "--agg",
                  "sparse_allgather"]
SANITIZE_FINETUNE = ["--spec", os.path.join(SPECS_DIR, "finetune_moe.json"),
                     "--steps", "2", "--global-batch", "8", "--seq", "32",
                     "--eval-every", "2"]
JAX_SANITIZE = f"""
import contextlib, io, json, os
from repro.launch import finetune, train
res = {{}}
for name, main, argv in (("train", train.main, {SANITIZE_TRAIN!r}),
                         ("finetune", finetune.main, {SANITIZE_FINETUNE!r})):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--sanitize"])
    res[name] = buf.getvalue()
# jax_debug_nans is on: a NaN put in a param leaf raises at a primitive
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import build_model
m = build_model(get_smoke_config("qwen2-0.5b"))
p = m.init(jax.random.key(0))
import numpy as np
wg = np.array(p["layers"]["mlp"]["wg"])
wg[0, 0, 0] = np.nan
p["layers"]["mlp"]["wg"] = jnp.asarray(wg)
batch = {{"tokens": jnp.zeros((2, 16), jnp.int32),
          "labels": jnp.zeros((2, 16), jnp.int32)}}
try:
    jax.jit(jax.value_and_grad(lambda q: m.loss(q, batch)[0]))(p)
    res["nan"] = "no error"
except FloatingPointError as e:
    res["nan"] = str(e).splitlines()[0]
# JAX's REPRO_SANITIZE=1 does not switch the port's mode
from repro_torch import kernels
res["env"] = os.environ.get("REPRO_SANITIZE")
res["port_active"] = kernels.active()
print("JSON" + json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_sanitize():
    """JAX's two sanitize-smoke commands, and an injected NaN under
    ``jax_debug_nans``, in one process of four fake host devices."""
    return json.loads(run_with_devices(JAX_SANITIZE, 4).split("JSON")[-1])


def _step_lines(text):
    import re

    return [re.sub(r"\(\S+s/step\)", "", line) for line in text.splitlines()
            if " loss=" in line]


def _sanitize_rank(store, argv):
    """One rank of the 2x2 train command, as is then under --sanitize
    (each over its own file store): (final loss, output) of each."""
    import contextlib
    import io

    out = []
    for tag, extra in (("plain", []), ("sanitized", ["--sanitize"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss = tlaunch.main(argv + extra + [
                "--dist-backend", "gloo", "--dist-init",
                f"file://{store}/{tag}"])
        out.append((loss, buf.getvalue()))
    return out


def test_sanitize_smoke_train_2x2_matches_plain_and_jax(tmp_path,
                                                        jax_sanitize):
    """The train command of ``make sanitize-smoke`` (--mesh 2x2) on four
    gloo ranks: under --sanitize every rank's losses are the unsanitized
    run's bitwise, rank 0 says so as JAX's driver does, and its losses are
    JAX's sanitized run's within the 2x2 driver's 1.5e-3."""
    from test_torch_model import LOSS_ATOL, _spawn_ranks

    ranks = _spawn_ranks(tmp_path, 4, _sanitize_rank,
                         SANITIZE_TRAIN + ["--device", "cpu"])
    for (plain, p_out), (sane, s_out) in ranks:
        assert float(plain).hex() == float(sane).hex()
        assert _step_lines(p_out) == _step_lines(s_out)
    out = ranks[0][1][1]
    assert "[train] sanitize mode: NaN check" in out
    losses = [float(x.split("loss=")[1].split()[0])
              for x in _step_lines(out)]
    jax_losses = [float(x.split("loss=")[1].split()[0])
                  for x in _step_lines(jax_sanitize["train"])]
    assert len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=LOSS_ATOL)


def test_sanitize_smoke_finetune_matches_plain_and_jax(jax_sanitize,
                                                       monkeypatch, capsys):
    """The finetune command of ``make sanitize-smoke`` in one process: the
    sanitized run's step, final and eval losses are the unsanitized run's
    bitwise, and JAX's sanitized run's within bf16's 1e-2."""
    from repro_torch import kernels

    # sanitize mode is this process's from the second run on: undone after
    monkeypatch.setattr(kernels, "_sanitize", False)
    monkeypatch.setenv(kernels.SANITIZE_ENV, "0")
    argv = ["finetune"] + SANITIZE_FINETUNE + ["--device", "cpu"]
    plain = tlaunch.main(argv)
    p_out = capsys.readouterr().out
    sane = tlaunch.main(argv + ["--sanitize"])
    s_out = capsys.readouterr().out
    assert kernels.active()
    assert float(plain).hex() == float(sane).hex()
    assert _step_lines(p_out) == _step_lines(s_out)
    assert "[finetune] sanitize mode: NaN check" in s_out

    def final(text):
        line = [x for x in text.splitlines() if "done: final loss" in x][0]
        return [float(line.split("final loss ")[1].split()[0]),
                float(line.split("eval loss ")[1].split()[0])]
    np.testing.assert_allclose(final(s_out), final(jax_sanitize["finetune"]),
                               rtol=0, atol=1e-2)


def test_sanitize_nan_raises_at_an_op_in_both_packages(jax_sanitize):
    """A NaN put in a param leaf: JAX's jitted loss and gradient under
    ``jax_debug_nans`` raise FloatingPointError at a primitive, and the
    port's sanitized train step (``trainer.sanitized_step``) at the first
    aten op that made a NaN; JAX's ``REPRO_SANITIZE=1`` leaves the port's
    mode off."""
    from repro_torch.core import ExperimentSpec, build
    from repro_torch.train.trainer import sanitized_step

    assert jax_sanitize["nan"].startswith("invalid value (nan) encountered")
    assert jax_sanitize["env"] == "1" and jax_sanitize["port_active"] is False
    cfg = get_smoke_config("qwen2-0.5b")
    spec = ExperimentSpec(problem="qwen2-0.5b", smoke=True,
                          backend="shard_map", mesh="2x1", n=2,
                          compressor="block_topk:256,16",
                          agg="sparse_allgather", d=tlaunch.tuning_dim(cfg))
    run_ = build(spec)
    model = build_model(cfg)
    params = model.init(R.key(0), device="cpu")
    opt = adamw(cosine(3e-4, 10, 1))
    step = sanitized_step(run_.train_step(model.loss, opt))
    batch = {k: torch.zeros((8, 32), dtype=torch.int64)
             for k in ("tokens", "labels")}
    # a clean step raises nothing, and changes nothing
    state, _ = step(run_.init_state(params, opt), batch, R.key(0))
    params["layers"]["mlp"]["wg"][0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"invalid value \(nan\) encountered in aten\."):
        step(run_.init_state(params, opt), batch, R.key(0))


def test_sanitize_routes_every_wrapper_plain_and_checks_bounds(monkeypatch):
    """In sanitize mode a kernel wrapper takes its plain version on the
    card too (``kernels.plain_route``), and an out-of-range rand-k
    position raises IndexError there, launching nothing; off, the card
    launches."""
    from repro_torch import kernels
    from repro_torch.kernels import pack as tpack

    monkeypatch.setattr(kernels, "_sanitize", False)
    monkeypatch.setenv(kernels.SANITIZE_ENV, "0")
    cuda = torch.device("cuda")
    assert not kernels.active() and not kernels.plain_route(cuda)
    assert kernels.plain_route(torch.device("cpu"))
    monkeypatch.setenv(kernels.SANITIZE_ENV, "1")
    assert kernels.active() and kernels.plain_route(cuda)
    before = dict(kernels.LAUNCHES)
    g = torch.arange(100, dtype=torch.float32)
    for bad in (100, -1):
        idx = torch.tensor([3, bad, 7], dtype=torch.int32)
        with pytest.raises(IndexError, match="rand-k positions outside"):
            tpack.randk_update(g, torch.zeros_like(g), idx, 2.0, 0.5)
    assert dict(kernels.LAUNCHES) == before


def test_sanitize_reaches_a_spawned_child():
    """``kernels.enable`` marks the processes started after it
    (``REPRO_TORCH_SANITIZE=1``, as ``torchrun`` ranks and ``--processes``
    workers inherit it); JAX's ``REPRO_SANITIZE=1`` alone does not."""
    import subprocess
    import sys

    code = (
        "import os, subprocess, sys\n"
        "os.environ['REPRO_SANITIZE'] = '1'\n"
        "from repro_torch import kernels\n"
        "print('BEFORE', kernels.active())\n"
        "kernels.enable()\n"
        "child = 'from repro_torch import kernels; print(kernels.active())'\n"
        "print('CHILD', subprocess.run([sys.executable, '-c', child],\n"
        "      capture_output=True, text=True, check=True).stdout.strip())\n")
    from repro_torch import kernels

    env = dict(os.environ)
    env.pop(kernels.SANITIZE_ENV, None)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True).stdout
    assert "BEFORE False" in out and "CHILD True" in out
