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
    jsched = jcosine(3e-4, total_steps=50, warmup_steps=2)
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
    ["--spec", "x.json"], ["--mesh", "2x2"], ["--wire-dtype", "bfloat16"],
    ["--schedule", "wsd"], ["--ckpt-dir", "ckpt"], ["--sanitize"]])
def test_cli_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--smoke", "--device", "cpu", *flag])
    assert "not yet ported" in capsys.readouterr().err


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
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
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
