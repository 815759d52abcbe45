"""The port's dense model against ``repro.models`` from the same params.

Smoke qwen2 params are drawn once by the JAX package and carried across by
``T.params_from_jax``; batches come from numpy.  Tolerances:

* f32 activations: rtol 1e-5 (atol 1e-5 on O(1) logits).  Both packages
  compute the same f32 ops; only the summation order inside matmuls,
  softmax and norms differs.
* bf16 activations: atol 3e-2 on logits and 1e-2 on the loss.  bf16 is
  rounded at different points in the two frameworks (XLA fuses and keeps
  some elementwise chains in f32 where torch rounds after each op), so
  values differ by a few bf16 ulps (2^-8 relative).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jL
from repro.models.model import cross_entropy as jcross_entropy
from repro_torch import random
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import layers as tL
from repro_torch.models.model import build_model, cross_entropy

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Every test of the file, and its module fixtures, on one torch
    intra-op thread: beside the other test workers, OpenMP's barriers
    cost far more than the work (the bidirectional smoke round took 167 s
    on 8 threads next to 6 busy processes, 18 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(adt):
    return (dataclasses.replace(jget_smoke_config("qwen2-0.5b"),
                                activation_dtype=adt),
            dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                                activation_dtype=adt))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs("float32")
    return jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.key(0)))


def _batch(seq=16, batch=4):
    return SyntheticLM(vocab=1024, seq_len=seq, global_batch=batch,
                       n_workers=2, seed=3).batch(0)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def test_params_round_trip_and_layout(jax_params):
    tparams = T.params_from_jax(jax_params, device="cpu")
    back = T.params_to_numpy(tparams)
    for a, b in zip(jax.tree.leaves(jax_params), T.leaves(back)):
        np.testing.assert_array_equal(a, b)
    _, tcfg = _cfgs("float32")
    abstract = build_model(tcfg).init_abstract()
    assert [tuple(p.shape) for p in T.leaves(abstract)] == \
        [a.shape for a in jax.tree.leaves(jax_params)]
    fresh = build_model(tcfg).init(random.key(0), device="cpu")
    assert [tuple(p.shape) for p in T.leaves(fresh)] == \
        [a.shape for a in jax.tree.leaves(jax_params)]


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
def test_logits_and_loss_match_jax(jax_params, adt):
    jcfg, tcfg = _cfgs(adt)
    batch = _batch()
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jlogits, _ = jm.forward(jax_params, batch)
    jloss, _ = jm.loss(jax_params, batch)
    tparams = T.params_from_jax(jax_params, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits = tm.forward(tparams, tbatch)
    tloss, _ = tm.loss(tparams, tbatch)
    assert tlogits.dtype == (torch.float32 if adt == "float32"
                             else torch.bfloat16)
    if adt == "float32":
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **F32)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), atol=3e-2)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-2)


def test_grads_match_jax_f32(jax_params):
    """f32 gradients agree leaf by leaf (what the compressor sees)."""
    from repro_torch.train.trainer import value_and_grad
    jcfg, tcfg = _cfgs("float32")
    batch = _batch()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jbuild_model(jcfg).loss(p, batch)[0])(jax_params)
    tloss, tgrads = value_and_grad(
        build_model(tcfg).loss, T.params_from_jax(jax_params, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jgrads), T.leaves(tgrads)):
        scale = float(np.abs(a).max()) + 1e-30
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0,
                                   atol=1e-4 * scale)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64)
    np.testing.assert_allclose(
        _np(tL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))),
        np.asarray(jL.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **F32)
    q = _rand(rng, 2, 7, 3, 64)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    np.testing.assert_allclose(
        _np(tL.apply_rope(torch.from_numpy(q), torch.from_numpy(pos.copy()),
                          10_000.0)),
        np.asarray(jL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0)),
        **F32)


@pytest.mark.parametrize("impl,case", [
    pytest.param("direct", "", id="direct"),
    pytest.param("chunked", "", id="chunked"),
    pytest.param("direct", "noncausal", id="direct-noncausal"),
    pytest.param("direct", "cross", id="direct-cross"),
    pytest.param("direct", "window", id="direct-window"),
    pytest.param("chunked", "window", id="chunked-window"),
    pytest.param("direct", "mrope", id="direct-mrope")])
def test_gqa_attention_matches_jax(impl, case):
    """GQA attention with QKV bias against ``repro.models.layers.attention``:
    causal with RoPE (both impls); non-causal (``mask=None``); cross-
    attention (given k and v of another length, no RoPE on them); a
    sliding window of 5 (the direct mask and the chunked scan's term, over
    3 chunks); M-RoPE with sections (2, 3, 3) on (t, h, w) position
    streams that differ."""
    rng = np.random.default_rng(1)
    d, nh, nkv, hd, S = 64, 4, 2, 16, 12
    p = {"wq": _rand(rng, d, nh * hd) / 8, "wk": _rand(rng, d, nkv * hd) / 8,
         "wv": _rand(rng, d, nkv * hd) / 8, "wo": _rand(rng, nh * hd, d) / 8,
         "bq": _rand(rng, nh * hd), "bk": _rand(rng, nkv * hd),
         "bv": _rand(rng, nkv * hd)}
    x = _rand(rng, 2, S, d)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    kw = {}
    if case == "noncausal":
        kw = dict(causal=False)
    elif case == "cross":
        kv = (_rand(rng, 2, 7, nkv, hd), _rand(rng, 2, 7, nkv, hd))
        kw = dict(causal=False, kv=kv)
    elif case == "window":
        kw = dict(window=5)
    elif case == "mrope":
        pos = np.stack([pos, pos // 3, pos % 4]).astype(np.int32)
        kw = dict(mrope_sections=(2, 3, 3))
    jkw = {k: tuple(map(jnp.asarray, v)) if k == "kv" else v
           for k, v in kw.items()}
    tkw = {k: tuple(map(torch.from_numpy, v)) if k == "kv" else v
           for k, v in kw.items()}
    want = jL.attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                        n_heads=nh, n_kv=nkv, hd=hd,
                        positions=jnp.asarray(pos), theta=10_000.0,
                        impl=impl, **jkw)
    got = tL.attention(T.tree_map(torch.from_numpy, p), torch.from_numpy(x),
                       n_heads=nh, n_kv=nkv, hd=hd,
                       positions=torch.from_numpy(pos), theta=10_000.0,
                       impl=impl, **tkw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    if case == "window" and impl == "chunked":
        q, k, v = (torch.from_numpy(_rand(rng, 2, S, n, hd))
                   for n in (nh, nkv, nkv))
        np.testing.assert_allclose(
            _np(tL._sdpa_chunked(q, k, v, window=5, chunk=4)),
            _np(tL._sdpa(q, k, v, tL.causal_mask(S, S, 5))), **F32)


def test_chunked_equals_direct_over_several_chunks():
    """The chunk loop with an online softmax equals materialized scores."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 40, 4, 16)),
               torch.from_numpy(_rand(rng, 2, 40, 2, 16)),
               torch.from_numpy(_rand(rng, 2, 40, 2, 16)))
    direct = tL._sdpa(q, k, v, tL.causal_mask(40, 40))
    chunked = tL._sdpa_chunked(q, k, v, chunk=16)
    np.testing.assert_allclose(_np(chunked), _np(direct), **F32)


def test_swiglu_and_cross_entropy_match_jax():
    rng = np.random.default_rng(3)
    p = {"wg": _rand(rng, 32, 48) / 6, "wu": _rand(rng, 32, 48) / 6,
         "wd": _rand(rng, 48, 32) / 7}
    x = _rand(rng, 2, 5, 32)
    np.testing.assert_allclose(
        _np(tL.swiglu(T.tree_map(torch.from_numpy, p), torch.from_numpy(x))),
        np.asarray(jL.swiglu(jax.tree.map(jnp.asarray, p), jnp.asarray(x))),
        **F32)
    logits = _rand(rng, 2, 5, 50)
    labels = rng.integers(0, 50, (2, 5)).astype(np.int32)
    labels[:, -1] = -1
    jce, jn = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tce, tn = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tce), float(jce), rtol=1e-6)
    assert float(tn) == float(jn) == 8.0


# -- the driver's --spec (launch/train.py) ------------------------------------
#
# One spec file drives the port's driver: the flags folded by
# ``spec_from_args`` and written as JSON, run again with ``--spec`` and the
# same runtime flags, give the same printed fingerprint (JAX's for the same
# flags with ``--mesh 2x1``) and the same step lines on the smoke config.

import re  # noqa: E402

from repro.configs import get_smoke_config as _jsmoke  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402

SPEC_FLAGS = ["--compressor", "block_topk:256,16", "--agg",
              "sparse_allgather", "--downlink", "qsgd:16", "--pipeline",
              "depth:1", "--steps", "2"]
RUNTIME = ["--device", "cpu", "--global-batch", "4", "--seq", "16",
           "--log-every", "1"]


def _run(argv, capsys):
    tlaunch.main(argv)
    out = capsys.readouterr().out
    fps = re.findall(r"spec fingerprint=([0-9a-f]{16})", out)
    steps = [re.sub(r"\(\S+s/step\)", "", line)
             for line in out.splitlines() if "] step " in line]
    return fps, steps, out


def _write(tmp_path, spec, name="s.json"):
    path = tmp_path / name
    path.write_text(spec.to_json())
    return str(path)


def test_driver_spec_file_equals_flag_run(tmp_path, capsys):
    fps, steps, out = _run(["--smoke", "--workers", "2"] + SPEC_FLAGS
                           + RUNTIME, capsys)
    spec = tlaunch.spec_from_args(tlaunch.parse_args(
        ["--smoke", "--device", "cpu", "--workers", "2"] + SPEC_FLAGS), 2)
    jspec = jtrain.spec_from_args(jtrain.parse_args(
        ["--arch", "qwen2-0.5b", "--smoke", "--mesh", "2x1"] + SPEC_FLAGS), 2)
    assert spec.to_json() == jspec.to_json()
    assert fps == [spec.fingerprint()] == [jspec.fingerprint()]
    path = _write(tmp_path, spec)
    sfps, ssteps, sout = _run(["--spec", path] + RUNTIME, capsys)
    assert sfps == fps and f"(from {path})" in sout
    assert len(steps) == 2 and ssteps == steps
    assert "|g|=0.000" in steps[0]  # the pipelined priming round


def test_driver_folds_smoke_and_pipeline_into_a_spec(tmp_path, capsys):
    """--smoke (with the smoke config's tuning dimension) and --pipeline
    fold into a loaded spec, as JAX's driver folds them."""
    full = tlaunch.spec_from_args(tlaunch.parse_args(
        ["--device", "cpu", "--workers", "2"] + SPEC_FLAGS[:6]
        + ["--steps", "2"]), 2)
    assert not full.smoke and full.pipeline == "off"
    jfull = jtrain.spec_from_args(jtrain.parse_args(
        ["--arch", "qwen2-0.5b", "--mesh", "2x1"] + SPEC_FLAGS[:6]
        + ["--steps", "2"]), 2)
    jfolded = dataclasses.replace(
        jfull, smoke=True, d=jtrain.tuning_dim(_jsmoke("qwen2-0.5b")),
        pipeline="depth:1")
    fps, steps, _ = _run(["--spec", _write(tmp_path, full), "--smoke",
                          "--pipeline", "depth:1"] + RUNTIME, capsys)
    assert fps == [jfolded.fingerprint()]
    ffps, fsteps, _ = _run(["--smoke", "--workers", "2"] + SPEC_FLAGS
                           + RUNTIME, capsys)
    assert ffps == fps and fsteps == steps


@pytest.mark.parametrize("spec,message", [
    (dict(backend="reference", problem="logreg"), "bad experiment spec"),
    (dict(problem="logreg", mesh="1x1", n=1, d=16), "model archs"),
    (dict(mesh="2x3"), "is not divisible by 3"),
    (dict(backend="fsdp", mesh="2x2"), "W' x 2 ranks"),
    (dict(problem="zamba2-7b", d=32768, mesh="2x2"), "W' x 2 ranks"),
    (dict(leaf_codecs="*embed*=qsgd:16"), None),
    (dict(downlink="topk:64"), None),
    (dict(compressor="sign"), None),
    (None, "bad experiment spec"),
    (dict(backend="fsdp"), None)])
def test_driver_refuses_specs_it_cannot_run(tmp_path, spec, message):
    from repro_torch.core import ExperimentSpec

    if spec is None:
        path = str(tmp_path / "missing.json")
    else:
        kw = dict(backend="shard_map", problem="qwen2-0.5b", smoke=True,
                  mesh="2x1", n=2, d=131072, steps=1)
        kw.update(spec)
        if kw["backend"] == "reference":
            kw.update(mesh="", smoke=False)
        if kw["problem"] == "logreg":
            kw.update(smoke=False)
        if kw.get("mesh") == "2x3":
            kw.update(n=2)
        path = _write(tmp_path, ExperimentSpec(**kw))
    if message is None:
        # per-leaf codecs, a non-QSGD downlink, the rest of the zoo and the
        # fsdp trainer are ported: the driver runs the spec's step
        assert np.isfinite(tlaunch.main(["--spec", path] + RUNTIME))
        return
    with pytest.raises(SystemExit, match=message):
        tlaunch.main(["--spec", path] + RUNTIME)


# -- fault s: JAX's initial weights; the mesh's param specs -------------------

from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.models.layers import is_spec  # noqa: E402
from repro.configs import get_config as _jfull  # noqa: E402
from repro_torch.configs import get_config as _tfull  # noqa: E402


@pytest.mark.parametrize("seed,arch", [
    pytest.param(0, "qwen2-0.5b", id="0"),
    pytest.param(7, "qwen2-0.5b", id="7"),
    pytest.param(0, "mamba2-130m", id="mamba2-130m"),
    pytest.param(0, "granite-moe-3b-a800m", id="granite-moe-3b-a800m"),
    pytest.param(0, "zamba2-7b", id="zamba2-7b"),
    pytest.param(0, "whisper-medium", id="whisper-medium"),
    pytest.param(0, "qwen2-vl-2b", id="qwen2-vl-2b")])
def test_init_draws_jax_weights_bitwise(seed, arch):
    """``Model.init(random.key(s))`` follows JAX's key tree (split(key, 8);
    the layers' keys split per layer, then 4 ways for attention and 3 for
    the MLP or 4 for the experts, or 8 ways for mamba2, or 3 ways for an
    encdec decoder layer (attention, cross-attention, MLP); the embedding
    under keys[1], an untied head under keys[2], the hybrid's shared block
    under keys[3], the encoder's layers under keys[4]) and draws
    ``random.normal``,
    XLA's erf_inv bit for bit; mamba2's dt_bias (XLA's exp, expm1 and log
    of a uniform) and A_log (XLA's log) too: every leaf equals
    ``repro.models.model.Model.init(jax.random.key(s))`` bitwise."""
    jp = JModel(jget_smoke_config(arch)).init(jax.random.key(seed))
    with random._serial(torch.device("cpu")):
        tp = build_model(get_smoke_config(arch)).init(random.key(seed),
                                                      device="cpu")
    jl, tl = jax.tree.leaves(jp), T.leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      a.view(np.uint32))


@pytest.mark.parametrize("arch,full", [
    pytest.param("qwen2-0.5b", False, id="False"),
    pytest.param("qwen2-0.5b", True, id="True"),
    pytest.param("zamba2-7b", False, id="zamba2-7b"),
    pytest.param("whisper-medium", False, id="whisper-medium"),
    pytest.param("qwen2-vl-2b", False, id="qwen2-vl-2b")])
def test_param_specs_equal_jax(arch, full):
    """The port's ``param_specs()`` equal JAX's PartitionSpecs leaf for
    leaf (as tuples), for qwen2-0.5b full and smoke and the hybrid, encdec
    and vlm smoke configs (the shared block, the encoder, the cross-
    attention): divisibility by the production axis of 16, the 'flat' head
    policy."""
    jcfg = _jfull(arch) if full else jget_smoke_config(arch)
    tcfg = _tfull(arch) if full else get_smoke_config(arch)
    jspecs = jax.tree.leaves(
        JModel(jcfg).param_specs(),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    tspecs = T.leaves(build_model(tcfg).param_specs(), is_leaf=is_spec)
    assert [tuple(s) for s in jspecs] == tspecs
    paths = ["/".join(p) for p, _ in T.flatten_with_path(
        build_model(tcfg).init_abstract())]
    assert len(paths) == len(tspecs)
    got = dict(zip(paths, tspecs))
    if arch != "qwen2-0.5b":
        return
    assert got["embed"] == ("model", None)
    assert got["layers/attn/wq"] == got["layers/mlp/wg"] == \
        (None, None, "model")
    assert got["layers/attn/wo"] == got["layers/mlp/wd"] == \
        (None, "model", None)
    assert got["layers/attn/bq"] == (None, "model")
    assert got["layers/ln1"] == (None, None) and got["final_norm"] == (None,)


@pytest.mark.parametrize("full", [False, True])
def test_model_axis_refuses_an_axis_that_does_not_split(full):
    """Every axis that divides the production axis of 16 splits every
    sharded dim, whole heads or not (qwen2 full at M = 4: 3.5 query heads
    and half a KV head a rank); M = 3 is refused wherever it does not split
    a sharded dim, as JAX's placement of the state refuses it, naming the
    leaf and the dim that 3 does not divide: every smoke config,
    and every full one but minicpm (36 heads of 64, d_ff 5760: all split
    over 3) and granite-moe (it shards no leaf: its 'replicate' attention,
    40 experts, vocab 49,155)."""
    runs = []
    for arch in tconfigs.list_archs():
        model = build_model(_tfull(arch) if full else get_smoke_config(arch))
        assert model.model_axis_refusal(1) == "", arch
        msg = model.model_axis_refusal(3)
        split = all(a.shape[tL.spec_dim(sp)] % 3 == 0 for a, sp in zip(
            T.leaves(model.init_abstract()),
            T.leaves(model.param_specs(), is_leaf=is_spec))
            if tL.spec_dim(sp) is not None)
        if split:
            assert msg == "", arch
            runs.append(arch)
        else:
            assert "does not split over 3 ranks" in msg, arch
            assert "is not divisible by 3" in msg, arch
            assert "not yet ported" not in msg, arch
    assert runs == (["granite-moe-3b-a800m", "minicpm-2b"] if full else [])


# -- the tensor-parallel forward and backward on two gloo ranks ---------------
#
# Tolerance of the sharded loss and the reassembled logical gradients
# against the unsharded port, f32 activations: rtol 1e-5 (atol 1e-6).  Only
# the row-parallel matmuls (o, down) and the vocab-parallel softmax sums
# change their summation order; everything else is the same f32 ops.  The
# EF-BV payload is bitwise: given the same logical gradients the mesh packs
# the same bytes.

import os  # noqa: E402
import time  # noqa: E402

import torch.multiprocessing as tmp  # noqa: E402

TP_TIMEOUT_S = 180


def _tp_rank_main(rank, world, store, fn, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.save(fn(store, *args), f"{store}/rank{rank}.pt")


def _spawn_ranks(tmp_path, world, fn, *args):
    """``fn(store, *args)`` on ``world`` spawned ranks (RANK, WORLD_SIZE
    set as torchrun sets them); their results in rank order.  A rank that
    raises, or ranks not done in TP_TIMEOUT_S, fail the test."""
    ctx = tmp.start_processes(_tp_rank_main,
                              args=(world, str(tmp_path), fn, args),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks not done in {TP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _tp_setup():
    from repro_torch.core.compressors import BlockTopK
    from repro_torch.core.efbv import EFBV

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              activation_dtype="float32")
    model = build_model(cfg)
    params = model.init(random.key(2), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    algo = EFBV(BlockTopK(256, 16), lam=0.37, nu=0.61)
    rng = np.random.default_rng(4)
    grads = T.tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)), params)
    h = T.tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)), params)
    return model, params, batch, algo, grads, h


def _tp_rank(store):
    """One rank of a 1x2 mesh: the sharded loss and gradients, and the
    EF-BV message of given logical gradients, packed on its shards."""
    from repro_torch.distributed.aggregate import (ModelShards, WorkerGroup,
                                                   compress_local)
    from repro_torch.train.trainer import value_and_grad

    model, params, batch, algo, grads, h = _tp_setup()
    group = WorkerGroup.join(1, backend="gloo", device="cpu",
                             init_method=f"file://{store}/tp", model_size=2)
    try:
        shards = ModelShards.of(group.model, model.param_specs(),
                                model.init_abstract())
        mine = shards.shard_tree(params)
        loss, g = value_and_grad(lambda p, b: model.loss(p, b, tp=group.model),
                                 mine, batch)
        message, h_new = compress_local(
            algo, random.key(9), shards.shard_tree(grads),
            shards.shard_tree(h), mode="sparse_allgather", shards=shards)
        parts = [shards.part_codec(j, c) is not None for j, c in enumerate(
            tdist_wire.format_for(algo.compressor, shards.logical).leaves)]
        return {"loss": loss, "grads": g, "message": message, "h": h_new,
                "parts": parts, "norm": shards.norm(shards.shard_tree(grads))}
    finally:
        group.close()


from repro_torch.distributed import wire as tdist_wire  # noqa: E402


def _assemble_payload(parts, shape, dim):
    """The logical block-sparse payload of a leaf packed in place, from the
    ranks' parts in model-rank order: the logical flat leaf is
    prod(shape[:dim]) groups of one run per rank, so its rows are the
    parts' rows interleaved group by group."""
    outer = math.prod(shape[:dim])
    return tuple(torch.stack([c.reshape(outer, -1, c.shape[-1])
                              for c in comps], dim=1).reshape(
                                  -1, comps[0].shape[-1])
                 for comps in zip(*parts))


def test_tensor_parallel_loss_grads_and_payload(tmp_path):
    from repro_torch.distributed.aggregate import ModelShards, compress_local
    from repro_torch.models.layers import ModelAxis
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.train.trainer import value_and_grad

    model, params, batch, algo, grads, h = _tp_setup()
    ranks = _spawn_ranks(tmp_path, 2, _tp_rank)
    loss, want = value_and_grad(model.loss, params, batch)
    msg1, h1 = compress_local(algo, random.key(9), grads, h,
                              mode="sparse_allgather")
    shards = [ModelShards.of(ModelAxis(size=2, rank=r), model.param_specs(),
                             model.init_abstract()) for r in range(2)]
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-5)
        np.testing.assert_allclose(float(r["norm"]),
                                   float(global_norm(grads)), rtol=1e-6)
    assert ranks[0]["parts"] == ranks[1]["parts"]
    # in place: embed, o and down (row runs), and at smoke width gate and
    # up (their shards' runs are 512 / 2 = 256 values, one block); q, k, v
    # and the biases (runs of 128 or 64) gather; the norms are replicated
    paths = ["/".join(p) for p, _ in T.flatten_with_path(params)]
    assert sorted(p for p, on in zip(paths, ranks[0]["parts"]) if on) == \
        ["embed", "layers/attn/wo", "layers/mlp/wd", "layers/mlp/wg",
         "layers/mlp/wu"]
    for j, w in enumerate(T.leaves(want)):
        dim = shards[0].dims[j]
        pieces = [T.leaves(r["grads"])[j] for r in ranks]
        whole = pieces[0] if dim is None else torch.cat(pieces, dim=dim)
        if dim is None:
            assert torch.equal(pieces[0], pieces[1])
        np.testing.assert_allclose(whole.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=paths[j])
        # payload bytes and the kept h' shard: bitwise
        m_parts = [r["message"][j] for r in ranks]
        if ranks[0]["parts"][j]:
            m = _assemble_payload(m_parts, tuple(w.shape), dim)
        else:
            assert all(torch.equal(a, b) for a, b in zip(*m_parts))
            m = m_parts[0]
        for a, b in zip(m, msg1[j]):
            np.testing.assert_array_equal(a.numpy().view(np.uint8),
                                          b.numpy().view(np.uint8))
        for r, rank in enumerate(ranks):
            assert torch.equal(T.leaves(rank["h"])[j],
                               shards[r].shard(j, T.leaves(h1)[j]))


# -- the driver against JAX's: --mesh 2x1 (fault s) and --mesh 2x2 -----------
#
# The SMOKE flags of ``benchmarks/perf_iter.py`` at smoke size, 4 steps,
# from JAX's weights (``init(random.key(seed))``).  The fingerprint and the
# up, down and total bits are exact; each step's loss agrees within 1.5e-3
# absolute (2e-4 relative on losses near 6.95): the activations are bf16,
# rounded at other points by XLA's fusions than by torch's ops (measured:
# within 3e-4 at 2x1, 7e-4 at 2x2, where GSPMD's and the port's
# tensor-parallel sums differ again).

from conftest import run_with_devices  # noqa: E402

SMOKE_FLAGS = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "4",
               "--global-batch", "8", "--seq", "32", "--compressor",
               "block_topk:256,16", "--agg", "sparse_allgather",
               "--downlink", "qsgd:16", "--log-every", "1"]
LOSS_ATOL = 1.5e-3


def _jax_driver(argv, devices):
    out = run_with_devices(
        "from repro.launch import train\n"
        f"train.main({argv!r})\n", devices)
    return out


def _driver_lines(text):
    fps = re.findall(r"spec fingerprint=([0-9a-f]{16})", text)
    bits = [int(float(x)) for x in re.findall(
        r"(\S+) bits/round(?:/worker)? (?:uplink|broadcast|up\+down)", text)]
    losses = [float(x) for x in re.findall(r"step\s+\d+ loss=(\S+)", text)]
    return fps, bits, losses


def _check_against_jax(port, jax_out):
    pf, pb, pl = _driver_lines(port)
    jf, jb, jl = _driver_lines(jax_out)
    assert pf == jf and len(pf) == 1
    # the JAX driver prints the total rounded (:g), the port exactly
    assert pb == [5_776_384, 11_553_216, 23_105_984]
    assert jb == pb[:2] + [int(float(f"{pb[2]:g}"))]
    assert len(pl) == len(jl) == 4
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_ATOL)


def test_driver_2x1_starts_from_jax_weights(capsys):
    """Fault s: the port's driver on --mesh 2x1 (one process) against JAX's
    on two fake host devices; and --mesh 2x1 is the --workers 2 run, bit
    for bit (the same spec and step lines)."""
    jax_out = _jax_driver(SMOKE_FLAGS + ["--mesh", "2x1"], 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside the other test workers: no OpenMP
    try:
        tlaunch.main(SMOKE_FLAGS + ["--mesh", "2x1", "--device", "cpu"])
        mesh = capsys.readouterr().out
        tlaunch.main(SMOKE_FLAGS + ["--workers", "2", "--device", "cpu"])
        workers = capsys.readouterr().out
    finally:
        torch.set_num_threads(threads)
    _check_against_jax(mesh, jax_out)
    strip = lambda t: [re.sub(r"\(\S+s/step\)", "", l)  # noqa: E731
                       for l in t.splitlines() if "/step)" in l
                       or "fingerprint" in l]
    assert strip(mesh) == strip(workers) and len(strip(mesh)) == 5


def _mesh_driver_rank(store, argv):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.main(argv + ["--dist-backend", "gloo", "--dist-init",
                             f"file://{store}/driver"])
    return out.getvalue()


def test_driver_2x2_mesh_matches_jax(tmp_path):
    """--mesh 2x2 on four gloo ranks (2 workers x 2-way tensor
    parallelism) against JAX's driver on four fake host devices: rank 0
    prints JAX's fingerprint and bits and its losses within LOSS_ATOL; the
    other ranks print nothing."""
    argv = SMOKE_FLAGS + ["--mesh", "2x2", "--device", "cpu"]
    ranks = _spawn_ranks(tmp_path, 4, _mesh_driver_rank, argv)
    assert ranks[1:] == ["", "", ""]
    assert " mesh=2x2 ranks=4 backend=gloo " in ranks[0]
    assert "[train] model axis: 2 ranks a worker" in ranks[0]
    jax_out = _jax_driver(SMOKE_FLAGS + ["--mesh", "2x2"], 4)
    _check_against_jax(ranks[0], jax_out)


def _fsdp_driver_rank(store, argv):
    """One rank of the driver, its output and the params that its final
    checkpoint gathered (rank 0's, as numpy)."""
    gathered = []
    whole = tlaunch.whole_params

    def keep(step_fn, tree):
        out = whole(step_fn, tree)
        gathered.append(out)
        return out

    tlaunch.whole_params = keep
    try:
        out = _mesh_driver_rank(store, argv)
    finally:
        tlaunch.whole_params = whole
    return {"out": out, "params": T.tree_map(lambda a: a.numpy().copy(),
                                             gathered[-1])}


def test_driver_2x2_fsdp_matches_jax(tmp_path):
    """--mesh 2x2 --trainer fsdp on four gloo ranks against JAX's driver on
    four fake host devices: rank 0 prints JAX's fingerprint and bits and
    its losses within LOSS_ATOL; its --ckpt-dir checkpoint restores through
    JAX's ``repro.checkpoint`` under the spec's fingerprint, equal bit for
    bit to the params every rank gathered (two stages: the worker group,
    then the model axis)."""
    from repro.checkpoint import npz as jnpz
    from repro.launch import train as jtrain

    ckpt = tmp_path / "ckpt"
    flags = SMOKE_FLAGS + ["--mesh", "2x2", "--trainer", "fsdp"]
    ranks = _spawn_ranks(tmp_path, 4, _fsdp_driver_rank,
                         flags + ["--device", "cpu", "--ckpt-dir",
                                  str(ckpt)])
    assert [r["out"] for r in ranks[1:]] == ["", "", ""]
    out = ranks[0]["out"]
    assert " mesh=2x2 ranks=4 backend=gloo " in out
    assert "[train] fsdp: 2 ranks a worker group hold" in out
    assert "; model axis " in out
    jax_out = _jax_driver(flags, 4)
    _check_against_jax(out, jax_out)
    spec = jtrain.spec_from_args(jtrain.parse_args(flags), 2)
    assert spec.backend == "fsdp"
    assert re.findall(r"spec fingerprint=(\S+)", out) == [spec.fingerprint()]
    template = {"params": jax.tree.map(
        np.asarray, jbuild_model(jget_smoke_config("qwen2-0.5b")).init(
            jax.random.key(0)))}
    back = jnpz.restore_checkpoint(str(ckpt), 4, template, spec=spec)
    assert os.listdir(ckpt) == ["step_00000004.npz"]
    for r in ranks:
        for a, b in zip(jax.tree.leaves(back["params"]),
                        T.leaves(r["params"])):
            assert a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                          b.view(np.uint32))


def test_driver_refuses_a_mesh_the_ranks_do_not_fit(capsys):
    """A model axis needs W' x M ranks: one process cannot run 2x2."""
    with pytest.raises(SystemExit, match="W' x 2 ranks"):
        tlaunch.main(SMOKE_FLAGS + ["--mesh", "2x2", "--device", "cpu"])


# -- the mesh's geometry and specs against repro.launch.mesh / distributed.spec

from repro.distributed import spec as jspec_mod  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.distributed import aggregate as tagg  # noqa: E402


@pytest.mark.parametrize("shape", [(2, 2), (4,), (2, 1), (2, 3, 2)])
def test_mesh_geometry_matches_jax(shape):
    """``make_mesh`` axes and sizes, the worker axes and count, and the
    process-major worker slices as JAX's (its meshes built abstractly, as
    numbers of devices are not needed for the geometry)."""
    mesh = tagg.make_mesh(shape)
    axes = ("pod", "data", "model")[-len(shape):]
    assert mesh.axis_names == axes and mesh.devices_shape == shape

    class JMesh:  # the geometry JAX's helpers read: axis names and sizes
        axis_names = axes
        shape_ = dict(zip(axes, shape))
    JMesh.shape = JMesh.shape_
    assert tagg.worker_axes(mesh) == jmesh.worker_axes(JMesh)
    assert tagg.num_workers(mesh) == jmesh.num_workers(JMesh)
    assert tagg.model_size(mesh) == JMesh.shape.get("model", 1)
    for procs in (1, 2):
        if shape[0] % procs:
            with pytest.raises(ValueError, match="whole workers"):
                tagg.make_multihost_mesh(shape, num_processes=procs)
            continue
        assert tagg.make_multihost_mesh(shape, num_processes=procs) == mesh
        for p in range(procs):
            assert tagg.process_worker_slice(shape, procs, p) == \
                jmesh.process_worker_slice(shape, procs, p)
    assert tagg.batch_spec(mesh) == tuple(jspec_mod.P(
        jmesh.worker_axes(JMesh)))
    w = tagg.worker_axes(mesh)
    coords = [dict(zip(w, c)) for c in np.ndindex(
        *[JMesh.shape[a] for a in w])]
    assert [tagg.linear_worker_index(mesh, c) for c in coords] == \
        list(range(tagg.num_workers(mesh)))
    with pytest.raises(ValueError, match="explicitly"):
        tagg.make_mesh((1, 1, 1, 1))


def test_run_state_shardings_lift_param_specs():
    """``Run.make_mesh`` gives the spec's mesh; ``Run.state_shardings``
    each state leaf's spec: params, m, v, h_avg and w by the param specs,
    h with the worker axes first (JAX's ``stack_worker_spec``)."""
    from repro_torch.core import ExperimentSpec, build
    from repro_torch.optim.optimizers import adamw

    spec = ExperimentSpec(problem="qwen2-0.5b", smoke=True, mesh="2x2", n=2,
                          d=131072, downlink="qsgd:16", backend="shard_map",
                          agg="sparse_allgather", pipeline="depth:1")
    run = build(spec)
    mesh = run.make_mesh()
    assert mesh.shape == {"data": 2, "model": 2}
    model = build_model(get_smoke_config("qwen2-0.5b"))
    specs = model.param_specs()
    state = run.init_state(model.init(random.key(0), device="cpu"),
                           adamw(lambda s: 1e-3), mesh)
    sh = run.state_shardings(mesh, specs, state)
    assert sh.params is specs and sh.w is specs
    # m, v and h_avg by the spec of the first param of their shape (JAX's
    # spec_for): the layer norms take the q bias's split, wq wo's, the rest
    # their own
    attn = specs["layers"]["attn"]
    slots = dict(specs, layers=dict(
        specs["layers"], ln1=attn["bq"], ln2=attn["bq"],
        attn=dict(attn, wq=attn["wo"])))
    assert attn["bq"] == (None, "model") and attn["wo"] == (None, "model",
                                                           None)
    assert attn["wq"] == (None, None, "model")
    assert specs["layers"]["ln1"] == specs["layers"]["ln2"] == (None, None)
    assert sh.h_avg == slots and sh.opt_state["m"] == slots
    assert sh.opt_state["v"] == slots and sh.opt_state["count"] == ()
    jh = jspec_mod.stack_worker_spec(
        type("M", (), {"axis_names": ("data", "model")}),
        jax.tree.map(lambda s: jspec_mod.P(*s), specs,
                     is_leaf=is_spec))
    assert T.leaves(sh.h, is_leaf=is_spec) == [
        tuple(s) for s in jax.tree.leaves(
            jh, is_leaf=lambda s: isinstance(s, jspec_mod.P))]
    # one spec per payload component: the worker axis over its leading dim
    assert [len(p) for p in sh.inflight] == [2] * 14
    assert set(T.leaves(sh.inflight)) == {"data"}
    with pytest.raises(Exception, match="not the spec"):
        run.train_step(model.loss, adamw(lambda s: 1e-3),
                       tagg.make_mesh((2, 1)))


# -- the ssm and moe families: configs, specs, the model axis -----------------

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

NEW_ARCHS = ["minitron-8b", "granite-moe-3b-a800m", "mamba2-130m",
             "phi3-medium-14b", "dbrx-132b", "minicpm-2b", "zamba2-7b",
             "whisper-medium", "qwen2-vl-2b"]


@pytest.mark.parametrize("arch", NEW_ARCHS + ["qwen2-0.5b"])
def test_configs_equal_jax_field_for_field(arch):
    """Each arch's config and smoke config equal the JAX registry's, field
    for field; the registry is JAX's, in its order, with nothing left
    unported; an arch that is not in it is refused."""
    for jget, tget in ((jconfigs.get_config, tconfigs.get_config),
                       (jconfigs.get_smoke_config,
                        tconfigs.get_smoke_config)):
        assert dataclasses.asdict(tget(arch)) == \
            dataclasses.asdict(jget(arch))
    assert arch in tconfigs.list_archs()
    assert tconfigs.list_archs() == tconfigs.known_archs() == \
        jconfigs.list_archs()
    assert tconfigs.NOT_PORTED == []
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config(arch + "-x")


@pytest.mark.parametrize("arch", NEW_ARCHS + ["qwen2-0.5b"])
def test_model_axis_runs_every_arch(arch):
    """ROADMAP 2f: every arch, smoke and full, runs on a ``model`` axis of
    2, 4, 8 and 16 (JAX's production axis), whatever its family, its heads
    and its head: nothing is refused."""
    for cfg in (get_smoke_config(arch), _tfull(arch)):
        model = build_model(cfg)
        for m in (2, 4, 8, 16):
            assert model.model_axis_refusal(m) == "", (cfg.name, m)


# -- the fsdp trainer on two gloo ranks ---------------------------------------

import contextlib  # noqa: E402
import functools  # noqa: E402

from repro_torch.core import compressors as tcomp  # noqa: E402
from repro_torch.core.efbv import EFBV, Downlink, Pipeline  # noqa: E402
from repro_torch.optim.optimizers import adamw  # noqa: E402
from repro_torch.optim.schedules import cosine  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

#: (uplink, agg, downlink, pipeline) of each two-rank fsdp case
FSDP_RANK_CASES = {
    "sparse_qsgd_down": ("block_topk:256,16", "sparse_allgather",
                         "qsgd:16", None),
    "dense_pipelined": ("block_topk:256,16", "dense_psum", "qsgd:16",
                        Pipeline(1)),
}
FSDP_STEPS = 3
#: the master trees laid out as JAX's ``spec_for`` lays them out (by the
#: first param of each leaf's shape)
SLOT_TREES = ("h_avg", "m", "v")


def _fsdp_run(case, group=None, mesh=(2, 1), backend="fsdp"):
    """Three steps of 2 workers on the f32 smoke config, in one process
    (no group) or on this rank of ``group``, under the fsdp trainer or,
    with ``backend="shard_map"`` on a group with a model axis, the mesh
    step: the losses and, as numpy, the master trees (this rank's parts)
    and h."""
    comp, agg, down, pipeline = FSDP_RANK_CASES[case]
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              activation_dtype="float32")
    model = build_model(cfg)
    algo = EFBV(tcomp.make_compressor(comp), lam=0.37, nu=0.61)
    opt = adamw(cosine(3e-4, total_steps=FSDP_STEPS, warmup_steps=1),
                weight_decay=0.01)
    tp = None if group is None else group.model
    if backend == "fsdp":
        shards = ttrainer.make_fsdp_shards(group, tagg.make_mesh(mesh),
                                           model.param_specs(),
                                           model.init_abstract())
        make = ttrainer.make_train_step_fsdp
    else:
        shards = tagg.ModelShards.of(tp, model.param_specs(),
                                     model.init_abstract())
        make = ttrainer.make_train_step
    params = model.init(random.key(3), device="cpu")
    if shards is not None:
        params = shards.shard_tree(params)
    state = ttrainer.init_train_state(
        params, opt, n_workers=2, bidirectional=True, algo=algo,
        agg_mode=agg, pipeline=pipeline, group=group, shards=shards)
    loss_fn = model.loss if tp is None else functools.partial(model.loss,
                                                              tp=tp)
    step = make(loss_fn, opt, algo, n_workers=2, agg_mode=agg,
                downlink=Downlink.parse(down), pipeline=pipeline,
                group=group, shards=shards)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4,
                       n_workers=2, seed=0)
    losses = []
    for s in range(FSDP_STEPS):
        state, m = step(state, data.batch(s), random.fold_in(random.key(0),
                                                              s))
        losses.append(float(m["loss"]))
    if isinstance(state.inflight, tagg.Pending):
        state.inflight.wait()
    as_np = lambda t: T.tree_map(lambda a: a.numpy().copy(), t)  # noqa
    return {"losses": losses, "params": as_np(state.params),
            "w": as_np(state.w), "h_avg": as_np(state.h_avg),
            "m": as_np(state.opt_state["m"]),
            "v": as_np(state.opt_state["v"]), "h": as_np(state.h),
            "dims": None if shards is None else shards.dims,
            "slot_dims": None if shards is None else shards.slot_dims}


def _fsdp_rank(store, case):
    group = tagg.WorkerGroup.join(2, backend="gloo", device="cpu",
                                  init_method=f"file://{store}/fsdp")
    try:
        return _fsdp_run(case, group)
    finally:
        group.close()


@pytest.mark.parametrize("case", list(FSDP_RANK_CASES))
def test_fsdp_two_ranks_equal_one_process_bitwise(tmp_path, case):
    """The fsdp step on 2 gloo ranks (one worker each) against one
    process: each rank holds only its fsdp shards of params, w, h_avg and
    AdamW's m and v (every leaf of the smoke tree halves, the embedding by
    its columns, as JAX's ``fsdp_specs`` lays it out), which reassembled
    are the one-process trees bit for bit after three steps; each rank's h
    is its worker's row, and the losses are equal."""
    with _one_thread():
        want = _fsdp_run(case)
    ranks = _spawn_ranks(tmp_path, 2, _fsdp_rank, case)
    dims = ranks[0]["dims"]
    paths = ["/".join(p) for p, _ in T.flatten_with_path(want["params"])]
    assert dims[paths.index("embed")] == 1
    assert None not in dims and dims == ranks[1]["dims"]
    for r, got in enumerate(ranks):
        assert got["losses"] == want["losses"]
        for a, b in zip(T.leaves(want["h"]), T.leaves(got["h"])):
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a[r:r + 1].view(np.uint32))
    for k in ("params", "w", "h_avg", "m", "v"):
        for j, whole in enumerate(T.leaves(want[k])):
            parts = [T.leaves(g[k])[j] for g in ranks]
            half = list(whole.shape)
            half[dims[j]] //= 2
            assert [list(p.shape) for p in parts] == [half, half], (k, j)
            np.testing.assert_array_equal(
                np.concatenate(parts, axis=dims[j]).view(np.uint32),
                whole.view(np.uint32), err_msg=f"{k} {paths[j]}")


def _fsdp_mesh_rank(store, case):
    """One rank of a 2x2 mesh: the mesh step's three steps, then the fsdp
    step's on the same group."""
    group = tagg.WorkerGroup.join(2, backend="gloo", device="cpu",
                                  init_method=f"file://{store}/fsdp22",
                                  model_size=2)
    try:
        return {"mesh": _fsdp_run(case, group, backend="shard_map"),
                "fsdp": _fsdp_run(case, group, mesh=(2, 2))}
    finally:
        group.close()


def _jax_fsdp_part_shapes(shape, slots=False):
    """Each smoke qwen2 leaf's part shape on one device of ``make_mesh(
    shape)`` under JAX's ``fsdp_specs`` (its mesh read for axis names and
    sizes only); with ``slots``, its m, v and h_avg's: the part of the first
    leaf of its shape (``fsdp_state_shardings``' ``spec_for``)."""
    from types import SimpleNamespace

    from jax.sharding import PartitionSpec as P

    from repro.train.trainer import fsdp_specs as jfsdp_specs

    axes = ("pod", "data", "model")[-len(shape):]
    mesh = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    jm = jbuild_model(jget_smoke_config("qwen2-0.5b"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    specs = jfsdp_specs(mesh, jm.param_specs(), shapes)
    out = []
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P))):
        part = list(leaf.shape)
        for i, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    part[i] //= mesh.shape[a]
        out.append(part)
    if slots:
        leaves = [tuple(x.shape) for x in jax.tree.leaves(shapes)]
        out = [out[leaves.index(s)] for s in leaves]
    return out


@pytest.mark.parametrize("case", list(FSDP_RANK_CASES))
def test_fsdp_2x2_equals_2x2_mesh_bitwise(tmp_path, case):
    """The fsdp step on a 2x2 mesh (2 workers x 2-way tensor parallelism,
    four gloo ranks) against the 2x2 mesh step on the same ranks: each
    rank holds its fsdp part of its model shard of params and w -- the
    shape JAX's ``fsdp_specs`` gives on ``make_mesh((2, 2))``, the layer
    stacks split on L, the embedding's model dim 0 and worker dim 1 -- and
    of h_avg, m and v as JAX's ``fsdp_state_shardings`` lays them out (the
    part of the first leaf of their shape: wq as wo, ln1 and ln2 as the q
    bias), which reassembled over the worker group are the mesh rank's
    shards and slots bit for bit after three steps; each rank's h is its
    worker's model shard, bitwise the mesh rank's, and the losses are
    equal."""
    ranks = _spawn_ranks(tmp_path, 4, _fsdp_mesh_rank, case)
    paths = ["/".join(p) for p, _ in T.flatten_with_path(
        ranks[0]["mesh"]["params"])]
    dims = ranks[0]["fsdp"]["dims"]
    assert all(r["fsdp"]["dims"] == dims for r in ranks)
    assert dims[paths.index("embed")] == 1
    assert all(dims[j] == 0 for j, p in enumerate(paths)
               if p.startswith("layers/"))
    slot_dims = ranks[0]["fsdp"]["slot_dims"]
    moved = [paths[j] for j in range(len(paths))
             if slot_dims[j] != dims[j]
             or ranks[0]["mesh"]["slot_dims"][j]
             != ranks[0]["mesh"]["dims"][j]]
    assert moved == ["layers/attn/wq", "layers/ln1", "layers/ln2"]
    want_shapes = {False: _jax_fsdp_part_shapes((2, 2)),
                   True: _jax_fsdp_part_shapes((2, 2), slots=True)}
    for r, got in enumerate(ranks):
        mesh, fsdp = got["mesh"], got["fsdp"]
        assert fsdp["losses"] == mesh["losses"]
        for a, b in zip(T.leaves(mesh["h"]), T.leaves(fsdp["h"])):
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32))
        for k in ("params", "w", "h_avg", "m", "v"):
            assert [list(x.shape) for x in T.leaves(fsdp[k])] == \
                want_shapes[k in SLOT_TREES], (k, r)
    for i in range(2):  # each model index: its worker group of two ranks
        mesh = ranks[i]["mesh"]
        assert ranks[2 + i]["mesh"]["losses"] == mesh["losses"]
        for k in ("params", "w", "h_avg", "m", "v"):
            along = slot_dims if k in SLOT_TREES else dims
            for j, shard in enumerate(T.leaves(mesh[k])):
                parts = [T.leaves(ranks[w * 2 + i]["fsdp"][k])[j]
                         for w in range(2)]
                np.testing.assert_array_equal(
                    np.concatenate(parts, axis=along[j]).view(np.uint32),
                    shard.view(np.uint32), err_msg=f"{k} {paths[j]}")


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_fsdp_step_keeps_inactive_expert_slabs_of_h_zero():
    """One fsdp step of granite-moe's smoke config under fixed routing
    (zeroed routers: every token to experts 0 and 1) with the committed
    ``finetune_moe.json`` spec's expert-sparse leaf rules and
    ``zero_inactive_expert_grads``: h only accumulates masked messages,
    so its inactive-expert slabs are exactly zero and its routed ones
    are not (as ``tests/test_finetune.py`` asserts of JAX's trainers)."""
    from repro_torch.core import ExperimentSpec, build
    from repro_torch.optim.optimizers import sgd
    from repro_torch.optim.schedules import constant

    spec = ExperimentSpec.from_json(open(os.path.join(
        os.path.dirname(__file__), "..", "examples", "specs",
        "finetune_moe.json")).read())
    run = build(spec)
    cfg = get_smoke_config(spec.problem)
    model = build_model(cfg)
    params = tL.fixed_routing_params(model.init(random.key(0),
                                                device="cpu"))
    opt = sgd(constant(0.05))
    state = run.init_state(params, opt)
    step = run.train_step(model.loss, opt,
                          grad_transform=tL.zero_inactive_expert_grads)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=16,
                       n_workers=4, seed=0)
    with _one_thread():
        state, m = step(state, data.batch(0), random.fold_in(
            random.key(spec.seed), 0))
    assert np.isfinite(float(m["loss"]))
    for name in tL.EXPERT_LEAVES:
        hh = state.h["layers"]["moe"][name]
        assert hh.shape[:3] == (4, cfg.n_layers, cfg.n_experts)
        assert not hh[:, :, 2:].any(), name
        assert hh[:, :, :2].any(), name


# --------------------------------------------------------------------------
# serving: the decode step, its cache, and the continuous-batching engine
# --------------------------------------------------------------------------
#
# Tolerances: f32 activations, logits and every cache leaf within rtol 1e-5
# and atol 3e-5 of JAX's jitted ``decode_step`` (the two packages sum
# matmuls, softmax and norms in other orders; the worst seen is 7e-6 on
# logits of scale 3.4); bf16 activations (the dense case) within atol
# 3e-2 on logits and 5e-2 on the cache, a few bf16 ulps.  Token streams:
# the port's engine equals its fixed batch exactly; JAX's engine equals the
# port's wherever the port's top-2 logit gap exceeds the f32 tolerance,
# up to the first position where it does not (a near tie may flip there
# and the streams part).

from repro.launch.serve import DecodeEngine as JDecodeEngine  # noqa: E402
from repro_torch.launch.train import DecodeEngine  # noqa: E402

DECODE_F32 = dict(rtol=1e-5, atol=3e-5)
DECODE_BF16 = dict(logits=3e-2, cache=5e-2)
FAMILY_OF = {"qwen2-0.5b": "dense", "granite-moe-3b-a800m": "moe",
             "mamba2-130m": "ssm", "zamba2-7b": "hybrid",
             "whisper-medium": "encdec", "qwen2-vl-2b": "vlm"}
DECODE_CASES = {
    # case: (arch, activation dtype, lanes, steps, max_len, attn_window)
    **{fam: (arch, "float32", 2, 6, 8, 0) for arch, fam in FAMILY_OF.items()},
    # the ring buffer: 7 positions through a window of 4 slots
    "dense_window": ("qwen2-0.5b", "float32", 2, 7, 8, 4),
    # three lanes, each its own dispatch group
    "moe_3_lanes": ("granite-moe-3b-a800m", "float32", 3, 5, 8, 0),
    "dense_bf16": ("qwen2-0.5b", "bfloat16", 2, 6, 8, 0),
}


def _serve_models(arch, adt, window=0):
    """(JAX model, JAX params, port model, port params) of the arch's smoke
    config at activation dtype ``adt``, JAX's init at key 0."""
    jcfg = dataclasses.replace(jget_smoke_config(arch), activation_dtype=adt,
                               attn_window=window)
    tcfg = dataclasses.replace(get_smoke_config(arch), activation_dtype=adt,
                               attn_window=window)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, T.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _frames(cfg, lanes, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((lanes, cfg.encoder_frames, cfg.d_model))
            * 0.1).astype(np.float32)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_step_matches_jax(case):
    """``init_cache`` is JAX's tree, shapes and dtypes; teacher-forced
    decode steps (the same tokens into both) give JAX's logits and cache
    within the stated tolerance, every leaf at every step."""
    arch, adt, B, steps, ML, window = DECODE_CASES[case]
    jm, jp, tm, tp = _serve_models(arch, adt, window)
    jc, tc = jm.init_cache(B, ML), tm.init_cache(B, ML, device="cpu")
    assert jax.tree.structure(jc) == jax.tree.structure(
        T.tree_map(lambda a: 0, tc))
    assert [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jc)] == \
        [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
         for a in T.leaves(tc)]
    if window:
        assert jc["k"].shape[2] == window
    if jm.cfg.family == "encdec":
        fr = _frames(jm.cfg, B)
        jc = jm.encode_cross_cache(jp, jnp.asarray(fr), jc)
        tc = tm.encode_cross_cache(tp, torch.from_numpy(fr), tc)
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab, (B, steps))
    step = jax.jit(jm.decode_step)
    for t in range(steps):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                      jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                torch.full((B,), t))
        assert tuple(tl.shape) == (B, 1, jm.cfg.vocab)
        pairs = [(jl, tl, "logits")] + [
            (a, b, f"cache leaf {j}") for j, (a, b) in enumerate(
                zip(jax.tree.leaves(jc), T.leaves(tc)))]
        for a, b, what in pairs:
            a, b = np.asarray(a, np.float32), _np(b)
            if adt == "float32":
                np.testing.assert_allclose(b, a, **DECODE_F32,
                                           err_msg=f"{what} at step {t}")
            else:
                tol = DECODE_BF16["logits" if what == "logits" else "cache"]
                np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                           err_msg=f"{what} at step {t}")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-medium"])
def test_prefill_matches_jax(arch):
    """``prefill``: the last position's logits of the full forward."""
    jm, jp, tm, tp = _serve_models(arch, "float32")
    batch = {"tokens": np.random.default_rng(3).integers(
        0, jm.cfg.vocab, (2, 8)).astype(np.int32)}
    if jm.cfg.family == "encdec":
        batch["frames"] = _frames(jm.cfg, 2)
    want = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, batch))
    got = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(got.shape) == (2, jm.cfg.vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), **DECODE_F32)


def test_cache_specs_equal_jax():
    """``cache_specs`` is JAX's, a tuple per PartitionSpec, every family."""
    for arch in FAMILY_OF:
        jm = jbuild_model(jget_smoke_config(arch))
        tm = build_model(get_smoke_config(arch))
        want = jax.tree.leaves(jm.cache_specs(),
                               is_leaf=lambda s: isinstance(
                                   s, jax.sharding.PartitionSpec))
        got = T.leaves(tm.cache_specs(), is_leaf=tL.is_spec)
        assert [tuple(s) for s in want] == got, arch


def _fixed_batch(tm, tp, prompts, gen, ML, frames=None):
    """The plain lockstep loop: every request in its own lane from
    position 0, greedy; returns (ids (B, gen), top-2 logit gaps)."""
    B, P = prompts.shape
    cache = tm.init_cache(B, ML, device="cpu")
    if frames is not None:
        cache = tm.encode_cross_cache(tp, torch.from_numpy(frames), cache)
    tok, outs, gaps = None, [], []
    for t in range(P + gen):
        inp = torch.from_numpy(prompts[:, t:t + 1]) if t < P else tok
        logits, cache = tm.decode_step(tp, cache, inp, t)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if t >= P:
            top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            outs.append(tok[:, 0].numpy())
            gaps.append((top[:, 0] - top[:, 1]).numpy())
    return np.stack(outs, 1), np.stack(gaps, 1)


@pytest.mark.parametrize("arch", list(FAMILY_OF))
def test_continuous_batching_matches_fixed_batch_and_jax(arch):
    """3 requests through 2 slots (staggered admission and retirement,
    lanes at different positions) decode exactly the ids of the port's
    fixed-batch loop; JAX's engine (``vmap`` of the one-lane step) gives
    the same ids wherever the port's top-2 gap exceeds the tolerance."""
    jm, jp, tm, tp = _serve_models(arch, "float32")
    B, P, G, ML = 3, 4, 6, 16
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jm.cfg.vocab, (B, P))
    frames = _frames(jm.cfg, B) if jm.cfg.family == "encdec" else None
    fixed, gaps = _fixed_batch(tm, tp, prompts, G, ML, frames)
    eng = DecodeEngine(tm, slots=2, max_len=ML, device="cpu")
    reqs = [eng.submit(prompts[i], G,
                       frames=None if frames is None else frames[i])
            for i in range(B)]
    eng.run(tp)
    assert all(r.done for r in reqs) and eng.tokens_decoded == B * (P + G)
    np.testing.assert_array_equal(np.stack([r.out for r in reqs]), fixed)
    jeng = JDecodeEngine(jm, slots=2, max_len=ML)
    jreqs = [jeng.submit(prompts[i], G,
                         frames=None if frames is None else frames[i])
             for i in range(B)]
    jeng.run(jp)
    compared = 0
    for i, jr in enumerate(jreqs):
        for p in range(G):
            if gaps[i, p] <= DECODE_F32["atol"]:
                break
            assert jr.out[p] == fixed[i, p], (arch, i, p)
            compared += 1
    assert compared >= B * G // 2, compared


def test_engine_rejects_overlong_requests():
    _, _, tm, _ = _serve_models("mamba2-130m", "float32")
    eng = DecodeEngine(tm, slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.zeros(5, np.int64), 4)


def test_hot_swap_atomicity_mid_decode():
    """A push staged mid-decode (``tests/test_serve_delta.py``'s check on
    the port): tokens before the commit come from the old version, after
    it from the new, each from exactly one model, and the stream is the
    two-phase reference loop's token for token."""
    from repro_torch.core.efbv import Downlink
    from repro_torch.launch.train import DeltaPusher, ServeReplica

    cfg = get_smoke_config("mamba2-130m")
    model = build_model(cfg)
    params0 = model.init(random.key(7), device="cpu")
    P, G, ML, SWAP = 2, 6, 16, 5  # commit before engine step 5
    prompt = random.randint(random.key(9), P, 0, cfg.vocab, "cpu").numpy()
    dl = Downlink.parse("qsgd:16")
    pusher = DeltaPusher(dl, params0, key=random.key(8))
    rep = ServeReplica(dl, pusher.w)
    env = pusher.push(T.tree_map(lambda a: a + 0.01, params0))
    eng = DecodeEngine(model, slots=1, max_len=ML, device="cpu")
    req = eng.submit(prompt, G)
    for i in range(P + G):
        if i == 2:  # arrives mid-decode: staged, the old version serves on
            assert rep.stage(env) == "staged"
        if i == SWAP:
            assert rep.commit()
        eng.step(rep.params, version=rep.version)
    assert req.done
    ref_old = dl.init(params0)
    ref_new = dl.apply_push(env.payloads, ref_old)
    cache = model.init_cache(1, ML, device="cpu")
    tok, want, want_versions = None, [], []
    for i in range(P + G):
        p = ref_old if i < SWAP else ref_new
        inp = torch.from_numpy(prompt[i:i + 1])[None] if i < P else tok
        logits, cache = model.decode_step(p, cache, inp, i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if i >= P:
            want.append(int(tok[0, 0]))
            want_versions.append(0 if i < SWAP else 1)
    assert req.out == want
    assert req.versions == want_versions
    assert set(req.versions) == {0, 1}
    assert req.versions == sorted(req.versions)


def test_serve_spec_with_a_model_axis_runs_as_jax(tmp_path, capsys):
    """Fault y: JAX's ``run_fleet`` never reads ``spec.mesh``, so the
    committed ``serve_delta.json`` with ``mesh`` 2x2 and n = 2 serves in
    one process: JAX's fingerprint, delta and checkpoint bits a push and
    tokens, every replica bitwise the pusher's after each push (asserted
    inside ``run_fleet``)."""
    from repro_torch.core import ExperimentSpec

    base = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "specs", "serve_delta.json")
    with open(base) as f:
        spec = dataclasses.replace(ExperimentSpec.from_json(f.read()),
                                   mesh="2x2", n=2)
    path = tmp_path / "serve_2x2.json"
    path.write_text(spec.to_json())
    m = tlaunch.main(["serve", "--spec", str(path), "--device", "cpu"])
    assert m["fingerprint"] == spec.fingerprint() == "7d854fd9f63e078f"
    assert m["delta_bits_per_push"] == 2_734_560
    assert m["checkpoint_bits_per_push"] == 10_935_936
    assert m["tokens"] == 64 and m["pushes"] == 3 and m["replicas"] == 2
    assert "fingerprint=7d854fd9f63e078f" in capsys.readouterr().out


# -- remat (JAX's jax.checkpoint of each block) and decode on a model axis -


def _remat_grads(cfg, remat, batch, loss_kw=None, params=None):
    from repro_torch.train.trainer import value_aux_and_grad

    model = build_model(dataclasses.replace(cfg, remat=remat))
    params = model.init(random.key(0), device="cpu") if params is None \
        else params
    loss = model.loss if loss_kw is None else \
        (lambda p, b: model.loss(p, b, **loss_kw))
    return value_aux_and_grad(loss, params, batch)


def _same(a, b):
    return torch.equal(a[0], b[0]) and a[1].keys() == b[1].keys() \
        and all(torch.equal(a[1][k], b[1][k]) for k in a[1]) \
        and all(torch.equal(x, y) for x, y in zip(T.leaves(a[2]),
                                                   T.leaves(b[2])))


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_remat_is_bitwise(arch):
    """Every arch's smoke config (every family: the hybrid's shared block
    and the moe aux loss included): loss, aux metrics and gradients with
    each block recomputed in the backward (``cfg.remat``, JAX's default)
    equal those of the kept activations, bit for bit."""
    from repro_torch.launch.train import family_batch_extras

    cfg = get_smoke_config(arch)
    assert cfg.remat  # JAX's default, the port's too
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (1, 32)))
             for k in ("tokens", "labels")}
    batch.update({k: torch.as_tensor(v)
                  for k, v in family_batch_extras(cfg, 1, 0).items()})
    params = build_model(cfg).init(random.key(0), device="cpu")
    kept = _remat_grads(cfg, False, batch, params=params)
    assert _same(kept, _remat_grads(cfg, True, batch, params=params))


#: decode_step on a model axis: a dense model with a tied (vocab-sharded)
#: embedding, one with an untied vocab-sharded head, moe, the hybrid and
#: encdec (the K/V shards over the head dim in each)
DECODE_TP_ARCHS = ("qwen2-0.5b", "minitron-8b", "granite-moe-3b-a800m",
                   "zamba2-7b", "whisper-medium")
DECODE_TP_LANES, DECODE_TP_TOKENS = 2, 3


def _decode(model, params, cache, tokens, tp=None):
    """Decode the given ``tokens`` (B, n) one at a time from position 0:
    the logits of every step (B, n, V) and the cache."""
    logits = []
    for t in range(tokens.shape[1]):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t,
                                      tp=tp)
        logits.append(lg)
    return torch.cat(logits, 1), cache


def _decode_tp(group):
    """Each of DECODE_TP_ARCHS (f32): the one-process decode of a few
    tokens, and this rank's decode of the same on the model axis (its
    param and cache shards), its cache gathered whole."""
    from repro_torch.distributed.aggregate import ModelShards

    out = {}
    for arch in DECODE_TP_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  activation_dtype="float32")
        model = build_model(cfg)
        params = model.init(random.key(0), device="cpu")
        cache = model.init_cache(DECODE_TP_LANES, 8, device="cpu")
        if cfg.family == "encdec":
            frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (DECODE_TP_LANES, cfg.encoder_frames, cfg.d_model))
                .astype(np.float32))
            cache = model.encode_cross_cache(params, frames, cache)
        tokens = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, (DECODE_TP_LANES, DECODE_TP_TOKENS)))
        whole = _decode(model, params, T.tree_map(torch.clone, cache),
                        tokens)
        pshards = ModelShards.of(group.model, model.param_specs(),
                                 model.init_abstract())
        cshards = ModelShards.of(group.model, model.cache_specs(), cache)
        mine = cshards.shard_tree(cache)
        sharded = [tuple(x.shape) for x in T.leaves(mine)]
        logits, mine = _decode(model, pshards.shard_tree(params), mine,
                               tokens, tp=group.model)
        out[arch] = (whole, (logits, cshards.gather_tree(mine)), sharded,
                     [tuple(x.shape) for x in T.leaves(cache)])
    return out


def _axis_1x2_rank(store):
    """One rank of a 1x2 mesh: the tensor-parallel loss and gradients of
    the qwen2 and granite-moe smoke configs (f32) with and without
    remat, with the model-axis collectives each issued; then
    :func:`_decode_tp`."""
    from repro_torch.distributed.aggregate import ModelShards, WorkerGroup

    group = WorkerGroup.join(1, backend="gloo", device="cpu",
                             init_method=f"file://{store}/axis_1x2",
                             model_size=2)
    remat = {}
    try:
        for arch in ("qwen2-0.5b", "granite-moe-3b-a800m"):
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      activation_dtype="float32")
            model = build_model(cfg)
            shards = ModelShards.of(group.model, model.param_specs(),
                                    model.init_abstract())
            mine = shards.shard_tree(model.init(random.key(0), device="cpu"))
            batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
            for on in (False, True):
                before = group.model.stats["model_calls"]
                res = _remat_grads(cfg, on, batch, {"tp": group.model},
                                   params=mine)
                remat[arch, on] = (res, group.model.stats["model_calls"]
                                   - before)
        decode = _decode_tp(group)
    finally:
        group.close()
    return {"remat": remat, "decode": decode}


@pytest.fixture(scope="module")
def axis_1x2(tmp_path_factory):
    """Both ranks' results of :func:`_axis_1x2_rank` (one spawn)."""
    return _spawn_ranks(tmp_path_factory.mktemp("axis_1x2"), 2,
                        _axis_1x2_rank)


def test_remat_on_a_model_axis_is_bitwise(axis_1x2):
    """On a 1x2 mesh (two gloo ranks) the sharded loss and gradients with
    per-block remat equal those without, bit for bit, on every rank; the
    recomputed forward issues its model-axis collectives again: qwen2's
    smoke loss and gradients 13 collectives without remat, 15 with (each
    of its 2 layers' forward gathers once more); granite-moe's 9 and 11."""
    calls = {}
    for out in axis_1x2:
        out = out["remat"]
        for arch in ("qwen2-0.5b", "granite-moe-3b-a800m"):
            (kept, n_kept), (remat, n_remat) = out[arch, False], \
                out[arch, True]
            assert _same(kept, remat), arch
            calls[arch] = (n_kept, n_remat)
    print(f"model-axis collectives without and with remat: {calls}")
    assert calls == {"qwen2-0.5b": (13, 15), "granite-moe-3b-a800m": (9, 11)}


@pytest.mark.parametrize("arch", DECODE_TP_ARCHS)
def test_decode_step_on_a_model_axis_equals_one_process(axis_1x2, arch):
    """``decode_step(..., tp=)`` on a 1x2 mesh (f32): every rank holds its
    half of the K/V (the head dim, as ``cache_specs`` shards it), and
    after a few tokens its logits and the cache its shards reassemble
    into equal the one-process decode's, bit for bit."""
    for rank, out in enumerate(axis_1x2):
        (lw, cw), (lt, ct), sharded, full = out["decode"][arch]
        assert sharded != full and all(
            s == f or s[-1] * 2 == f[-1] for s, f in zip(sharded, full))
        assert lt.shape == lw.shape and torch.equal(lt, lw), (arch, rank)
        for a, b in zip(T.leaves(cw), T.leaves(ct)):
            assert torch.equal(a, b), (arch, rank)


# -- fault z: granite-moe in bf16, measured ----------------------------------


def _ulps(a, b):
    """|a - b| in bf16 ulps, elementwise, of two f32 arrays holding bf16
    values (their bf16 bit patterns' distance)."""
    bits = lambda x: torch.as_tensor(np.array(x, np.float32)).to(  # noqa
        torch.bfloat16).view(torch.int16).int()
    return (bits(a) - bits(b)).abs()


def _moe_routes(arch, fixed):
    """Step 0 of granite-moe's smoke config in bf16 (JAX's weights, the
    first batch of ``finetune_moe``'s stream) in both packages: the loss,
    each layer's router input and f32 logits, and (JAX, port) layer 0's
    first bf16 matmul, q = x @ wq, from the same input."""
    from repro.models import moe as jmoe

    jcfg, tcfg = jget_smoke_config(arch), get_smoke_config(arch)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    if fixed:
        jp = jmoe.fixed_routing_params(jp)
    tp = T.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = SyntheticLM(vocab=tcfg.vocab, seq_len=32, global_batch=8,
                        n_workers=4, seed=0).batch(0)
    jrec, trec = [], []
    orig_j, orig_t = jmoe.moe_apply, tL.moe_apply

    def jmoe_apply(p, x, **kw):
        logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
        jax.debug.callback(lambda a, b: jrec.append(
            (np.asarray(a, np.float32), np.asarray(b))), x, logits)
        return orig_j(p, x, **kw)

    def tmoe_apply(p, x, **kw):
        logits = (x @ p["router"].to(x.dtype)).float()
        trec.append((x.float().numpy(), logits.numpy()))
        return orig_t(p, x, **kw)
    jmoe.moe_apply, tL.moe_apply = jmoe_apply, tmoe_apply
    try:
        jl = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})[0])
        tl = float(tm.loss(tp, {k: torch.as_tensor(v)
                                for k, v in batch.items()})[0])
    finally:
        jmoe.moe_apply, tL.moe_apply = orig_j, orig_t
    x = torch.as_tensor(batch["tokens"]).long()
    h = tp["embed"].to(torch.bfloat16)[x]
    h = tL.rmsnorm(h, tp["layers"]["ln1"][0], tcfg.norm_eps)
    wq = tp["layers"]["attn"]["wq"][0].to(torch.bfloat16)
    q_t = (h @ wq).float().numpy()
    # JAX's bf16 x @ w: a bf16 dot with a bf16 result
    q_j = np.asarray(jax.lax.dot_general(
        jnp.asarray(h.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(wq.float().numpy()).astype(jnp.bfloat16),
        (((2,), (0,)), ((), ())), preferred_element_type=jnp.bfloat16)
        .astype(jnp.float32))
    return jl, tl, jrec, trec, (q_j, q_t), tcfg.experts_per_tok


def test_fault_z_moe_bf16_routes_flip_only_at_near_ties():
    """Fault z, measured: granite-moe's smoke config in bf16, step 0, the
    same weights and batch in both packages.  The forwards part at their
    first bf16 matmul (q = x @ wq on bitwise-equal inputs): XLA and torch
    sum the f32 products in different orders (standing decision c), a few
    outputs a few ulps apart after cancellation.  The router logits then
    differ by a few ulps, and a token's top-k experts differ between the
    packages only where JAX's gap between the two swapped logits is
    within the packages' own difference there: 1 of 256 tokens in each
    of the 2 layers.  Under fixed routing (zeroed routers:
    both packages route every token to experts 0 and 1) the bf16 losses
    agree within 2e-3 (6.4e-4 measured)."""
    arch = "granite-moe-3b-a800m"
    jl, tl, jrec, trec, (q_j, q_t), k = _moe_routes(arch, fixed=False)
    q_ulps = _ulps(q_j, q_t)
    report = [f"layer-0 q: {int((q_ulps > 0).sum())} of {q_ulps.numel()} "
              f"outputs differ, by at most {int(q_ulps.max())} ulps"]
    assert 0 < int((q_ulps > 0).sum()) <= 64
    flips = []
    for layer, ((jx, jlog), (tx, tlog)) in enumerate(zip(jrec, trec)):
        jlog, tlog = jlog.reshape(tlog.shape), tlog
        jid, tid = (tL.top_k_lowest_ties(torch.softmax(torch.as_tensor(
            lg), -1), k)[1].numpy() for lg in (jlog, tlog))
        lay = []
        for b, s in zip(*np.nonzero((np.sort(jid, -1)
                                     != np.sort(tid, -1)).any(-1))):
            ej = sorted(set(jid[b, s]) - set(tid[b, s]))
            ep = sorted(set(tid[b, s]) - set(jid[b, s]))
            for a, c in zip(ej, ep):
                gap = float(_ulps(jlog[b, s, a], jlog[b, s, c]))
                port_gap = float(_ulps(tlog[b, s, a], tlog[b, s, c]))
                apart = float(max(_ulps(jlog[b, s, a], tlog[b, s, a]),
                                  _ulps(jlog[b, s, c], tlog[b, s, c])))
                lay.append((gap, port_gap, apart))
        flips.append(lay)
        report.append(f"layer {layer}: {len(lay)} of {jid[..., 0].size} "
                      f"tokens flip; (JAX gap, port gap, packages apart) "
                      f"in ulps {lay}")
    print("; ".join(report) + f"; loss JAX {jl} port {tl}")
    assert [len(lay) for lay in flips] == [1, 1]
    for lay in flips:
        for gap, port_gap, apart in lay:
            # ROADMAP §3, z: a flip is rounding when JAX's gap between the
            # swapped logits is within the packages' difference there
            assert gap <= apart
    jl, tl, *_ = _moe_routes(arch, fixed=True)
    print(f"fixed routing: loss JAX {jl} port {tl}")
    assert abs(jl - tl) <= 2e-3
