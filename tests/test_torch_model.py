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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jL
from repro.models.model import cross_entropy as jcross_entropy
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import layers as tL
from repro_torch.models.model import build_model, cross_entropy

F32 = dict(rtol=1e-5, atol=1e-5)


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
    fresh = build_model(tcfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
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


@pytest.mark.parametrize("impl", ["direct", "chunked"])
def test_gqa_attention_matches_jax(impl):
    rng = np.random.default_rng(1)
    d, nh, nkv, hd, S = 64, 4, 2, 16, 12
    p = {"wq": _rand(rng, d, nh * hd) / 8, "wk": _rand(rng, d, nkv * hd) / 8,
         "wv": _rand(rng, d, nkv * hd) / 8, "wo": _rand(rng, nh * hd, d) / 8,
         "bq": _rand(rng, nh * hd), "bk": _rand(rng, nkv * hd),
         "bv": _rand(rng, nkv * hd)}
    x = _rand(rng, 2, S, d)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = jL.attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                        n_heads=nh, n_kv=nkv, hd=hd,
                        positions=jnp.asarray(pos), theta=10_000.0,
                        impl=impl)
    got = tL.attention(T.tree_map(torch.from_numpy, p), torch.from_numpy(x),
                       n_heads=nh, n_kv=nkv, hd=hd,
                       positions=torch.from_numpy(pos), theta=10_000.0,
                       impl=impl)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


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
    (dict(mesh="2x2"), "not yet ported"),
    (dict(backend="fsdp"), "not yet ported"),
    (dict(problem="mamba2-130m", d=128), "not yet ported"),
    (dict(leaf_codecs="*embed*=qsgd:16"), "not yet ported"),
    (dict(downlink="topk:64"), "not yet ported"),
    (dict(compressor="sign"), "not yet ported"),
    (None, "bad experiment spec")])
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
        if kw.get("mesh") == "2x2":
            kw.update(n=2)
        path = _write(tmp_path, ExperimentSpec(**kw))
    with pytest.raises(SystemExit, match=message):
        tlaunch.main(["--spec", path] + RUNTIME)
