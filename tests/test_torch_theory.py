"""The port's copy of the tuning theory against ``repro.core.theory``.

``repro_torch/core/theory.py`` is a copy (the port imports nothing of
``repro``); these tests pin the two equal.  Tolerance: none -- the same
python float arithmetic gives the same floats.
"""

import dataclasses
import itertools

import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import compressors as jcomp
from repro.core import theory as jtheory
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import compressors as tcomp
from repro_torch.core import theory as ttheory
from repro_torch.core.efbv import EFBV
from repro_torch.launch.train import tuning_dim


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("mode", ["efbv", "ef21", "diana"])
def test_tune_for_block_topk_equal_at_both_model_sizes(smoke, mode):
    cfg = get_smoke_config("qwen2-0.5b") if smoke else get_config("qwen2-0.5b")
    jcfg = (jget_smoke_config("qwen2-0.5b") if smoke
            else jget_config("qwen2-0.5b"))
    d = tuning_dim(cfg)
    assert d == jcfg.d_model * jcfg.d_ff
    want = jtheory.tune_for(jcomp.make_compressor("block_topk:256,16"), d, 2,
                            mode=mode)
    got = ttheory.tune_for(tcomp.make_compressor("block_topk:256,16"), d, 2,
                           mode=mode)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    algo = EFBV.make(tcomp.BlockTopK(256, 16), d=d, n=2, mode=mode)
    assert (algo.lam, algo.nu) == (want.lam, want.nu)


ETA_OMEGA = [(0.0, 0.0), (0.968, 0.0), (0.0, 3.0), (0.5, 0.25), (0.9, 1.5)]


@pytest.mark.parametrize("eta,omega", ETA_OMEGA)
def test_scalings_equal(eta, omega):
    lam = jtheory.lambda_star(eta, omega)
    assert ttheory.lambda_star(eta, omega) == lam
    assert ttheory.r_of(lam, eta, omega) == jtheory.r_of(lam, eta, omega)
    assert ttheory.nu_star(eta, omega / 4) == jtheory.nu_star(eta, omega / 4)


@pytest.mark.parametrize("eta,omega", ETA_OMEGA)
@pytest.mark.parametrize("regime", ["pl", "nonconvex"])
def test_tune_with_stepsize_equal(eta, omega, regime):
    kw = dict(n=8, regime=regime, L=2.0, Ltilde=3.0, mu=0.1)
    got = ttheory.tune(eta, omega, **kw)
    want = jtheory.tune(eta, omega, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- the pipelined schedule ---------------------------------------------------

from repro.core.efbv import Pipeline as JPipeline  # noqa: E402
from repro_torch.core.efbv import Pipeline  # noqa: E402

PIPELINE_SPECS = ["block_topk:256,16", "qsgd:16", "randk:1048576",
                  "randk:4096"]


@pytest.mark.parametrize("eta,omega", ETA_OMEGA)
@pytest.mark.parametrize("depth", [0, 1])
def test_pipeline_eta_omega_equal(eta, omega, depth):
    assert ttheory.pipeline_eta(depth, eta) == jtheory.pipeline_eta(depth,
                                                                     eta)
    assert ttheory.pipeline_omega(depth, eta, omega) == \
        jtheory.pipeline_omega(depth, eta, omega)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("spec", PIPELINE_SPECS)
def test_make_pipelined_equal_at_both_model_sizes(smoke, spec):
    """EFBV.make(..., pipeline=1): (lam, nu) equal to JAX's, and the
    delay changes them wherever the sequential tuning is below 1."""
    cfg = get_smoke_config("qwen2-0.5b") if smoke else get_config("qwen2-0.5b")
    d = tuning_dim(cfg)
    want = jtheory.tune_for(jcomp.make_compressor(spec), d, 2, pipeline=1)
    got = ttheory.tune_for(tcomp.make_compressor(spec), d, 2, pipeline=1)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    algo = EFBV.make(tcomp.make_compressor(spec), d=d, n=2, pipeline=1)
    assert (algo.lam, algo.nu) == (want.lam, want.nu)
    seq = EFBV.make(tcomp.make_compressor(spec), d=d, n=2)
    assert EFBV.make(tcomp.make_compressor(spec), d=d, n=2, pipeline=0) == seq
    if seq.lam < 1.0:
        assert (algo.lam, algo.nu) != (seq.lam, seq.nu)


@pytest.mark.parametrize("spec", ["", "off", "depth:0", "depth:1", "depth:2",
                                  "depth:", "depth:x", "async", "depth:-1",
                                  "depth: 1", "Depth:1"])
def test_pipeline_parse_like_jax(spec):
    """Pipeline.parse accepts what JAX's accepts, with the same depth, and
    refuses what it refuses, with the same message."""
    try:
        want = JPipeline.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            Pipeline.parse(spec)
        assert str(got.value) == str(e)
    else:
        got = Pipeline.parse(spec)
        assert got.depth == want.depth and got.is_off == want.is_off


# -- the experiment spec (repro/core/spec.py) ---------------------------------
#
# ``repro_torch.core.ExperimentSpec`` and ``build`` against ``repro.core``'s:
# serialisation and fingerprints byte for byte (pinned on committed data:
# the example spec files, BENCH_perf.json's smoke fingerprints and
# BENCH_bits.json's rows), validation messages verbatim, tuning float for
# float.  Tolerance: none.

import json  # noqa: E402
import pathlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import ExperimentSpec as JSpec  # noqa: E402
from repro.core import SpecError as JSpecError  # noqa: E402
from repro.core import build as jbuild  # noqa: E402
from repro.core import efbv as jefbv  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import ExperimentSpec, SpecError, build  # noqa: E402
from repro_torch.core import efbv as tefbv  # noqa: E402
from repro_torch.core import mesh_worker_count  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SPEC_FILES = sorted((REPO / "examples" / "specs").glob("*.json"))
#: fingerprints of the committed example specs (JAX's; checked below too)
SPEC_FINGERPRINTS = {
    "federated_blocktopk": "df1f0db06faf5f7e",
    "finetune_moe": "f67bc877b3e73340",
    "pipelined_blocktopk": "17fc47abbc1bb2bf",
    "qsgd_bidirectional": "c5b268f9c4d8c701",
    "reference_logreg_efbv": "af1e7d8306f0d1bc",
    "serve_delta": "7d408c73e1bcf250",
    "tree_mixed_codecs": "2be2deb9ccc3fc78",
    "zoo_mamba2_fsdp": "6a9502177435874c",
    "zoo_qwen2_fsdp": "e379cbd8a0e45487",
}


@pytest.mark.parametrize("path", SPEC_FILES, ids=lambda p: p.stem)
def test_example_spec_round_trips_byte_for_byte(path):
    text = path.read_text()
    spec = ExperimentSpec.from_json(text)
    assert spec.to_json() == text
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert spec.fingerprint() == SPEC_FINGERPRINTS[path.stem]
    assert JSpec.from_json(text).fingerprint() == spec.fingerprint()
    assert spec.to_dict() == JSpec.from_json(text).to_dict()


def _smoke_fingerprint(pipeline="off", leaf_codecs=""):
    """``benchmarks/ci_bench.py``'s smoke_fingerprint with the port's spec:
    ``perf_iter.SMOKE`` (qwen2 smoke, mesh 2x2, 4 steps, block-top-k up,
    qsgd:16 down) and the port's tuning dimension of the smoke config."""
    from repro_torch.launch.train import tuning_dim
    return ExperimentSpec(
        compressor="block_topk:256,16", agg="sparse_allgather",
        downlink="qsgd:16", backend="shard_map", problem="qwen2-0.5b",
        smoke=True, mesh="2x2", n=mesh_worker_count((2, 2)),
        d=tuning_dim(get_smoke_config("qwen2-0.5b")), steps=4, seed=0,
        pipeline=pipeline, leaf_codecs=leaf_codecs).fingerprint()


def test_bench_perf_smoke_fingerprints():
    committed = json.loads((REPO / "BENCH_perf.json").read_text())
    want = {"smoke_train_step": "dca9d23b0248f332",
            "smoke_train_step_pipelined": "17fc47abbc1bb2bf",
            "smoke_train_step_tree": "6b63c1735cbf01d7"}
    assert {k: committed[k]["spec_fingerprint"] for k in want} == want
    assert _smoke_fingerprint() == want["smoke_train_step"]
    assert _smoke_fingerprint("depth:1") == want["smoke_train_step_pipelined"]
    assert _smoke_fingerprint(
        leaf_codecs="*embed*=qsgd:16;*norm*=identity") == \
        want["smoke_train_step_tree"]


def _bench_spec(up, down, d, n):
    """``benchmarks/ci_bench.py``'s _bench_spec with the port's spec."""
    agg = ("dense_psum" if len({s.strip() for s in up.split(";")}) > 1
           else "sparse_allgather")
    return ExperimentSpec(compressor=up, downlink=down or "", agg=agg,
                          backend="reference", problem="quadratic", n=n, d=d,
                          steps=1, seed=0)


def test_bench_bits_rows_exactly():
    """Every ``codec_bits_per_round`` and ``bidirectional_rounds`` row of
    the committed BENCH_bits.json: its key is the port spec's fingerprint
    and its bit counts are the port's ``Run.round_bits``."""
    bits = json.loads((REPO / "BENCH_bits.json").read_text())
    d, n = bits["d"], bits["n_workers"]
    for key, row in bits["codec_bits_per_round"].items():
        spec = _bench_spec(row["compressor"], None, d, n)
        assert spec.fingerprint() == key, row
        rb = build(spec).round_bits()
        assert rb["up"] == n * row["payload_bits"], row
        assert row["payload_bytes"] == row["payload_bits"] // 8
        assert round(row["payload_bits"] / (32 * d), 6) == \
            row["vs_dense_fp32"]
    assert len(bits["codec_bits_per_round"]) == 8
    for key, row in bits["bidirectional_rounds"].items():
        down = None if row["downlink_spec"] == "dense_fp32" \
            else row["downlink_spec"]
        spec = _bench_spec(row["uplink_spec"], down, d, n)
        assert spec.fingerprint() == key, row
        rb = build(spec).round_bits()
        assert (rb["up"], rb["down"], rb["total"]) == \
            (row["up_bits"], row["down_bits"], row["total_bits"]), row
        assert round(rb["total"] / rb["dense_both_ways"], 6) == \
            row["vs_dense_both_ways"]
    assert len(bits["bidirectional_rounds"]) == 4


CODEC_SPECS = ["identity", "topk:8", "randk:4", "scaled_randk:4", "comp:2,8",
               "mix:2,4", "block_topk:16,2", "sign", "natural", "qsgd:16",
               "frac_topk:50", "frac_comp:20,400"]
FLEET_SPECS = ["topk:7;qsgd:16;sign", "frac_topk:50;qsgd:16"]
DOWNLINK_SPECS = ["", "qsgd:16", "block_topk:16,2", "topk:48", "sign@0.9"]


@pytest.mark.parametrize("comp", CODEC_SPECS + FLEET_SPECS)
@pytest.mark.parametrize("down", DOWNLINK_SPECS)
def test_spec_json_and_fingerprint_equal_jax(comp, down):
    kw = dict(compressor=comp, downlink=down,
              agg="dense_psum" if ";" in comp else "sparse_allgather",
              n=8, d=96)
    spec = ExperimentSpec(**kw)
    assert spec.to_json() == JSpec(**kw).to_json()
    assert spec.fingerprint() == JSpec(**kw).fingerprint()
    assert ExperimentSpec.from_json(spec.to_json()) == spec


@pytest.mark.parametrize("argv", [
    "--compressor qsgd:16 --participation bernoulli:0.5 --downlink sign "
    "--n 5 --d 300 --steps 77 --seed 3 --resample --problem logreg",
    ["compressor=qsgd:16", "participation=bernoulli:0.5", "downlink=sign",
     "n=5", "d=300", "steps=77", "seed=3", "resample=true",
     "problem=logreg"],
    "--mode ef21 --gamma 0.25 --pipeline off --serve= --smoke=false"])
def test_spec_parse_like_jax(argv):
    spec = ExperimentSpec.parse(argv)
    assert spec.to_json() == JSpec.parse(argv).to_json()
    assert ExperimentSpec.from_json(spec.to_json()) == spec


def test_spec_fingerprint_ignores_field_order():
    spec = ExperimentSpec(compressor="qsgd:16", downlink="sign", n=4, d=128)
    reordered = dict(sorted(json.loads(spec.to_json()).items(),
                            reverse=True))
    assert ExperimentSpec.from_dict(reordered).fingerprint() == \
        spec.fingerprint()
    assert ExperimentSpec().fingerprint() == \
        ExperimentSpec(mode="efbv", seed=0).fingerprint()


BAD_SPECS = [
    dict(compressor="topk:4;qsgd:16", agg="sparse_allgather"),
    dict(compressor="qsgd:16;qsgd:16;qsgd:16", n=2),
    dict(participation="fixed:9", n=4),
    dict(backend="shard_map"),
    dict(backend="shard_map", mesh="2x2", n=4),
    dict(problem="qwen2-0.5b"),
    dict(backend="shard_map", mesh="2x2", n=2, problem="nope"),
    dict(mode="sgd"), dict(agg="ring"), dict(wire_dtype="int4"),
    dict(compressor="bogus:1"), dict(downlink="bogus:1"),
    dict(participation="sometimes"),
    dict(resample=True, problem="quadratic"), dict(mesh="2x2"), dict(n=0),
    dict(gamma=-1.0), dict(compressor=""), dict(smoke=True),
    dict(pipeline="depth:1"), dict(pipeline="depth:2"),
    dict(leaf_codecs="=qsgd:16"), dict(leaf_codecs="*=sign", mode="none"),
    dict(serve="gen:40"), dict(serve="replicas:2"),
    dict(backend="shard_map", mesh="2xq", n=2, problem="qwen2-0.5b"),
]


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda b: ",".join(
    f"{k}={v}" for k, v in b.items()))
def test_bad_specs_refused_with_jax_messages(bad):
    with pytest.raises(ValueError) as jerr:
        JSpec(**bad)
    with pytest.raises(ValueError) as terr:
        ExperimentSpec(**bad)
    assert str(terr.value) == str(jerr.value)
    assert isinstance(terr.value, SpecError) == \
        isinstance(jerr.value, JSpecError)


def test_unknown_fields_and_bad_values_refused_like_jax():
    cases = [lambda m: m.parse("--compresor qsgd:16"),
             lambda m: m.from_dict({"compresor": "qsgd:16"}),
             lambda m: m.from_dict({"spec_version": 99}),
             lambda m: m.parse("--n eight"),
             lambda m: m.parse("--resample maybe"),
             lambda m: m.parse(["--compressor"]),
             lambda m: m.parse("compressor")]
    for case in cases:
        with pytest.raises(JSpecError) as jerr:
            case(JSpec)
        with pytest.raises(SpecError) as terr:
            case(ExperimentSpec)
        assert str(terr.value) == str(jerr.value)


def test_build_and_run_surface_like_jax():
    with pytest.raises(SpecError, match="ExperimentSpec"):
        build("qsgd:16")
    assert build({"compressor": "qsgd:16"}).spec.compressor == "qsgd:16"
    assert build(ExperimentSpec(mode="none")).tuned is None
    spec = dict(compressor="qsgd:16", n=4, d=256,
                participation="bernoulli:0.5")
    t, j = build(ExperimentSpec(**spec)).tuned, jbuild(JSpec(**spec)).tuned
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    r = build(ExperimentSpec())
    with pytest.raises(SpecError, match="train_step|reference"):
        r.train_step(lambda p, b: (0.0, {}), None)
    with pytest.raises(SpecError, match="mesh"):
        r.make_mesh()
    assert repr(r).startswith(f"Run(fingerprint={r.spec.fingerprint()}")


def test_smoke_field_is_part_of_the_identity():
    full = ExperimentSpec(backend="shard_map", problem="qwen2-0.5b",
                          mesh="2x2", n=2, d=131072)
    smoke = dataclasses.replace(full, smoke=True)
    assert smoke.fingerprint() != full.fingerprint()
    assert smoke.fingerprint() == JSpec(**dataclasses.asdict(
        smoke)).fingerprint()


@pytest.mark.parametrize("kw,item", [
    (dict(leaf_codecs="*embed*=qsgd:16"), "item 6"),
    (dict(backend="fsdp", mesh="2x1", n=2, problem="qwen2-0.5b"), "item 8"),
    (dict(backend="fsdp", mesh="2x2", n=2, problem="qwen2-0.5b"),
     "item 8")])
def test_unported_run_surface_refused_with_its_roadmap_item(kw, item):
    r = build(ExperimentSpec(**kw))
    if "leaf_codecs" in kw:
        # item 6 is ported: round_bits under leaf rules is the TreeWire's,
        # JAX's own accounting (on the spec's flat vector and on a tree)
        assert r.round_bits() == jbuild(JSpec(**kw)).round_bits()
        tree = {"embed": torch.zeros(64, 8, device="meta"),
                "w": torch.zeros(300, device="meta")}
        jtree = {"embed": jnp.zeros((64, 8)), "w": jnp.zeros(300)}
        assert r.round_bits(tree) == jbuild(JSpec(**kw)).round_bits(jtree)
        return
    with pytest.raises(NotImplementedError, match=item):
        r.train_step(lambda p, b: (0.0, {}), None)
    if "mesh" in kw:
        # the mesh is ported (its geometry, the model axis); the fsdp
        # state's layout is not
        mesh = r.make_mesh()
        assert mesh.devices_shape == r.spec.mesh_dims()
        with pytest.raises(NotImplementedError, match="item 8"):
            r.state_shardings(mesh, None, None)


@pytest.mark.parametrize("kw,participants", [
    (dict(compressor="qsgd:16", downlink="block_topk:16,4",
          participation="fixed:3", agg="sparse_allgather", n=8, d=96), None),
    (dict(compressor="qsgd:16", agg="sparse_allgather", n=3, d=96), None),
    (dict(compressor="randk:8", downlink="sign", n=4, d=64), 2),
    (dict(compressor="topk:7;qsgd:16;sign", agg="dense_psum", n=6, d=96),
     None),
    (dict(compressor="topk:4;qsgd:16", agg="dense_psum",
          participation="bernoulli:0.5", n=8, d=64), None),
    (dict(compressor="topk:4;qsgd:16", agg="dense_psum",
          participation="fixed:3", n=8, d=64), None),
    (dict(compressor="block_topk:256,16", downlink="natural",
          participation="bernoulli:0.25", n=5, d=1000), None)])
def test_round_bits_equal_jax(kw, participants):
    """Exact wire accounting of one round, both ways: uplink (fleets,
    federated bitmap and expected payloads) and broadcast."""
    got = build(ExperimentSpec(**kw)).round_bits(participants=participants)
    want = jbuild(JSpec(**kw)).round_bits(participants=participants)
    assert got == want


# -- the tuning repair: the driver tunes as JAX's build(spec) does -----------

SWEEP_COMPRESSORS = ["block_topk:256,16", "qsgd:16", "randk:1048576",
                     "identity"]


@pytest.mark.parametrize("pipeline", ["off", "depth:1"])
@pytest.mark.parametrize("participation", ["full", "fixed:1",
                                           "bernoulli:0.5"])
@pytest.mark.parametrize("algo", ["efbv", "ef21", "diana", "none"])
@pytest.mark.parametrize("comp", SWEEP_COMPRESSORS)
def test_driver_tuning_equals_jax_build(comp, algo, participation, pipeline):
    """The port driver's (lam, nu) -- from ``build(experiment(args))`` --
    equal JAX's ``build(spec_from_args(args, n)).algo``, float for float,
    at full width and n = 2, participation included (before this, the port
    tuned every participation as full: block_topk:256,16 ran lam = nu = 1
    where JAX runs 0.016)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    flags = ["--compressor", comp, "--algo", algo, "--participation",
             participation, "--pipeline", pipeline, "--agg",
             "sparse_allgather", "--steps", "3"]
    jspec = jtrain.spec_from_args(
        jtrain.parse_args(["--arch", "qwen2-0.5b", "--mesh", "2x1"] + flags),
        2)
    spec = ttrain.experiment(ttrain.parse_args(
        ["--device", "cpu", "--workers", "2"] + flags))
    assert spec.fingerprint() == jspec.fingerprint()
    jalgo, algo_ = jbuild(jspec).algo, build(spec).algo
    assert (algo_.lam, algo_.nu) == (jalgo.lam, jalgo.nu)
    assert tcomp.format_compressor(algo_.compressor) == \
        ("identity" if algo == "none" else comp)


@pytest.mark.parametrize("participation", ["full", "fixed:1",
                                           "bernoulli:0.5"])
@pytest.mark.parametrize("comp,algo,pipeline", [
    ("block_topk:256,16", "efbv", "off"),
    ("block_topk:256,16", "ef21", "depth:1"),
    ("qsgd:16", "diana", "off"),
    ("randk:4096", "efbv", "off")])
def test_driver_setup_hands_the_trainer_jax_tuning(
        monkeypatch, capsys, comp, algo, participation, pipeline):
    """The algo that the driver's ``setup`` hands ``make_train_step`` and
    ``init_train_state`` on the smoke config (n = 2) has JAX's
    ``build(spec_from_args(args, 2)).algo`` (lam, nu), float for float, and
    the run header prints them."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    from repro_torch.train import trainer

    seen = {}
    make_step, init_state = trainer.make_train_step, trainer.init_train_state

    def spy_step(loss_fn, optimizer, algo_, **kw):
        seen["make_train_step"] = algo_
        return make_step(loss_fn, optimizer, algo_, **kw)

    def spy_init(*args, **kw):
        seen["init_train_state"] = kw["algo"]
        return init_state(*args, **kw)

    monkeypatch.setattr(trainer, "make_train_step", spy_step)
    monkeypatch.setattr(trainer, "init_train_state", spy_init)
    flags = ["--smoke", "--compressor", comp, "--algo", algo,
             "--participation", participation, "--pipeline", pipeline,
             "--agg", "sparse_allgather", "--steps", "2"]
    ttrain.setup(ttrain.parse_args(["--device", "cpu", "--workers", "2",
                                    "--global-batch", "4", "--seq", "8"]
                                   + flags))
    jalgo = jbuild(jtrain.spec_from_args(jtrain.parse_args(
        ["--arch", "qwen2-0.5b", "--mesh", "2x1"] + flags), 2)).algo
    assert sorted(seen) == ["init_train_state", "make_train_step"]
    for got in seen.values():
        assert (got.lam, got.nu) == (jalgo.lam, jalgo.nu)
    assert f"lam={jalgo.lam:.4g} nu={jalgo.nu:.4g}" in capsys.readouterr().out


@pytest.mark.parametrize("participation", [0.5, 0.25, None])
@pytest.mark.parametrize("comp", ["block_topk:256,16", "qsgd:16",
                                  "randk:4096", ["topk:64", "qsgd:16"]])
def test_make_with_participation_and_fleets_equal_jax(comp, participation):
    d = tuning_dim(get_config("qwen2-0.5b"))

    def members(mod):
        return ([mod.make_compressor(c) for c in comp]
                if isinstance(comp, list) else mod.make_compressor(comp))

    want = jefbv.EFBV.make(members(jcomp), d, 4, participation=participation)
    got = EFBV.make(members(tcomp), d, 4, participation=participation)
    assert (got.lam, got.nu) == (want.lam, want.nu)
    assert (got.fleet is None) == (want.fleet is None)
    for mode, fn in (("ef21", EFBV.ef21), ("diana", EFBV.diana)):
        j = jefbv.EFBV.make(members(jcomp), d, 4, mode=mode)
        t = fn(members(tcomp), d, 4)
        assert (t.lam, t.nu) == (j.lam, j.nu)


# -- Algorithm 1's reference driver (run_reference, Run.reference) -----------
#
# On the CPU with an exact elementwise gradient (x - B_i, B from numpy) the
# port's trajectories equal JAX's bit for bit -- x, h, h_avg, w, pending --
# for the deterministic codecs and rand-k / comp (whose draws are bitwise),
# at full, bernoulli and fixed participation, with the prox operators and
# the pipelined oracle.  That needs XLA's rounding at each site: fused
# h + lam*d and x - gamma*g; the worker mean as a sum in XLA's CPU order
# (worker order up to 32 workers, windows of 32 beyond) times f32(1/n); the master update's coefficient folded into that 1/n and
# contracted, fma(sum, f32(coef * 1/n), h); prox_l2 as a product with the
# f32 reciprocal.  QSGD, sign and natural reduce in torch's order (faults c
# and j): x within 1e-4 of max |x|.  With the problems' own matmul
# gradients (JAX's data carried across as numpy): x within 1e-4 of max
# |x| and f(x) within 1e-6 relative over 50 rounds (QSGD: 1e-3 and 1e-5).

N_REF, D_REF, STEPS_REF = 6, 32, 50
B_REF = np.random.default_rng(11).standard_normal((N_REF, D_REF)).astype(
    np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _assert_bitwise(j, t, what):
    for name, a, b in zip(("x", "h", "h_avg"), (j.x, j.state.h, j.state.h_avg),
                          (t.x, t.state.h, t.state.h_avg)):
        np.testing.assert_array_equal(_bits(b), _bits(a),
                                       err_msg=f"{what}: {name}")


def _elementwise_pair(gamma=0.05, **kw):
    """JAX's and the port's ``build(spec).reference()`` with the gradient
    x - B_i, 50 rounds."""
    kw = dict(dict(n=N_REF, d=D_REF, steps=STEPS_REF, seed=1), **kw)
    jB, tB = jnp.asarray(B_REF), torch.from_numpy(B_REF)
    j = jbuild(JSpec(**kw)).reference(grad_fn=lambda x: x[None] - jB,
                                      gamma=gamma)
    t = build(ExperimentSpec(**kw)).reference(
        grad_fn=lambda x: x[None] - tB, gamma=gamma, device="cpu")
    return j, t


@pytest.mark.parametrize("participation", ["full", "bernoulli:0.5",
                                           "fixed:3"])
@pytest.mark.parametrize("comp", ["identity", "topk:8", "block_topk:16,4",
                                  "randk:4", "comp:2,8", "mix:2,4",
                                  "scaled_randk:4", "frac_topk:100",
                                  "frac_comp:100,300", "topk:8;randk:4",
                                  "comp:3,10", "randk:3;comp:3,10;topk:5"])
def test_reference_bitwise_with_jax(comp, participation):
    """The batched round (the port's one ``batch`` call per leaf and fleet
    member, one ordered sum) against JAX's vmap (and its loop over a
    fleet's workers), the spec's ``compressor`` field with ';' a fleet."""
    kw = dict(agg="dense_psum") if ";" in comp else {}
    j, t = _elementwise_pair(compressor=comp, participation=participation,
                             **kw)
    _assert_bitwise(j, t, f"{comp} {participation}")
    assert t.w is None and t.state.step == STEPS_REF


@pytest.mark.parametrize("down", ["identity", "topk:8@0.9",
                                  "block_topk:16,4", "comp:2,8@0.7",
                                  "randk:8"])
def test_reference_downlink_bitwise_with_jax(down):
    """The broadcast: w + lam_s * decode(C_s(x - w)) fused; an identity
    downlink on the f32 wire assigns w = x verbatim."""
    j, t = _elementwise_pair(compressor="comp:2,8", downlink=down,
                             participation="fixed:3")
    _assert_bitwise(j, t, down)
    np.testing.assert_array_equal(_bits(t.w), _bits(j.w))
    if down == "identity":
        assert t.w is t.x


@pytest.mark.parametrize("comp", ["qsgd:16", "sign", "natural"])
def test_reference_random_codecs_within_tolerance(comp):
    j, t = _elementwise_pair(compressor=comp, participation="bernoulli:0.5")
    scale = float(np.abs(np.asarray(j.x)).max())
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("prox", ["l1", "l2"])
@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("participation", ["full", "fixed:3"])
def test_run_reference_prox_and_pipeline_bitwise(prox, depth, participation):
    """Direct run_reference calls: prox_l1 / prox_l2 and the pipelined
    oracle (round t applies round t-1's aggregate; ``pending`` is the last
    one), state and x bitwise."""
    kw = dict(compressor="comp:2,8", participation=participation,
              n=N_REF, d=D_REF)
    jrun, trun = jbuild(JSpec(**kw)), build(ExperimentSpec(**kw))
    jB, tB = jnp.asarray(B_REF), torch.from_numpy(B_REF)
    jp = {"l1": jefbv.prox_l1(0.02), "l2": jefbv.prox_l2(0.3)}[prox]
    tp = {"l1": tefbv.prox_l1(0.02), "l2": tefbv.prox_l2(0.3)}[prox]
    j = jefbv.run_reference(
        algo=jrun.algo, grad_fn=lambda k, x: x[None] - jB,
        x0=jnp.zeros(D_REF), gamma=0.05, steps=STEPS_REF,
        key=jax.random.key(4), n=N_REF, participation=jrun.participation,
        prox=jp, pipeline=jefbv.Pipeline(depth))
    t = tefbv.run_reference(
        algo=trun.algo, grad_fn=lambda k, x: x[None] - tB,
        x0=torch.zeros(D_REF), gamma=0.05, steps=STEPS_REF, key=R.key(4),
        n=N_REF, participation=trun.participation, prox=tp,
        pipeline=tefbv.Pipeline(depth))
    _assert_bitwise(j, t, f"{prox} depth {depth}")
    if depth:
        np.testing.assert_array_equal(_bits(t.pending), _bits(j.pending))
    else:
        assert t.pending is None


def _carried(jprob):
    """The port's problem on JAX's data (numpy across)."""
    from repro_torch.data.synthetic import LogReg, Quadratic

    arr = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if hasattr(jprob, "Q"):
        return Quadratic(arr(jprob.Q), arr(jprob.b))
    return LogReg(arr(jprob.A), arr(jprob.b), jprob.mu_reg)


@pytest.mark.parametrize("problem,resample", [
    ("logreg", False), ("logreg", True), ("quadratic", False)])
@pytest.mark.parametrize("comp", ["comp:2,8", "block_topk:16,4", "qsgd:16"])
def test_reference_matmul_gradients_within_tolerance(problem, resample,
                                                     comp):
    """The problems' own gradients on carried data, the auto-tuned stepsize
    (from each side's L and Ltilde: equal within 1e-6 relative) and
    minibatch resampling (randint draws bitwise)."""
    kw = dict(compressor=comp, problem=problem, resample=resample,
              participation="bernoulli:0.5", n=N_REF, d=D_REF,
              steps=STEPS_REF, seed=2)
    jrun, trun = jbuild(JSpec(**kw)), build(ExperimentSpec(**kw))
    jp = jrun.problem_instance()
    tp = _carried(jp)
    gamma = jrun._tune(L=jp.L(), Ltilde=jp.L_tilde()).gamma
    assert trun._tune(L=tp.L(), Ltilde=tp.L_tilde()).gamma == \
        pytest.approx(gamma, rel=1e-6)
    batch = max(1, N_REF and jp.A.shape[1] // 8) if resample else 0
    j = jrun.reference(
        grad_fn=(lambda k, x: jp.minibatch_grads(k, x, batch)) if resample
        else jp.grads, gamma=gamma, record=jp.f)
    t = trun.reference(
        grad_fn=(lambda k, x: tp.minibatch_grads(k, x, batch)) if resample
        else tp.grads, gamma=gamma, record=tp.f, device="cpu")
    # a QSGD level that rounds the other way (the norm is torch's
    # reduction) moves a coordinate by up to |d|/s: 1e-3 of max |x| there
    tol = 1e-3 if comp.startswith("qsgd") else 1e-4
    scale = float(np.abs(np.asarray(j.x)).max())
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(t.metrics.numpy(), np.asarray(j.metrics),
                               rtol=tol / 100)


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_reference_wire_dtype_within_tolerance(dt):
    """A bf16/f16 wire in the reference backend: the broadcast's top-k
    values round to the wire type and w tracks the rounded values, on
    logistic regression (JAX's data carried across), within the matmul
    tolerance above; with the gradient x - B_i, bitwise."""
    kw = dict(compressor="comp:2,8", problem="logreg", downlink="topk:8@0.9",
              wire_dtype=dt, n=N_REF, d=D_REF, steps=STEPS_REF, seed=2)
    jrun, trun = jbuild(JSpec(**kw)), build(ExperimentSpec(**kw))
    jp = jrun.problem_instance()
    tp = _carried(jp)
    gamma = jrun._tune(L=jp.L(), Ltilde=jp.L_tilde()).gamma
    j = jrun.reference(grad_fn=jp.grads, gamma=gamma, record=jp.f)
    t = trun.reference(grad_fn=tp.grads, gamma=gamma, record=tp.f,
                       device="cpu")
    scale = float(np.abs(np.asarray(j.x)).max())
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(t.metrics.numpy(), np.asarray(j.metrics),
                               rtol=1e-6)
    f32 = build(ExperimentSpec(**dict(kw, wire_dtype="float32"))).reference(
        grad_fn=tp.grads, gamma=gamma, device="cpu")
    assert not torch.equal(f32.w, t.w)
    j, t = _elementwise_pair(compressor="comp:2,8", downlink="topk:8@0.9",
                             wire_dtype=dt)
    _assert_bitwise(j, t, dt)
    np.testing.assert_array_equal(_bits(t.w), _bits(j.w))


def test_spec_reference_equals_direct_run_reference():
    """``build(spec).reference()`` with the built-in problem == a hand
    assembled run_reference (key fold_in(key(seed), REFERENCE_FOLD)),
    bitwise, in the port (test_spec.py's pin); and full participation ==
    an all-ones bernoulli mask through whole trajectories."""
    spec = ExperimentSpec(compressor="comp:2,16", problem="quadratic", n=6,
                          d=32, steps=15, seed=0, gamma=0.04)
    r = build(spec)
    prob = r.problem_instance("cpu")
    res = r.reference(record=prob.f, device="cpu")
    ref = tefbv.run_reference(
        algo=r.algo, grad_fn=lambda _k, x: prob.grads(x),
        x0=torch.zeros(32), gamma=0.04, steps=15,
        key=R.fold_in(R.key(0), tefbv.REFERENCE_FOLD), n=6, record=prob.f)
    _assert_bitwise(ref, res, "spec reference")
    np.testing.assert_array_equal(_bits(res.metrics), _bits(ref.metrics))
    assert res.w is None
    kw = dict(algo=r.algo, grad_fn=lambda _k, x: prob.grads(x),
              x0=torch.zeros(32), gamma=0.04, steps=8, key=R.key(3), n=6)
    a = tefbv.run_reference(**kw)
    b = tefbv.run_reference(
        participation=tefbv.Participation.parse("bernoulli:1.0"), **kw)
    _assert_bitwise(a, b, "full == bernoulli:1.0")


def test_reference_custom_grad_fn_needs_gamma():
    r = build(ExperimentSpec(n=2, d=8, steps=1))
    with pytest.raises(SpecError, match="gamma"):
        r.reference(grad_fn=lambda x: torch.zeros(2, 8), device="cpu")
    res = r.reference(grad_fn=lambda x: torch.zeros(2, 8), gamma=0.1,
                      device="cpu")
    assert tuple(res.x.shape) == (8,)


def test_reference_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(ExperimentSpec(n=2, d=8, steps=1)).reference()


@pytest.mark.parametrize("problem", ["logreg", "quadratic"])
def test_spec_reference_on_own_data_close_to_jax(problem):
    """Self-contained specs (the port draws its own data: uniforms bitwise,
    normals within 1e-5) land near JAX's trajectory: f(x) within 1e-5
    relative after 30 rounds."""
    kw = dict(compressor="comp:2,8", problem=problem, n=N_REF, d=D_REF,
              steps=30, seed=5)
    jrun, trun = jbuild(JSpec(**kw)), build(ExperimentSpec(**kw))
    jp, tp = jrun.problem_instance(), trun.problem_instance("cpu")
    j = jrun.reference(record=jp.f)
    t = trun.reference(record=tp.f, device="cpu")
    np.testing.assert_allclose(t.metrics.numpy(), np.asarray(j.metrics),
                               rtol=1e-5)


# -- the problems (repro/problems/logreg.py, spec.Quadratic) -----------------

@pytest.mark.parametrize("seed,N,d", [(0, 1024, 64), (3, 1792, 112)])
def test_make_synthetic_against_jax(seed, N, d):
    """Column-scale and flip uniforms bitwise; A within 1e-5 relative
    (erfinv, and exp's last ulp); labels equal wherever JAX's logit is
    above 1e-3 in magnitude (measured: equal everywhere)."""
    from repro.problems import make_synthetic as jmake
    from repro_torch.data.synthetic import make_synthetic

    jA, jb = (np.asarray(a) for a in jmake(jax.random.key(seed), N=N, d=d))
    tA, tb = make_synthetic(R.key(seed), N=N, d=d, device="cpu")
    np.testing.assert_allclose(tA.numpy(), jA, rtol=1e-5, atol=0)
    k = jax.random.split(jax.random.key(seed), 4)
    tk = R.split(R.key(seed), 4)
    for i, n_, lo, hi in ((0, d, -1.5, 1.5), (3, N, 0.0, 1.0)):
        np.testing.assert_array_equal(
            _bits(R.uniform(tk[i], n_, "cpu", minval=lo, maxval=hi)),
            _bits(jax.random.uniform(k[i], (n_,), minval=lo, maxval=hi)))
    logits = jA @ np.asarray(jax.random.normal(k[2], (d,))) / np.sqrt(d)
    sure = np.abs(logits) > 1e-3
    np.testing.assert_array_equal(tb.numpy()[sure], jb[sure])


def test_logreg_against_jax_on_carried_data():
    from repro.problems import LogReg as JLogReg
    from repro.problems import make_synthetic as jmake
    from repro_torch.data.synthetic import LogReg

    jA, jb = jmake(jax.random.key(1), N=256, d=16)
    arr = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    for overlap in (1, 2):
        jp = JLogReg.split(jA, jb, 5, 0.1, overlap=overlap,
                           key=jax.random.key(7), lam_nc=0.05)
        tp = LogReg.split(arr(jA), arr(jb), 5, 0.1, overlap=overlap,
                          key=R.key(7), lam_nc=0.05)
        np.testing.assert_array_equal(tp.A.numpy(), np.asarray(jp.A))
        np.testing.assert_array_equal(tp.b.numpy(), np.asarray(jp.b))
        x = np.random.default_rng(0).standard_normal(16).astype(np.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        np.testing.assert_allclose(tp.grads(tx).numpy(),
                                   np.asarray(jp.grads(jx)), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(tp.f(tx)), float(jp.f(jx)),
                                   rtol=1e-6)
        np.testing.assert_allclose(tp.L_i().numpy(), np.asarray(jp.L_i()),
                                   rtol=1e-6)
        assert tp.L() == pytest.approx(jp.L(), rel=1e-6)
        assert tp.L_max() == pytest.approx(jp.L_max(), rel=1e-6)
        k = jax.random.key(9)
        np.testing.assert_allclose(
            tp.minibatch_grads(R.key(9), tx, 6).numpy(),
            np.asarray(jp.minibatch_grads(k, jx, 6)), rtol=1e-5, atol=1e-6)
    jx_star, jf = jp.solve(steps=300)
    tx_star, tf = tp.solve(steps=300)
    assert tf == pytest.approx(jf, rel=1e-5)


def test_quadratic_against_jax():
    from repro.core import Quadratic as JQuadratic
    from repro_torch.data.synthetic import Quadratic

    jq = JQuadratic.make(4, 16, 3)
    tq = Quadratic.make(4, 16, 3, device="cpu")
    np.testing.assert_allclose(tq.Q.numpy(), np.asarray(jq.Q), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tq.b.numpy(), np.asarray(jq.b), rtol=1e-5)
    cq = _carried(jq)
    x = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(cq.grads(torch.from_numpy(x)).numpy(),
                               np.asarray(jq.grads(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    assert float(cq.f(torch.from_numpy(x))) == pytest.approx(
        float(jq.f(jnp.asarray(x))), rel=1e-5)
    assert cq.L() == pytest.approx(jq.L(), rel=1e-5)
    assert cq.L_tilde() == pytest.approx(jq.L_tilde(), rel=1e-5)
    assert cq.solve()[1] == pytest.approx(jq.solve()[1], rel=1e-5)


@pytest.mark.parametrize("lam", [0.9, 0.37])
@pytest.mark.parametrize("comp", ["sign", "qsgd:16", "natural", "identity",
                                  "topk:64", "block_topk:256,16", "randk:64",
                                  "comp:8,64"])
def test_downlink_update_rounds_as_jitted_jax(comp, lam):
    """w + lam_s * q as the jitted broadcast rounds it: twice after QSGD's
    and natural's decodes (they end in a select against zero), once
    (fused) after every other.  Inputs: w on a 2**-16 grid, x - w on a
    2**-10 grid, so the L1 and L2 sums are exact in any order and only the
    update's rounding can differ."""
    from repro.distributed import aggregate as jagg
    from repro_torch.distributed import aggregate as tagg

    rng = np.random.default_rng(4)
    n = 4096
    w = (rng.integers(-2**14, 2**14, n) * 2**-16).astype(np.float32)
    x = (w + rng.integers(-4, 5, n) * 2**-10).astype(np.float32)
    spec = f"{comp}@{lam}"
    jdl, tdl = jefbv.Downlink.parse(spec), tefbv.Downlink.parse(spec)
    jk = jefbv.downlink_key(jax.random.fold_in(jax.random.key(0), 2))
    tk = tefbv.downlink_key(R.fold_in(R.key(0), 2))
    jw, _ = jax.jit(lambda k, x, w: jagg.broadcast_global(jdl, k, x, w))(
        jk, jnp.asarray(x), jnp.asarray(w))
    tw, _ = tagg.broadcast_global(tdl, tk, torch.from_numpy(x),
                                  torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(tw), _bits(jw))


def test_compress_delta_leaf_rules_and_fleet_equal_jax():
    """Per-leaf rules resolve by path (first match, clamped to the leaf)
    and a fleet runs each worker's own member: compress_delta and the
    worker loop equal JAX's bitwise on a small tree."""
    rng = np.random.default_rng(3)
    tree = {"embed": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": {"norm": rng.standard_normal(7).astype(np.float32),
                       "w": rng.standard_normal((4, 9)).astype(np.float32)}}
    h = jax.tree.map(lambda a: (a * 0.25).astype(np.float32), tree)
    spec = "embed*=topk:4;*norm*=identity;block_topk:16,2"
    jalgo = jefbv.EFBV.make(jcomp.TopK(3), 64, 2,
                            leaf_rules=jwire_rules(spec))
    talgo = EFBV.make(tcomp.TopK(3), 64, 2,
                      leaf_rules=tcomp.parse_leaf_rules(spec))
    assert (talgo.lam, talgo.nu) == (jalgo.lam, jalgo.nu)
    want = jalgo.compress_delta(None, jax.tree.map(jnp.asarray, tree),
                                jax.tree.map(jnp.asarray, h))
    got = talgo.compress_delta(None, T.tree_map(torch.from_numpy, tree),
                               T.tree_map(torch.from_numpy, h))
    for a, b in zip(jax.tree.leaves(want), T.leaves(got)):
        np.testing.assert_array_equal(_bits(b), _bits(a))
    # a two-member fleet over 4 workers in the reference round
    kw = dict(compressor="topk:4;randk:8", agg="dense_psum", n=4, d=32,
              steps=20, seed=6)
    jB, tB = jnp.asarray(B_REF[:4]), torch.from_numpy(B_REF[:4])
    j = jbuild(JSpec(**kw)).reference(grad_fn=lambda x: x[None] - jB,
                                      gamma=0.05)
    t = build(ExperimentSpec(**kw)).reference(
        grad_fn=lambda x: x[None] - tB, gamma=0.05, device="cpu")
    assert build(ExperimentSpec(**kw)).algo.fleet is not None
    _assert_bitwise(j, t, "fleet")


def jwire_rules(spec):
    from repro.distributed import wire as jwire
    return jwire.parse_leaf_rules(spec)


# -- the batched round: Compressor.batch against JAX's vmap ------------------
#
# Every zoo family's ``batch(keys, X)`` on a worker-stacked (16, 6, 7) leaf
# against ``jax.vmap(C)(keys, X)`` jitted, and row i against the port's own
# ``C(keys[i], X[i])``.  On multiples of 1/64 with |x| <= 1 every L1 and L2
# sum is exact in any order and natural's exponents are exact in XLA too,
# so all thirteen are bitwise; on normal draws the families without a
# reduction stay bitwise, SignNorm and QSGD sum in torch's order (fault c:
# 222-252 of 672 values differ from JAX in their last bits here, within
# 1e-6 relative), and natural differs from JAX only where XLA's log2/exp2
# are inexact (fault j).  Against the port's per-worker call every family
# is bitwise on the CPU: torch reduces each row of an (n, d) tensor as it
# reduces the row alone (measured also at (16, 4096) and (1000, 112)).

BATCH_N, BATCH_SHAPE = 16, (6, 7)
BATCH_SPECS = ["identity", "topk:8", "randk:4", "scaled_randk:4", "comp:2,8",
               "mix:2,4", "block_topk:16,4", "sign", "natural", "qsgd:16",
               "frac_topk:100", "frac_comp:100,300", "mnice:16,5"]
NORM_FAMILIES = ("sign", "qsgd:16")


def _both_comps(spec):
    if spec.startswith("mnice"):
        n, m = (int(v) for v in spec.partition(":")[2].split(","))
        return jcomp.MNice(n, m), tcomp.MNice(n, m)
    return jcomp.make_compressor(spec), tcomp.make_compressor(spec)


def _batch_input(grid):
    rng = np.random.default_rng(21)
    shape = (BATCH_N,) + BATCH_SHAPE
    if grid:
        return (rng.integers(-64, 65, shape) / 64).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("grid", [True, False], ids=["exact_sums", "normal"])
@pytest.mark.parametrize("spec", BATCH_SPECS)
def test_batch_equals_jax_vmap(spec, grid):
    jc, tc = _both_comps(spec)
    x = _batch_input(grid)
    jk = jax.random.split(jax.random.key(8), BATCH_N)
    tk = R.split(R.key(8), BATCH_N)
    want = np.asarray(jax.jit(jax.vmap(jc.__call__))(jk, jnp.asarray(x)))
    got = tc.batch(tk, torch.from_numpy(x))
    assert tuple(got.shape) == x.shape
    loop = torch.stack([tc(tk[i], torch.from_numpy(x[i]))
                        for i in range(BATCH_N)])
    if grid or spec not in NORM_FAMILIES + ("natural",):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    elif spec == "natural":
        differs = _bits(got) != _bits(want)
        a = np.abs(x)
        near = np.abs(a / np.exp2(np.round(np.log2(a))) - 1) < 1e-6
        assert not np.any(differs & ~near)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_bits(got), _bits(loop))


def test_mnice_joint_batch_equals_jax_vmap():
    """The jointly-defined m-nice: one permutation of the round key and a
    select along the worker axis, equal to JAX's vmap of ``joint_call``
    over the worker index."""
    jc, tc = jcomp.MNice(16, 5), tcomp.MNice(16, 5)
    x = _batch_input(False)
    jk, tk = jax.random.key(9), R.key(9)
    want = jax.jit(jax.vmap(lambda i, v: jc.joint_call(jk, i, v)))(
        jnp.arange(16), jnp.asarray(x))
    got = tc.joint_batch(tk, torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert int((got.reshape(16, -1) != 0).any(dim=1).sum()) == 5


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("comp", ["randk:3", "topk:8;randk:3;comp:3,10",
                                  "frac_comp:100,300;randk:5"])
def test_reference_constant_scale_rounds_as_jitted_jax(comp, depth):
    """Fault u: a message that ends in a product by a constant that is not
    a power of two (rand-k's d/k = 32/3, comp's k'/k = 10/3).  Under vmap
    jitted JAX folds lam into it, h' = fma(y, f32(lam * c), h), and its
    fused reduce contracts the sum's products, fma(y, c, acc); over a
    fleet's stacked workers h' = fma(y * c, lam, h) and the unrolled sum
    contracts its first pair the other way when worker 0 is scaled.
    Sequential and pipelined, bitwise."""
    kw = dict(compressor=comp, n=N_REF, d=D_REF)
    if ";" in comp:
        kw["agg"] = "dense_psum"
    jrun, trun = jbuild(JSpec(**kw)), build(ExperimentSpec(**kw))
    jB, tB = jnp.asarray(B_REF), torch.from_numpy(B_REF)
    j = jefbv.run_reference(
        algo=jrun.algo, grad_fn=lambda k, x: x[None] - jB,
        x0=jnp.zeros(D_REF), gamma=0.05, steps=STEPS_REF,
        key=jax.random.key(4), n=N_REF, pipeline=jefbv.Pipeline(depth))
    t = tefbv.run_reference(
        algo=trun.algo, grad_fn=lambda k, x: x[None] - tB,
        x0=torch.zeros(D_REF), gamma=0.05, steps=STEPS_REF, key=R.key(4),
        n=N_REF, pipeline=tefbv.Pipeline(depth))
    _assert_bitwise(j, t, f"{comp} depth {depth}")
    if depth:
        np.testing.assert_array_equal(_bits(t.pending), _bits(j.pending))


@pytest.mark.parametrize("n,comp,participation,d", [
    (64, "comp:3,10", "full", D_REF),
    (40, "randk:3;comp:3,10;topk:5", "full", D_REF),
    (40, "topk:8;randk:4", "bernoulli:0.5", D_REF),
    (100, "randk:3", "bernoulli:0.5", D_REF),
    (1000, "comp:1,56", "full", 112)])
def test_reference_bitwise_with_jax_beyond_32_workers(n, comp, participation,
                                                      d):
    """Fault v: beyond 32 workers XLA's CPU reduce sums windows of 32 (the
    rows padded in front by half of -n % 32), and a constant scale is
    rounded into the message before the sum (fault u's contraction is
    gone); a fleet's unrolled sum keeps worker order at every n, its
    masked sum is a reduce (n = 40: padded windows; a fleet's JAX program
    grows with n).  Bitwise over 50 rounds, at n = 1000 on paper Figure
    2's mushrooms width."""
    kw = dict(compressor=comp, n=n, d=d, participation=participation)
    if ";" in comp:
        kw["agg"] = "dense_psum"
    jrun, trun = jbuild(JSpec(**kw)), build(ExperimentSpec(**kw))
    B = np.random.default_rng(12).standard_normal((n, d)).astype(np.float32)
    jB, tB = jnp.asarray(B), torch.from_numpy(B)
    full = participation == "full"
    j = jefbv.run_reference(
        algo=jrun.algo, grad_fn=lambda k, x: x[None] - jB, x0=jnp.zeros(d),
        gamma=0.05, steps=STEPS_REF, key=jax.random.key(4), n=n,
        participation=None if full else jrun.participation)
    t = tefbv.run_reference(
        algo=trun.algo, grad_fn=lambda k, x: x[None] - tB,
        x0=torch.zeros(d), gamma=0.05, steps=STEPS_REF, key=R.key(4), n=n,
        participation=None if full else trun.participation)
    _assert_bitwise(j, t, f"{comp} {participation} n={n}")


def test_reference_mnice_bitwise_with_jax():
    """An m-nice compressor at full participation (the spec grammar has no
    m-nice): direct run_reference calls, sequential and pipelined, below
    and beyond XLA's 32-row reduce window."""
    for n, depth in itertools.product((N_REF, 64), (0, 1)):
        B = B_REF if n == N_REF else np.random.default_rng(
            3).standard_normal((n, D_REF)).astype(np.float32)
        jB, tB = jnp.asarray(B), torch.from_numpy(B)
        j = jefbv.run_reference(
            algo=jefbv.EFBV(jcomp.MNice(n, 2), lam=0.25, nu=1.0),
            grad_fn=lambda k, x: x[None] - jB, x0=jnp.zeros(D_REF),
            gamma=0.05, steps=STEPS_REF, key=jax.random.key(5), n=n,
            pipeline=jefbv.Pipeline(depth))
        t = tefbv.run_reference(
            algo=EFBV(tcomp.MNice(n, 2), lam=0.25, nu=1.0),
            grad_fn=lambda k, x: x[None] - tB, x0=torch.zeros(D_REF),
            gamma=0.05, steps=STEPS_REF, key=R.key(5), n=n,
            pipeline=tefbv.Pipeline(depth))
        _assert_bitwise(j, t, f"m-nice n={n} depth {depth}")


#: configurations whose per-round draw calls, key copies and worker sums
#: must not depend on n: every family, a fleet, both sampled regimes, a
#: downlink, the prox, the pipeline and minibatch resampling
COUNT_CASES = {spec: dict(compressor=spec) for spec in BATCH_SPECS[:-1]}
COUNT_CASES.update({
    "fleet": dict(compressor="topk:8;randk:4;qsgd:16", agg="dense_psum"),
    "bernoulli": dict(compressor="comp:2,8", participation="bernoulli:0.5"),
    "fixed": dict(compressor="randk:4", participation="fixed:3"),
    "downlink": dict(compressor="comp:2,8", downlink="qsgd:16"),
    "resample": dict(compressor="comp:2,8", problem="logreg",
                     resample=True),
    # direct run_reference calls: the spec's reference refuses the pipeline
    # and has no m-nice or prox field
    "mnice": None, "prox": None, "pipelined": None,
})


def _count_round(monkeypatch, name, n, steps):
    """Draw calls (1-D and row draws), key copies and worker sums of a
    ``steps``-round reference run of COUNT_CASES[name] at n workers."""
    from repro_torch.kernels import ops, threefry

    counts = dict(draws=0, copies=0, sums=0)

    def counted(key, fn):
        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(threefry, "threefry_rows",
                        counted("draws", threefry.threefry_rows))
    monkeypatch.setattr(threefry, "threefry_fill",
                        counted("draws", threefry.threefry_fill))
    monkeypatch.setattr(R, "key_tensor", counted("copies", R.key_tensor))
    monkeypatch.setattr(ops, "worker_sum", counted("sums", ops.worker_sum))
    B = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, 16)).astype(np.float32))
    if COUNT_CASES[name] is None:
        comp = {"mnice": tcomp.MNice(n, 2), "prox": tcomp.RandK(4),
                "pipelined": tcomp.CompKK(2, 8)}[name]
        tefbv.run_reference(
            algo=EFBV(comp, lam=0.25, nu=1.0),
            grad_fn=lambda k, x: x[None] - B, x0=torch.zeros(16), gamma=0.05,
            steps=steps, key=R.key(5), n=n,
            prox=tefbv.prox_l1(0.01) if name == "prox" else tefbv.prox_zero,
            pipeline=tefbv.Pipeline(int(name == "pipelined")))
    else:
        run = build(ExperimentSpec(n=n, d=16, steps=steps, seed=1,
                                   **COUNT_CASES[name]))
        if COUNT_CASES[name].get("resample"):
            run.reference(device="cpu")
        else:
            run.reference(grad_fn=lambda x: x[None] - B, gamma=0.05,
                          device="cpu")
    monkeypatch.undo()
    return counts


@pytest.mark.parametrize("name", list(COUNT_CASES))
def test_reference_round_calls_do_not_grow_with_n(monkeypatch, name):
    """A round's draw calls, host-to-device key copies and worker sums are
    the same at n = 4 and n = 64 (per round: a 4-round run less a 1-round
    run, so the problem's own draws cancel); every round sums once per
    leaf."""
    per_round = {}
    for n in (4, 64):
        more = _count_round(monkeypatch, name, n, 4)
        less = _count_round(monkeypatch, name, n, 1)
        per_round[n] = {k: (more[k] - less[k]) / 3 for k in more}
    assert per_round[4] == per_round[64], per_round
    assert per_round[4]["sums"] == 1


# -- the paper's experiments on the port (paper_torch/) ----------------------

def test_paper_tab3_rows_equal_jax_string_for_string():
    from benchmarks import paper_tab3 as jtab3
    from paper_torch import paper_tab3 as ttab3

    want, got = jtab3.run(), ttab3.run()
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert got == want
    assert all(r["derived"].endswith("matches_paper=True") for r in got)


def test_paper_run_algorithm_matches_jax_on_carried_data():
    """``paper_torch.common.run_algorithm`` against
    ``benchmarks.common.run_algorithm`` on JAX's data carried across as
    numpy (n = 16, d = 112, 50 rounds of EF-BV and of EF21, JAX's f*):
    f(x) - f* within 1e-6 relative at every round."""
    from benchmarks import common as jcommon
    from paper_torch import common as tcommon
    from repro.problems import LogReg as JLogReg
    from repro.problems import make_synthetic as jmake

    jA, jb = jmake(jax.random.key(12), N=16 * 8, d=112)
    jp = JLogReg.split(jA, jb, n=16, mu_reg=0.1, key=jax.random.key(1))
    tp = _carried(jp)
    fstar = float(jp.solve(steps=400)[1])
    for mode in ("efbv", "ef21"):
        want = np.asarray(jcommon.run_algorithm(jp, mode, 1, 50, fstar))
        got = tcommon.run_algorithm(tp, mode, 1, 50, fstar, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["mushrooms", "phishing"])
def test_make_synthetic_at_fig2_sizes_against_jax(name):
    """The paper's data at Figure 2's sizes under the port's fixed key:
    every uniform and normal bitwise; only ``exp`` of the column scales
    (torch's against XLA's) may differ, by 1 ulp in a few columns, so A
    is within 2 ulps and the labels equal JAX's."""
    from paper_torch import common as tcommon
    from repro.problems import make_synthetic as jmake
    from repro_torch.data.synthetic import make_synthetic

    spec = tcommon.DATASETS[name]
    jk = jax.random.fold_in(jax.random.key(0), _crc_data(name))
    np.testing.assert_array_equal(tcommon.dataset_key(name),
                                  np.asarray(jax.random.key_data(jk)))
    jA, jb = (np.asarray(a) for a in jmake(jk, N=spec["N"], d=spec["d"]))
    tA, tb = (a.numpy() for a in make_synthetic(
        tcommon.dataset_key(name), N=spec["N"], d=spec["d"], device="cpu"))
    ulps = np.abs(jA.view(np.int32).astype(np.int64)
                  - tA.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    np.testing.assert_array_equal(tb, jb)
    jks = jax.random.split(jk, 4)
    tks = R.split(tcommon.dataset_key(name), 4)
    ju = jax.random.uniform(jks[0], (spec["d"],), minval=-1.5, maxval=1.5)
    np.testing.assert_array_equal(
        _bits(R.uniform(tks[0], spec["d"], "cpu", minval=-1.5, maxval=1.5)),
        _bits(ju))
    np.testing.assert_array_equal(
        _bits(R.normal(tks[1], spec["N"] * spec["d"], "cpu")),
        _bits(jax.random.normal(jks[1], (spec["N"] * spec["d"],))))
    col = np.abs(_bits(torch.exp(R.uniform(tks[0], spec["d"], "cpu",
                                           minval=-1.5, maxval=1.5)))
                 .astype(np.int64) - _bits(jnp.exp(ju)).astype(np.int64))
    assert col.max() <= 1


def _crc_data(name):
    import zlib
    return zlib.crc32(name.encode()) % 2**31


# -- the theory functions no other port test names ---------------------------

@pytest.mark.parametrize("p", [1.0, 0.5, 0.125])
@pytest.mark.parametrize("eta,omega", ETA_OMEGA)
def test_participation_constants_equal(p, eta, omega):
    assert ttheory.participation_eta(p, eta) == jtheory.participation_eta(
        p, eta)
    assert ttheory.participation_omega(p, eta, omega) == \
        jtheory.participation_omega(p, eta, omega)
    for fn in (lambda m: m.participation_eta(0.0, eta),
               lambda m: m.participation_omega(1.5, eta, omega)):
        with pytest.raises(ValueError) as jerr:
            fn(jtheory)
        with pytest.raises(ValueError) as terr:
            fn(ttheory)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("eta,omega", ETA_OMEGA)
def test_tune_pipelined_and_iteration_complexity_equal(eta, omega, depth):
    kw = dict(n=8, L=2.0, Ltilde=3.0, mu=0.1, omega_av=omega / 8)
    j = jtheory.tune_pipelined(eta, omega, depth, **kw)
    t = ttheory.tune_pipelined(eta, omega, depth, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    outcome = []
    for mod, tun in ((jtheory, j), (ttheory, t)):
        try:  # r = 0 (no compression) divides by zero in both
            outcome.append(mod.iteration_complexity(2.0, 3.0, 0.1, tun))
        except ZeroDivisionError as e:
            outcome.append(repr(e))
    assert outcome[0] == outcome[1]


@pytest.mark.parametrize("aggregate", ["worst", "mean"])
def test_fleet_and_tree_constants_equal(aggregate):
    etas, omegas = [0.0, 0.5, 0.9], [3.0, 0.25, 0.0]
    for n in (None, 4):
        assert ttheory.fleet_constants(etas, omegas, n=n,
                                       aggregate=aggregate) == \
            jtheory.fleet_constants(etas, omegas, n=n, aggregate=aggregate)
        for sizes in (None, [10, 100, 1000]):
            assert ttheory.tree_constants(etas, omegas, sizes, n=n,
                                          aggregate=aggregate) == \
                jtheory.tree_constants(etas, omegas, sizes, n=n,
                                       aggregate=aggregate)
