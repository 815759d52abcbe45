"""The port's copy of the tuning theory against ``repro.core.theory``.

``repro_torch/core/theory.py`` is a copy (the port imports nothing of
``repro``); these tests pin the two equal.  Tolerance: none -- the same
python float arithmetic gives the same floats.
"""

import dataclasses

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
