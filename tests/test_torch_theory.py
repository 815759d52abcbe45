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
