"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch/`` or ``chip_smoke.py``, and a CUDA request without a GPU
raises instead of falling back to the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|,|$)",
                       re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_port_package_imports_without_jax():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=env)


def _cuda_calls():
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch import random
    from repro_torch.launch import compressor_bench, train
    from repro_torch.models.model import build_model

    tree = {"w": np.zeros((2, 3), np.float32)}
    smoke = build_model(get_smoke_config("qwen2-0.5b"))
    return [
        lambda: T.params_from_jax(tree, device="cuda"),
        lambda: smoke.init(device="cuda"),
        lambda: train.main(["--smoke", "--steps", "1"]),
        lambda: random.uniform(random.key(0), 10),
        lambda: random.bits(random.key(0), 10),
        lambda: compressor_bench.main([]),
    ]


@pytest.mark.parametrize("which", range(6))
def test_cuda_request_without_gpu_raises(which):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        _cuda_calls()[which]()
