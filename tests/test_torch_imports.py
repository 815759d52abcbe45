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


# -- the committed 2x2 specs run from the port's driver -----------------------

SPECS_2X2 = {
    # spec file -> exact bits it prints: uplink per worker, and the
    # downlink broadcast and round total where it has a downlink
    "pipelined_blocktopk.json": [5_776_384, 11_553_216, 23_105_984],
    "qsgd_bidirectional.json": [11_553_216, 11_553_216, 34_659_648],
    "federated_blocktopk.json": [5_776_384],
    # per-leaf codecs: QSGD on the embedding, the final norm dense,
    # block-top-k elsewhere (BENCH_bits tree_wire)
    "tree_mixed_codecs.json": [6_832_160],
}


@pytest.mark.parametrize("name", sorted(SPECS_2X2))
def test_committed_2x2_spec_runs_on_four_ranks(name):
    """``examples/specs/<name>`` (mesh 2x2: 2 workers x 2-way tensor
    parallelism) through ``--spec`` on four gloo ranks under torchrun, as a
    user runs it: exit 0, the file's fingerprint, its exact bits and four
    finite losses; nothing imports JAX."""
    from repro_torch.core import ExperimentSpec

    path = ROOT / "examples" / "specs" / name
    spec = ExperimentSpec.from_json(path.read_text())
    assert spec.mesh == "2x2" and spec.smoke
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--spec", str(path), "--device", "cpu", "--dist-backend", "gloo",
         "--global-batch", "8", "--seq", "32", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert re.findall(r"spec fingerprint=([0-9a-f]{16})", out) == \
        [spec.fingerprint()]
    assert " mesh=2x2 ranks=4 backend=gloo " in out
    bits = [int(x) for x in re.findall(
        r"(\d+) bits/round(?:/worker)? (?:uplink|broadcast|up\+down)", out)]
    assert bits == SPECS_2X2[name]
    losses = [float(x) for x in re.findall(r"step\s+\d+ loss=(\S+)", out)]
    assert len(losses) == 4 and all(np.isfinite(losses))
    if spec.pipeline == "depth:1":
        assert "step     0 loss=" in out and "|g|=0.000" in out.split(
            "step     1")[0]
    if spec.participation != "full":
        assert " participation=bernoulli:0.5 " in out
        assert len(re.findall(r"\|S\|=\d/2 ", out)) == 4


# -- the per-leaf wire from the CLI, and a mixed-dtype payload on two ranks ---

LEAF_FLAGS = ["--smoke", "--device", "cpu", "--agg", "sparse_allgather",
              "--leaf-codecs", "*embed*=qsgd:16;*norm*=identity",
              "--steps", "2", "--global-batch", "8", "--seq", "32",
              "--log-every", "1"]


def test_leaf_codecs_cli_prints_jaxs_bits_line(capsys):
    """``--leaf-codecs`` prints the JAX driver's wire line character for
    character (reckoned from JAX's ``tree_format_for`` on its own smoke
    params, as its driver prints it), and the header names the rules."""
    from repro.configs import get_smoke_config
    from repro.core.compressors import BlockTopK
    from repro.distributed import wire as jwire
    from repro.models import build_model
    from repro_torch.launch import train

    params = build_model(get_smoke_config("qwen2-0.5b")).init_abstract()
    fmt = jwire.tree_format_for(
        BlockTopK(256, 16), params,
        rules=jwire.parse_leaf_rules("*embed*=qsgd:16;*norm*=identity"))
    up, dense = fmt.bits_per_round(), fmt.dense_bits()
    kinds = sorted({leaf.kind for leaf in fmt.leaves})
    want = (f"[train] wire: codec={','.join(kinds)} {up} bits/round/worker "
            f"uplink ({up / 8 / 2**20:.2f} MiB, "
            f"{up / max(dense, 1):.4f}x dense fp32)")
    assert want == ("[train] wire: codec=block_sparse,dense_pack,qsgd_quant "
                    "6832160 bits/round/worker uplink (0.81 MiB, 0.1478x "
                    "dense fp32)")
    assert np.isfinite(train.main(LEAF_FLAGS))
    out = capsys.readouterr().out
    assert want in out.splitlines()
    assert " leaf_codecs=*embed*=qsgd:16;*norm*=identity " in out


def test_mixed_dtype_payload_two_ranks_equal_one_process():
    """int8 levels, an f32 norm, bf16 values and int32 indices in one byte
    buffer: two gloo ranks (one worker each) print every step as the
    one-process run does (both on one thread), the bf16 wire's bits
    (block-top-k values at 16 bits) included."""
    flags = LEAF_FLAGS + ["--wire-dtype", "bfloat16"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

    def steps(out):
        return [re.sub(r"\(\S+s/step\)", "", line) for line in
                out.splitlines() if "] step " in line or "bits/round" in line]

    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *flags], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags,
         "--dist-backend", "gloo"], capture_output=True, text=True,
        timeout=300, env=env, cwd=ROOT)
    assert two.returncode == 0, two.stderr[-3000:]
    assert steps(two.stdout) == steps(one.stdout)
    assert len(steps(one.stdout)) == 3
    assert "codec=block_sparse,dense_pack,qsgd_quant 5646368 " \
        "bits/round/worker" in one.stdout
