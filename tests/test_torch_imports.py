"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch/``, ``paper_torch/`` or ``chip_smoke.py``, and a CUDA
request without a GPU raises instead of falling back to the CPU."""

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
    sorted((ROOT / "paper_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|,|$)",
                       re.MULTILINE)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread, for the reason test_torch_model.py's
    copy gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    from paper_torch import paper_fig2, paper_fig3

    tree = {"w": np.zeros((2, 3), np.float32)}
    smoke = build_model(get_smoke_config("qwen2-0.5b"))
    return [
        lambda: T.params_from_jax(tree, device="cuda"),
        lambda: smoke.init(device="cuda"),
        lambda: train.main(["--smoke", "--steps", "1"]),
        lambda: random.uniform(random.key(0), 10),
        lambda: random.bits(random.key(0), 10),
        lambda: compressor_bench.main([]),
        lambda: random.uniform_rows(random.split(random.key(0), 3), 10),
        lambda: paper_fig2.main([]),
        lambda: paper_fig3.main([]),
    ]


@pytest.mark.parametrize("which", range(9))
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


# -- the ssm and moe families against the JAX package -------------------------
#
# Seeded numpy inputs through the JAX function and the port's.  Tolerances:
# f32 activations rtol 1e-5 on the loss and 1e-4 of each leaf's largest
# gradient (matmul and reduction sums in another order); bf16 activations
# atol 1e-2 on the loss and 1.5e-2 on the global gradient norm's relative
# difference (bf16 rounds at other points; in the moe family a near-tie
# in the router can then send a token to another expert).

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

FAMILY_ARCHS = ["mamba2-130m", "granite-moe-3b-a800m", "dbrx-132b",
                "minicpm-2b", "zamba2-7b", "zamba2-7b@4", "whisper-medium",
                "qwen2-vl-2b"]


def _family(arch, adt="float32"):
    """(JAX config, port config, JAX's init as numpy) of an arch's smoke
    config with activations in ``adt``; ``arch@L`` at L layers (zamba2 at
    4: the shared block runs after layers 1 and 3)."""
    arch, _, layers = arch.partition("@")
    over = dict(activation_dtype=adt)
    if layers:
        over["n_layers"] = int(layers)
    jcfg = dataclasses.replace(jsmoke(arch), **over)
    tcfg = dataclasses.replace(tsmoke(arch), **over)
    params = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(0)))
    return jcfg, tcfg, params


def _with_extras(data, jcfg, global_batch):
    """``data``'s batches with the family's extras (the encdec's frames,
    the vlm's vision embeddings), drawn by JAX's ``family_batch_extras``;
    the port's copy (``launch.train.family_batch_extras``) gives the same
    bits."""
    from repro.train.loop import family_batch_extras as jextras
    from repro_torch.launch.train import family_batch_extras as textras

    class Batches:
        def batch(self, step):
            out = data.batch(step)
            extra = jextras(jcfg, global_batch, step)
            mine = textras(jcfg, global_batch, step)
            assert sorted(mine) == sorted(extra)
            for k in extra:
                np.testing.assert_array_equal(mine[k], extra[k])
            out.update(extra)
            return out
    return Batches()


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_family():
    """JAX's one-device reference of an arch's smoke config, computed once
    a module per (arch, activation dtype): ``ref(arch, adt)`` gives (JAX
    config, port config, JAX's init as numpy, the batch, loss, aux metrics,
    gradients, logits) of ``jax.value_and_grad(Model.loss)``."""
    cache = {}

    def ref(arch, adt):
        if (arch, adt) not in cache:
            jcfg, tcfg, params = _family(arch, adt)
            batch = _with_extras(SyntheticLM(
                vocab=1024, seq_len=64, global_batch=2, n_workers=1,
                seed=3), jcfg, 2).batch(0)
            jm = JModel(jcfg)
            (jloss, jaux), jgrads = jax.value_and_grad(
                lambda p: jm.loss(p, batch), has_aux=True)(params)
            jlogits, _ = jm.forward(params, batch)
            cache[arch, adt] = (jcfg, tcfg, params, batch, jloss, jaux,
                                jgrads, jlogits)
        return cache[arch, adt]
    return ref


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_loss_and_grads_match_jax(arch, adt, jax_family):
    """Logits, loss, its ``ce``/``aux_loss`` metrics and every leaf's
    gradient of the smoke archs of the moe, ssm, hybrid (also at 4 layers),
    encdec and vlm families and minicpm (two SSD chunks a sequence; the
    encdec's frames and the vlm's vision embeddings from JAX's batch
    extras), the port against ``repro.models.model.Model`` from the same
    params."""
    from repro_torch.train.trainer import value_aux_and_grad

    jcfg, tcfg, params, batch, jloss, jaux, jgrads, jlogits = \
        jax_family(arch, adt)
    tm = build_model(tcfg)
    with R._serial(torch.device("cpu")):
        tparams = T.params_from_jax(params, "cpu")
        tloss, taux, tgrads = value_aux_and_grad(tm.loss, tparams,
                                                 _tbatch(batch))
        tlogits = tm.forward(tparams, _tbatch(batch))
    assert sorted(taux) == sorted(jaux) == ["aux_loss", "ce"]
    jl, tl = jax.tree.leaves(jgrads), T.leaves(tgrads)
    assert len(jl) == len(tl) and all(torch.isfinite(b).all() for b in tl)
    if adt == "float32":
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-5)
        for k in ("ce", "aux_loss"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        for a, b in zip(jl, tl):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=1e-4 * float(np.abs(a).max()))
    else:
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-2)
        jn = np.sqrt(sum(float(np.sum(np.square(np.asarray(a, np.float64))))
                         for a in jl))
        tn = np.sqrt(sum(float(torch.sum(b.double() ** 2)) for b in tl))
        assert abs(tn - jn) <= 1.5e-2 * jn


# -- the model axis for every family: M gloo ranks on the CPU ----------------
#
# Each arch's smoke config in f32 on a ``model`` axis of M ranks, each rank
# holding its shards (``Model.param_specs``): the loss and every logical
# gradient, gathered from the shards, against JAX's one-device
# ``value_and_grad`` at the family test's tolerances (loss rtol 1e-5, each
# leaf atol 1e-4 of its largest entry), and against the port's one-rank run
# ten times tighter (loss rtol 1e-6, each leaf atol 1e-5 of its largest
# entry; measured 3e-6): the sharding changes only the order of the
# row-parallel and vocab-parallel sums.  An M-fold gradient fails both.  At
# M = 4 qwen2's 4 heads and 2 KV heads do not split whole (half a KV head
# a rank) and at M = 8 neither do its query heads: its attention runs on
# weights gathered on use.  A leaf the specs replicate gets the same
# gradient on every rank, bit for bit.

#: M -> the archs one spawn of M ranks runs
TP_FAMILY_CASES = {2: ["minitron-8b", "granite-moe-3b-a800m", "mamba2-130m",
                       "phi3-medium-14b", "qwen2-vl-2b", "dbrx-132b",
                       "whisper-medium", "minicpm-2b", "qwen2-0.5b",
                       "zamba2-7b"],
                   4: ["qwen2-0.5b"], 8: ["qwen2-0.5b"]}


def _tp_family_batch(tcfg):
    from repro_torch.launch.train import family_batch_extras

    batch = SyntheticLM(vocab=1024, seq_len=64, global_batch=2, n_workers=1,
                        seed=3).batch(0)
    batch.update(family_batch_extras(tcfg, 2, 0))
    return _tbatch(batch)


def _tp_family_rank(store, archs):
    """One rank of a 1xM mesh: per arch the loss, the logical gradients
    gathered from its shards (rank 0) and its replicated leaves'
    gradients."""
    from repro_torch.distributed.aggregate import ModelShards, WorkerGroup
    from repro_torch.train.trainer import value_and_grad

    world = int(os.environ["WORLD_SIZE"])
    group = WorkerGroup.join(1, backend="gloo", device="cpu",
                             init_method=f"file://{store}/tp",
                             model_size=world)
    out = {}
    try:
        for arch in archs:
            tcfg = dataclasses.replace(tsmoke(arch),
                                       activation_dtype="float32")
            model = build_model(tcfg)
            with R._serial(torch.device("cpu")):
                params = model.init(R.key(0), device="cpu")
            shards = ModelShards.of(group.model, model.param_specs(),
                                    model.init_abstract())
            loss, g = value_and_grad(
                lambda p, b: model.loss(p, b, tp=group.model),
                shards.shard_tree(params), _tp_family_batch(tcfg))
            whole = shards.gather_tree(g)
            out[arch] = {
                "loss": float(loss),
                "grads": whole if group.model.rank == 0 else None,
                "replicated": [x for x, d in zip(T.leaves(g), shards.dims)
                               if d is None]}
    finally:
        group.close()
    return out


@pytest.mark.parametrize("m", sorted(TP_FAMILY_CASES))
def test_model_axis_family_loss_and_grads_match_jax(m, jax_family,
                                                    tmp_path):
    from test_torch_model import _spawn_ranks

    from repro_torch.train.trainer import value_and_grad

    archs = TP_FAMILY_CASES[m]
    ranks = _spawn_ranks(tmp_path, m, _tp_family_rank, archs)
    for arch in archs:
        _, tcfg, params, batch, jloss, _, jgrads, _ = \
            jax_family(arch, "float32")
        model = build_model(tcfg)
        one_loss, one = value_and_grad(model.loss, T.params_from_jax(
            params, "cpu"), _tbatch(batch))
        for r in ranks:
            got = r[arch]["loss"]
            np.testing.assert_allclose(got, float(jloss), rtol=1e-5,
                                       err_msg=arch)
            np.testing.assert_allclose(got, float(one_loss), rtol=1e-6,
                                       err_msg=arch)
            for a, b in zip(r[arch]["replicated"],
                            ranks[0][arch]["replicated"]):
                assert torch.equal(a, b), arch
        paths = ["/".join(p) for p, _ in T.flatten_with_path(one)]
        got = T.leaves(ranks[0][arch]["grads"])
        assert len(got) == len(paths) == len(jax.tree.leaves(jgrads))
        for path, g, o, j in zip(paths, got, T.leaves(one),
                                 jax.tree.leaves(jgrads)):
            j = np.asarray(j)
            np.testing.assert_allclose(
                g.numpy(), j, rtol=0, atol=1e-4 * float(np.abs(j).max()),
                err_msg=f"{arch} {path}")
            np.testing.assert_allclose(
                g.numpy(), o.numpy(), rtol=0,
                atol=1e-5 * float(o.abs().max()), err_msg=f"{arch} {path}")


def _mamba2_layer(chunk):
    """One full-width mamba2 layer (d 768, d_inner 1536, 24 heads of 64,
    state 128) from ``mamba2_init(key(0))`` and x ~ N(0, 1) of shape
    (2, 128, 768), in f32."""
    kw = dict(d_inner=1536, d_state=128, n_heads=24)
    p, _ = jm2.mamba2_init(jax.random.key(0), 768, d_conv=4, **kw)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 128, 768)).astype(np.float32)
    r = rng.standard_normal((2, 128, 768)).astype(np.float32)

    def jloss(p, x):
        y = jm2.mamba2_apply(p, x, chunk=chunk, **kw)
        return jnp.sum(y * r), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        p, x)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    with R._serial(torch.device("cpu")):
        ty = tL.mamba2_apply(tp, tx, chunk=chunk, **kw)
        torch.sum(ty * torch.from_numpy(r)).backward()
    return jy, jg, ty.detach(), tp, tx


def test_ssd_gradient_finite_where_jax_is_nan():
    """ROADMAP fault w: at full width with chunk 128 JAX's
    ``where(causal, exp(diff), 0)`` has inf above the diagonal, and its
    gradient is NaN (the select's zero cotangent times inf); the port
    masks before the exp, so the forward is the same and every gradient
    finite."""
    jy, (jgp, jgx), ty, tp, tx = _mamba2_layer(128)
    assert not np.isfinite(np.asarray(jgx)).all()
    assert not all(np.isfinite(np.asarray(v)).all()
                   for v in jax.tree.leaves(jgp))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jy).max()))
    assert torch.isfinite(tx.grad).all()
    assert all(torch.isfinite(v.grad).all() for v in tp.values())


def test_ssd_gradient_matches_jax_at_chunk_32():
    """At the same full widths with chunk 32 (where JAX's decays stay below
    exp's overflow) the port's gradients match JAX's."""
    jy, (jgp, jgx), ty, tp, tx = _mamba2_layer(32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jy).max()))
    for name, v in tp.items():
        a = np.asarray(jgp[name])
        assert np.isfinite(a).all()
        np.testing.assert_allclose(v.grad.numpy(), a, rtol=0,
                                   atol=2e-4 * float(np.abs(a).max()))
    a = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), a, rtol=0,
                               atol=2e-4 * float(np.abs(a).max()))


def test_moe_routing_and_fixed_routing_match_jax():
    """The router's top-k (``expert_ids``) equals ``jax.lax.top_k``'s on
    granite-moe-smoke's probabilities, ties included (rows of equal
    probabilities go to the lowest indices); under
    ``fixed_routing_params`` every token goes to experts 0..k-1 in both
    packages, and the MoE layer's output and aux loss match JAX's."""
    jcfg, tcfg, params = _family("granite-moe-3b-a800m")
    E, k = jcfg.n_experts, jcfg.experts_per_tok
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    router = params["layers"]["moe"]["router"][0]
    probs = np.array(jax.nn.softmax(jnp.asarray(x @ router), axis=-1))
    probs[0, :3] = 0.25                       # four-way ties
    probs[1, 5] = [0.5, 0.25, 0.25, 0.0]
    jv, jids = jax.lax.top_k(jnp.asarray(probs), k)
    tv, tids = tL.top_k_lowest_ties(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    layer = {n: v[0] for n, v in params["layers"]["moe"].items()}
    for fixed in (False, True):
        p = jmoe.fixed_routing_params({"moe": layer})["moe"] if fixed \
            else layer
        tp = T.params_from_jax(p, "cpu")
        if fixed:
            zeros = torch.zeros((x.shape[0] * x.shape[1], E))
            _, ids = tL.top_k_lowest_ties(torch.softmax(zeros, -1), k)
            assert (ids == torch.arange(k)).all()
            assert float(tL.fixed_routing_params({"moe": tp})["moe"][
                "router"].abs().sum()) == 0.0
        jy, jaux = jmoe.moe_apply(p, x, n_experts=E, k=k)
        ty, taux = tL.moe_apply(tp, torch.from_numpy(x), n_experts=E, k=k)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(jy).max()))
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert tL.moe_capacity(32, 2, E, k, 1.25) == (2, max(1, int(
        1.25 * k * 16 / E)))
    assert tL.moe_capacity(3 * 5, 4, 40, 8, 1.25) == (3, 1)


def test_expert_mask_and_zeroing_bitwise():
    """``expert_activity_mask`` and ``zero_inactive_expert_grads`` (its own
    mask and a given one) equal JAX's bit for bit on stacked (L, E, a, b)
    slabs with zero experts, -0.0 and a NaN; non-MoE subtrees pass."""
    rng = np.random.default_rng(2)
    moe = {n: rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
           for n in tL.EXPERT_LEAVES}
    moe["router"] = rng.standard_normal((2, 6, 4)).astype(np.float32)
    for n in tL.EXPERT_LEAVES:
        moe[n][0, 1] = 0.0
        moe[n][1, 2] = -0.0
    moe["wg"][1, 3, 0, 0] = np.nan
    moe["wu"][0, 3] = 0.0                     # one slab of three zero
    tree = {"layers": {"moe": moe, "ln1": rng.standard_normal(
        (2, 6)).astype(np.float32)}, "embed": np.ones((3, 6), np.float32)}
    jm = jmoe.expert_activity_mask(moe)
    tm = tL.expert_activity_mask(T.params_from_jax(moe, "cpu"))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    given = np.array([[True, False, True, False], [False, True, True,
                                                   True]])
    for mask in (None, given):
        want = jmoe.zero_inactive_expert_grads(
            tree, None if mask is None else jnp.asarray(mask))
        got = tL.zero_inactive_expert_grads(
            T.params_from_jax(tree, "cpu"),
            None if mask is None else torch.from_numpy(mask))
        for a, b in zip(jax.tree.leaves(want), T.leaves(got)):
            a = np.asarray(a)
            np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                          a.view(np.uint32))


def _jax_trainer_round(jcfg, params, data, steps, grad_transform):
    """JAX's ``make_train_step`` on a 1x1 mesh (one worker): block-top-k
    (256, 16) up over the sparse all-gather, AdamW on a warmup-cosine
    schedule, step s under fold_in(key(0), s)."""
    from repro.core import compressors as jcomp
    from repro.core.efbv import EFBV as JEFBV
    from repro.launch.mesh import make_mesh
    from repro.optim import adamw as jadamw
    from repro.optim import cosine as jcosine
    from repro.train.trainer import init_train_state as jinit
    from repro.train.trainer import make_train_step as jmake

    mesh = make_mesh((1, 1))
    algo = JEFBV(jcomp.make_compressor("block_topk:256,16"), lam=0.37,
                 nu=0.61)
    opt = jadamw(jcosine(3e-4, total_steps=steps, warmup_steps=1),
                 weight_decay=0.01)
    state = jinit(jax.tree.map(jnp.asarray, params), opt, mesh)
    step = jmake(lambda p, b: JModel(jcfg).loss(p, b), opt, algo, mesh,
                 agg_mode="sparse_allgather", grad_transform=grad_transform)
    losses, metrics = [], None
    for s in range(steps):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                      data.batch(s).items()},
                              jax.random.fold_in(jax.random.key(0), s))
        losses.append(float(metrics["loss"]))
    return losses, state.params, metrics


@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-moe-3b-a800m",
                                  "zamba2-7b", "whisper-medium",
                                  "qwen2-vl-2b"])
def test_family_trainer_round_matches_jax_trainer(arch):
    """Two EF-BV rounds of the port's trainer against JAX's
    ``make_train_step`` (one worker, JAX's own trainer, not fault d's
    oracle): mamba2-, zamba2-, whisper- and qwen2-vl-smoke as they are
    (both trainers given the same batch extras), granite-moe-smoke under
    ``fixed_routing_params`` with ``grad_transform=
    zero_inactive_expert_grads`` (the expert-sparsity regime).  Losses
    within 1e-5 relative, params within 1e-5 (block-top-k on gradients
    that differ in their last bits), the same metric names."""
    from repro_torch.core import compressors as tcomp
    from repro_torch.core.efbv import EFBV
    from repro_torch.optim import adamw, cosine
    from repro_torch.train.trainer import init_train_state, make_train_step

    jcfg, tcfg, params = _family(arch)
    moe = arch.startswith("granite")
    if moe:
        params = jax.tree.map(np.asarray, jmoe.fixed_routing_params(params))
    data = _with_extras(SyntheticLM(vocab=1024, seq_len=32, global_batch=4,
                                    n_workers=1, seed=0), jcfg, 4)
    steps = 2
    jl, jparams, jm = _jax_trainer_round(
        jcfg, params, data, steps,
        jmoe.zero_inactive_expert_grads if moe else None)
    opt = adamw(cosine(3e-4, total_steps=steps, warmup_steps=1),
                weight_decay=0.01)
    algo = EFBV(tcomp.make_compressor("block_topk:256,16"), lam=0.37,
                nu=0.61)
    with R._serial(torch.device("cpu")):
        state = init_train_state(T.params_from_jax(params, "cpu"), opt,
                                 n_workers=1)
        step = make_train_step(
            build_model(tcfg).loss, opt, algo, n_workers=1,
            agg_mode="sparse_allgather",
            grad_transform=tL.zero_inactive_expert_grads if moe else None)
        tl = []
        for s in range(steps):
            state, tm = step(state, data.batch(s), R.fold_in(R.key(0), s))
            tl.append(float(tm["loss"]))
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jparams), T.leaves(state.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def test_checkpoints_move_between_packages_bitwise(tmp_path):
    """A checkpoint saved by the JAX package restores in the port bit for
    bit, and one saved by the port restores in JAX bit for bit: the same
    file name, '|'-joined leaf paths and spec entries; a spec-gated restore
    under another spec is refused in both, with the same text."""
    from repro.checkpoint import npz as jnpz
    from repro.core import ExperimentSpec as JSpec
    from repro_torch.core import ExperimentSpec

    _, tcfg, params = _family("mamba2-130m")
    tree = {"params": params}
    raw = dict(compressor="block_topk:256,16", agg="sparse_allgather",
               backend="shard_map", problem="mamba2-130m", smoke=True,
               mesh="2x1", n=2, d=128, steps=2)
    jspec, tspec = JSpec(**raw), ExperimentSpec(**raw)
    assert jspec.fingerprint() == tspec.fingerprint()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jnpz.save_checkpoint(jdir, 2, tree, spec=jspec)
    T.save_checkpoint(tdir, 2, T.params_from_jax(tree, "cpu"), spec=tspec)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == \
        ["step_00000002.npz"]
    assert T.latest_step(jdir) == jnpz.latest_step(tdir) == 2
    template = {"params": build_model(tcfg).init_abstract()}
    step, back = T.restore_latest(jdir, template, spec=tspec)
    jback = jnpz.restore_checkpoint(tdir, 2, tree, spec=jspec)
    for a, b, c in zip(jax.tree.leaves(tree), T.leaves(back),
                       jax.tree.leaves(jback)):
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      a.view(np.uint32))
        np.testing.assert_array_equal(np.asarray(c).view(np.uint32),
                                      a.view(np.uint32))
    assert T.saved_spec(jdir, 2) == tspec
    assert jnpz.saved_spec(tdir, 2) == jspec
    other = dataclasses.replace(tspec, seed=1)
    with pytest.raises(ValueError, match="refusing resume") as te:
        T.restore_checkpoint(jdir, 2, template, spec=other)
    with pytest.raises(ValueError, match="refusing resume") as je:
        jnpz.restore_checkpoint(tdir, 2, tree,
                                spec=dataclasses.replace(jspec, seed=1))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="mismatch"):
        T.restore_checkpoint(jdir, 2, {"params": {"embed": template[
            "params"]["embed"]}})


@pytest.mark.parametrize("arch,bits,ratio", [
    ("mamba2-130m", 1_371_136, "0.1254x"),
    ("granite-moe-3b-a800m", 6_829_056, "0.1250x"),
    ("zamba2-7b", 2_552_832, "0.1253x"),
    ("whisper-medium", 4_201_472, "0.1250x"),
    ("qwen2-vl-2b", 6_824_960, "0.1250x")])
def test_family_cli_smoke_prints_jaxs_bits(arch, bits, ratio, tmp_path,
                                           capsys):
    """The driver at ``--smoke`` on the moe, ssm, hybrid, encdec and vlm
    families prints JAX's ``wire.tree_format_for`` bits (over
    ``init_abstract()``); granite's step lines carry the aux loss; mamba2
    with ``--ckpt-dir`` and ``--ckpt-every 1`` writes a checkpoint a step
    that restores into the port's template."""
    from repro.core import compressors as jcomp
    from repro.distributed import wire as jwire
    from repro_torch.launch import train as tlaunch

    jfmt = jwire.tree_format_for(jcomp.make_compressor("block_topk:256,16"),
                                 JModel(jsmoke(arch)).init_abstract())
    assert jfmt.bits_per_round() == bits
    ckpt = str(tmp_path / "ckpt")
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--workers", "2",
            "--steps", "2", "--global-batch", "4", "--seq", "64",
            "--compressor", "block_topk:256,16", "--agg",
            "sparse_allgather", "--log-every", "1"]
    if arch.startswith("mamba2"):
        argv += ["--ckpt-dir", ckpt, "--ckpt-every", "1"]
    assert np.isfinite(tlaunch.main(argv))
    out = capsys.readouterr().out
    assert f" {bits} bits/round/worker uplink" in out and ratio in out
    assert out.count("[train] step") == 2
    assert out.count("aux_loss=") == (2 if "moe" in arch else 0)
    if arch.startswith("mamba2"):
        assert out.count("[train] checkpoint @") == 2
        assert T.latest_step(ckpt) == 2
        spec = tlaunch.experiment(tlaunch.parse_args(argv))
        assert T.saved_spec(ckpt, 2) == spec
