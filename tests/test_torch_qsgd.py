"""The port's QSGD quantize-and-pack (kernel wrapper, plain version,
codec, compressor, downlink) against the JAX package.

The norm ||g - h||_2 is a large f32 reduction that torch and XLA sum in
different orders, so the two may differ in their last bits (measured
below: up to 7 ulp on 65k-value vectors, within the 8 ulp asserted).
Everything else is pinned bit for bit given the norm:

* the kernel wrapper (its plain version on CPU tensors) against JAX's
  ``ops.qsgd_pack_update(..., interpret=True)``, the Pallas kernel in
  interpret mode, given the same u and JAX's norm;
* the codec, the compressor and the downlink broadcast, which compute
  their own norm, against JAX's jitted counterparts given the same key, on
  inputs whose squared sums are exact in f32 (multiples of 2**-10 with
  small integer numerators), so both reductions give the exact norm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import compressors as jcomp
from repro.core import efbv as jefbv
from repro.distributed import aggregate as jagg
from repro.distributed import wire as jwire
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro_torch import random as R
from repro_torch import tree as T
from repro_torch.core import compressors as tcomp
from repro_torch.core import efbv as tefbv
from repro_torch.distributed import aggregate as tagg
from repro_torch.distributed import wire as twire
from repro_torch.kernels import LAUNCHES, ops, pack, ref, reset_launches

LAM = 0.37


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread, for the reason test_torch_model.py's
    copy gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(want, got):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert want.shape == got.shape and want.dtype == got.dtype, \
        (want.shape, got.shape, want.dtype, got.dtype)
    np.testing.assert_array_equal(_bits(want), _bits(got))


def _inputs(n, case, seed=0):
    rng = np.random.default_rng(seed + n)
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.standard_normal(n).astype(np.float32)
    u = rng.random(n, dtype=np.float32)
    if case == "zero":        # all-zero delta: norm 0, safe = 1
        g = h.copy()
    elif case == "negzero":   # -0.0 in g, h and delta
        g[::3], h[::3] = -0.0, 0.0
        g[1::5], h[1::5] = -0.0, -0.0
        h[2::7] = -0.0
    elif case == "nan1":      # one NaN: the norm is NaN, safe = 1
        g[n // 2] = np.nan
    elif case == "nan_all":
        g[:] = np.nan
    return g, h, u


def _pack_both(g, h, u, s):
    norm = jnp.linalg.norm(jnp.asarray(g) - jnp.asarray(h))
    want = jops.qsgd_pack_update(jnp.asarray(g), jnp.asarray(h),
                                 jnp.asarray(u), norm, LAM, s,
                                 interpret=True)
    got = ops.qsgd_pack_update(torch.from_numpy(g), torch.from_numpy(h),
                               torch.from_numpy(u),
                               torch.tensor(np.asarray(norm)), LAM, s)
    return want, got


@pytest.mark.parametrize("s", [16, 7, 400])
@pytest.mark.parametrize("n", [1_000, 65_536, 70_001])
def test_pack_update_bitwise_vs_pallas_interpret(s, n):
    want, got = _pack_both(*_inputs(n, "rand"), s)
    for w, t in zip(want, got):
        _same(w, t)
    assert got[0].dtype == (torch.int8 if s <= 127 else torch.int16)
    assert int(got[0].abs().max()) <= s


@pytest.mark.parametrize("s", [16, 400])
@pytest.mark.parametrize("case", ["zero", "negzero", "nan1", "nan_all"])
def test_pack_update_edge_cases_bitwise(case, s):
    """norm 0; -0.0 inputs; a NaN makes the norm NaN and safe = 1: the NaN
    lane gets level 0 and h + lam * 0, every lane with a nonzero level a
    NaN h_out (XLA's conversion turns a NaN level into 0)."""
    g, h, u = _inputs(70_001, case)
    want, got = _pack_both(g, h, u, s)
    for w, t in zip(want, got):
        _same(w, t)
    lv, h_out = (x.numpy() for x in got)
    if case == "zero":
        assert not lv.any()
    if case.startswith("nan"):
        assert lv[np.isnan(g)].tolist() == [0] * int(np.isnan(g).sum())
        assert np.array_equal(np.isnan(h_out), lv != 0)


def _exact_sum_vector(rng, shape, scale=2**-10):
    """Values k * scale, |k| <= 4: every squared sum up to 2**20 terms is
    an exact f32, so any reduction order gives the same norm."""
    return (rng.integers(-4, 5, shape) * scale).astype(np.float32)


def _exact_gh(n, case, seed):
    """g, h as multiples of 2**-10 whose difference has an exact squared
    sum in f32 (|k| <= 8, plus 64 spikes of |k| <= 64 that spread the
    levels), so torch and XLA give the same norm."""
    rng = np.random.default_rng(seed)
    h = _exact_sum_vector(rng, (n,))
    g = _exact_sum_vector(rng, (n,))
    g[rng.choice(n, 64, replace=False)] = \
        rng.integers(-60, 61, 64) * 2**-10
    if case == "nan1":
        g[n // 2] = np.nan
    return g, h


def _codec(n, s):
    return (jwire.QsgdQuant(shape=(n,), size=n, s=s),
            twire.QsgdQuant(shape=(n,), size=n, s=s))


@pytest.mark.parametrize("s", [16, 7, 400])
def test_codec_encode_decode_bitwise(s):
    n = 5_000
    jc, tc = _codec(n, s)
    jk = jax.random.fold_in(jax.random.key(1), 3)
    tk = R.fold_in(R.key(1), 3)
    g, h = _exact_gh(n, "rand", seed=s)
    delta = g - h
    jnorm, jlv = jax.jit(jc.encode)(jk, jnp.asarray(delta))
    tnorm, tlv = tc.encode(tk, torch.from_numpy(delta))
    _same(jnorm, tnorm)
    _same(jlv, tlv)
    _same(jax.jit(jc.decode)((jnorm, jlv)), tc.decode((tnorm, tlv)))
    # the all-gather form: two workers stacked, decoded and summed
    jk2 = jax.random.fold_in(jax.random.key(1), 4)
    jn2, jl2 = jax.jit(jc.encode)(jk2, jnp.asarray(-2.0 * delta))
    stacked = (jnp.stack([jnorm, jn2]), jnp.stack([jlv, jl2]))
    want = jax.jit(jc.decode_sum)(stacked)
    got = tc.decode_sum(tuple(torch.tensor(np.asarray(x))
                              for x in stacked))
    _same(want, got)


@pytest.mark.parametrize("case", ["rand", "nan1"])
@pytest.mark.parametrize("kernel", ["auto", "oracle"])
@pytest.mark.parametrize("s", [16, 400])
def test_codec_encode_update_bitwise(kernel, s, case):
    """Both port paths against JAX's jitted oracle and its interpret-mode
    kernel, which agree with each other bit for bit (a NaN included)."""
    n = 70_001
    jc, tc = _codec(n, s)
    jk = jax.random.fold_in(jax.random.key(0), 11)
    tk = R.fold_in(R.key(0), 11)
    g, h = _exact_gh(n, case, seed=7)
    jg, jh = jnp.asarray(g), jnp.asarray(h)
    want = jax.jit(lambda k, g, h: jc.encode_update(
        k, g, h, LAM, kernel="oracle"))(jk, jg, jh)
    want_i = jc.encode_update(jk, jg, jh, LAM, kernel="interpret")
    (tn, tl), th = tc.encode_update(
        tk, torch.from_numpy(g), torch.from_numpy(h), LAM, kernel=kernel)
    for w in (want, want_i):
        (wn, wl), wh = w
        _same(wn, tn)
        _same(wl, tl)
        _same(wh, th)


def test_norm_within_8_ulp_of_jax(capsys):
    """Fault (c) of the reduction order, recorded: torch's norm against
    XLA's jitted one on 50 vectors of about 65k values.  With torch
    2.13.0+cpu and jax 0.9.0: 4 of 50 equal, the worst 7 ulp apart (a
    relative difference of 4.13 * 2**-23); XLA's norm lies within 1 ulp of
    the exact one, torch's within 7."""
    rng = np.random.default_rng(0)
    jnorm = jax.jit(jnp.linalg.norm)
    exact, worst = 0, 0.0
    for i in range(50):
        x = (rng.standard_normal(65_536 + i) * 10.0 ** rng.uniform(-4, 2)
             ).astype(np.float32)
        a = np.float32(jnorm(jnp.asarray(x)))
        b = np.float32(torch.linalg.vector_norm(torch.from_numpy(x)))
        ulps = abs(float(a) - float(b)) / float(np.spacing(a))
        worst = max(worst, ulps)
        exact += bool(a == b)
    with capsys.disabled():
        print(f"\n[qsgd norm] torch == jax on {exact}/50 vectors; "
              f"worst {worst:g} ulp")
    assert worst <= 8


@pytest.mark.parametrize("s", [16, 7, 400])
@pytest.mark.parametrize("shape", [(1_000,), (64, 300)])
def test_qsgd_call_bitwise(s, shape):
    x = _exact_sum_vector(np.random.default_rng(s), shape)
    jk = jax.random.fold_in(jax.random.key(2), 5)
    want = jax.jit(jcomp.QSGD(s).__call__)(jk, jnp.asarray(x))
    got = tcomp.QSGD(s)(R.fold_in(R.key(2), 5), torch.from_numpy(x))
    _same(want, got)


def test_qsgd_call_zero_vector():
    want = jcomp.QSGD(16)(jax.random.key(0), jnp.zeros(300, jnp.float32))
    got = tcomp.QSGD(16)(R.key(0), torch.zeros(300))
    _same(want, got)


@pytest.mark.parametrize("s", [16, 400])
def test_payload_bits_exact(s):
    jtree = jbuild_model(jget_smoke_config("qwen2-0.5b")).init_abstract()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    ttree = build_model(get_smoke_config("qwen2-0.5b")).init_abstract()
    jf = jwire.format_for(jcomp.QSGD(s), jtree)
    tf = twire.format_for(tcomp.QSGD(s), ttree)
    assert [l.payload_bits for l in tf.leaves] == \
        [l.payload_bits for l in jf.leaves]
    assert tf.bits_per_round() == jf.bits_per_round()
    assert tf.downlink_bits_per_round() == jf.downlink_bits_per_round()
    assert twire.total_round_bits(tf, tf, n_workers=2) == \
        jwire.total_round_bits(jf, jf, n_workers=2)
    if s == 16:
        assert tf.bits_per_round() == 11_553_216
    # the payload that crosses the wire has exactly payload_bits
    for codec in tf.leaves[:3]:
        payload = codec.encode(R.key(0), torch.ones(codec.size))
        assert 8 * twire.payload_bytes(payload) == codec.payload_bits


def _smoke_x_w():
    """Smoke-tree params w and x = w + delta, both multiples of 2**-10, so
    x - w is exact and every leaf's squared sum is an exact f32."""
    rng = np.random.default_rng(4)
    tree = jbuild_model(jget_smoke_config("qwen2-0.5b")).init_abstract()
    w = jax.tree.map(lambda l: _exact_sum_vector(rng, l.shape, 2**-6), tree)
    x = jax.tree.map(lambda a: a + _exact_sum_vector(rng, a.shape), w)
    return x, w


@pytest.mark.parametrize("spec", ["qsgd:16", "qsgd:16@0.9"])
def test_downlink_broadcast_bitwise_vs_jax(spec):
    x, w = _smoke_x_w()
    jdl = jefbv.Downlink.parse(spec)
    tdl = tefbv.Downlink.parse(spec)
    jk = jefbv.downlink_key(jax.random.fold_in(jax.random.key(0), 2))
    tk = tefbv.downlink_key(R.fold_in(R.key(0), 2))
    jw, jpay = jax.jit(lambda k, x, w: jagg.broadcast_global(jdl, k, x, w))(
        jk, x, w)
    to_t = lambda t: T.tree_map(torch.from_numpy, t)  # noqa: E731
    tw, tpay = tagg.broadcast_global(tdl, tk, to_t(x), to_t(w))
    for a, b in zip(jax.tree.leaves(jw), T.leaves(tw)):
        _same(a, b)
    for (jn, jl), (tn, tl) in zip(jpay, tpay):
        _same(jn, tn)
        _same(jl, tl)
    dfmt = tdl.format_for(to_t(x))
    assert 8 * twire.payload_bytes(tpay) == dfmt.downlink_bits_per_round()
    assert dfmt.downlink_bits_per_round() == \
        jdl.format_for(x).downlink_bits_per_round()


def test_downlink_parse_refuses_unported(capsys):
    """Downlink.parse takes any zoo compressor, as JAX's does, and since
    the per-leaf wire slice the trainer trains every one of them down; the
    driver refuses only a downlink that does not parse."""
    from repro_torch.launch import train as tlaunch

    assert tefbv.Downlink.parse("") is None
    assert tefbv.Downlink.parse("none") is None
    assert tefbv.Downlink.parse("qsgd:16@0.5").lam == 0.5
    dl = tefbv.Downlink.parse("block_topk:256,16")
    assert dl.compressor == tcomp.BlockTopK(256, 16) and dl.lam == 1.0
    args = tlaunch.parse_args(["--smoke", "--device", "cpu", "--downlink",
                               "block_topk:256,16"])
    assert args.downlink == "block_topk:256,16"
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--smoke", "--device", "cpu", "--downlink",
                            "bogus:3"])
    err = capsys.readouterr().err
    assert "--downlink" in err and "not yet ported" not in err


def test_wrapper_counts_only_kernel_launches():
    reset_launches()
    g, h, u = (torch.from_numpy(a) for a in _inputs(4096, "rand"))
    norm = torch.linalg.vector_norm(g - h).reshape(1)
    got = pack.qsgd_pack_update(g, h, u, norm, LAM, 16)
    assert LAUNCHES["qsgd_pack_update"] == 0
    want = ref.qsgd_pack_update_ref(g, h, u, norm, LAM, 16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["shape", "dtype", "norm", "s"])
def test_wrapper_checks_inputs(bad):
    g = h = u = torch.zeros(256)
    norm, s = torch.zeros(1), 16
    if bad == "shape":
        u = torch.zeros(128)
    elif bad == "dtype":
        h = torch.zeros(256, dtype=torch.float64)
    elif bad == "norm":
        norm = torch.zeros(2)
    else:
        s = 0
    with pytest.raises((ValueError, TypeError)):
        pack.qsgd_pack_update(g, h, u, norm, LAM, s)


def test_cuda_mode_needs_a_cuda_tensor():
    tc = twire.QsgdQuant(shape=(300,), size=300, s=16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tc.encode_update(R.key(0), torch.zeros(300), torch.zeros(300), LAM,
                         kernel="cuda")


# ---------------------------------------------------------------------------
# The rest of the trainer's wire: three-step, two-worker smoke rounds of the
# port's trainer against a JAX round assembled from its public pieces
# (``compress_local``, ``combine_global``, ``broadcast_global``,
# ``init_inflight``, adamw), jitted, from the same params, batches and step
# keys, as ``tests/test_torch_train.py`` assembles its rounds: per-leaf codec
# rules under both aggregations and pipelined, a mixed fleet under
# dense_psum (worker i runs fleet[i]), a non-QSGD downlink and a bf16 wire.
# Tolerance (``tests/test_torch_train.py``'s, f32 activations): loss rtol
# 1e-5; fewer than 0.1% of the params more than 1e-5 apart, none more than
# 3 lr = 9e-4 -- matmul sums differ in order between the two frameworks, so
# a near-tie of a top-k can go the other way, and the QSGD norms differ in
# their last bits.  The bits per round are exact.
# ---------------------------------------------------------------------------

from repro.core.efbv import EFBV as JEFBV  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402,F401
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import apply_updates as japply_updates  # noqa: E402
from repro.optim import cosine as jcosine  # noqa: E402
from repro.train.trainer import init_inflight as jinit_inflight  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.efbv import EFBV, Downlink, Pipeline  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.optimizers import adamw  # noqa: E402
from repro_torch.optim.schedules import cosine  # noqa: E402
from repro_torch.train.trainer import (init_train_state,  # noqa: E402
                                       make_train_step)

RULES = "*embed*=qsgd:16;*norm*=identity"
#: round -> (uplink compressor or fleet, agg, leaf rules, downlink, wire
#: dtype, pipelined)
ZOO_ROUNDS = {
    "rules_sparse": ("block_topk:256,16", "sparse_allgather", RULES, "",
                     "float32", False),
    "rules_dense": ("block_topk:256,16", "dense_psum", RULES, "",
                    "float32", False),
    "rules_pipelined": ("block_topk:256,16", "sparse_allgather", RULES,
                        "qsgd:16", "float32", True),
    "fleet_dense": ("topk:64;randk:64", "dense_psum", "", "", "float32",
                    False),
    "topk_downlink": ("block_topk:256,16", "sparse_allgather", "", "topk:64",
                      "float32", False),
    "bf16_wire": ("block_topk:256,16", "sparse_allgather", "", "qsgd:16",
                  "bfloat16", False),
}
R_N, R_STEPS, R_SEQ, R_BATCH, R_LAM, R_NU = 2, 3, 16, 8, 0.37, 0.61


def _f32_smoke(get):
    import dataclasses
    return dataclasses.replace(get("qwen2-0.5b"), activation_dtype="float32")


def _zoo_algos(comp, rules):
    members = comp.split(";")
    if len(members) > 1:
        jf = tuple(jcomp.make_compressor(m) for m in members)
        tf = tuple(tcomp.make_compressor(m) for m in members)
        return (JEFBV(jf[0], lam=R_LAM, nu=R_NU, fleet=jf),
                EFBV(tf[0], lam=R_LAM, nu=R_NU, fleet=tf))
    return (JEFBV(jcomp.make_compressor(comp), lam=R_LAM, nu=R_NU,
                  leaf_rules=tuple(jwire.parse_leaf_rules(rules))
                  if rules else None),
            EFBV(tcomp.make_compressor(comp), lam=R_LAM, nu=R_NU,
                 leaf_rules=twire.parse_leaf_rules(rules) if rules
                 else None))


def _jax_zoo_round(kind, params, batches):
    comp, agg, rules, down, dt, pipelined = ZOO_ROUNDS[kind]
    model = jbuild_model(_f32_smoke(jget_smoke_config))
    algo, _ = _zoo_algos(comp, rules)
    downlink = jefbv.Downlink.parse(down)
    opt = jadamw(jcosine(3e-4, total_steps=R_STEPS, warmup_steps=1),
                 weight_decay=0.01)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    local = jax.jit(lambda k, g, h, i: jagg.compress_local(
        algo, k, g, h, mode=agg, wire_dtype=dt, worker=i, stream=pipelined))
    chunks = jwire.pipeline_chunks(R_N) if pipelined else 1
    combine = jax.jit(lambda m, ha: jagg.combine_global(
        algo, m, ha, n_workers=R_N, mode=agg, wire_dtype=dt, chunks=chunks))
    broadcast = jax.jit(lambda k, x, w: jagg.broadcast_global(
        downlink, jefbv.downlink_key(k), x, w, wire_dtype=dt)[0])

    @jax.jit
    def optimize(g, opt_state, params):
        updates, opt_state = opt.update(g, opt_state, params)
        return japply_updates(params, updates), opt_state

    zeros = jax.tree.map(jnp.zeros_like, params)
    hs, h_avg, opt_state, w = [zeros] * R_N, zeros, opt.init(params), params
    inflight = jinit_inflight(algo, params, R_N, agg_mode=agg,
                              wire_dtype=dt) if pipelined else None
    key, losses = jax.random.key(0), []
    for step, batch in enumerate(batches):
        step_key = jax.random.fold_in(key, step)
        per = R_BATCH // R_N
        msgs, step_losses = [], []
        for i in range(R_N):
            bi = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, grads = grad_fn(w if downlink else params, bi)
            msg, hs[i] = local(jax.random.fold_in(step_key, i),
                               jax.tree.map(lambda a: a.astype(jnp.float32),
                                            grads), hs[i], jnp.int32(i))
            msgs.append(msg)
            step_losses.append(float(loss))
        stacked = jax.tree.map(lambda *x: jnp.stack(x), *msgs)
        g, h_avg = combine(inflight if pipelined else stacked, h_avg)
        if pipelined:
            inflight = stacked
        params, opt_state = optimize(g, opt_state, params)
        if downlink:
            w = broadcast(step_key, params, w)
        losses.append(float(np.mean(step_losses)))
    return losses, params


def _torch_zoo_round(kind, params_np, batches):
    comp, agg, rules, down, dt, pipelined = ZOO_ROUNDS[kind]
    model = build_model(_f32_smoke(get_smoke_config))
    _, algo = _zoo_algos(comp, rules)
    downlink = Downlink.parse(down)
    pipeline = Pipeline(1) if pipelined else None
    opt = adamw(cosine(3e-4, total_steps=R_STEPS, warmup_steps=1),
                weight_decay=0.01)
    state = init_train_state(T.params_from_jax(params_np, "cpu"), opt,
                             n_workers=R_N, bidirectional=bool(downlink),
                             algo=algo, agg_mode=agg, wire_dtype=dt,
                             pipeline=pipeline)
    step = make_train_step(model.loss, opt, algo, n_workers=R_N,
                           agg_mode=agg, wire_dtype=dt, downlink=downlink,
                           pipeline=pipeline)
    losses = []
    with R._serial(torch.device("cpu")):
        for s, batch in enumerate(batches):
            state, metrics = step(state, batch, R.fold_in(R.key(0), s))
            losses.append(float(metrics["loss"]))
    return losses, state


@pytest.mark.parametrize("kind", sorted(ZOO_ROUNDS))
def test_zoo_smoke_round_matches_jax(kind):
    params_np = jax.tree.map(np.asarray, jbuild_model(
        _f32_smoke(jget_smoke_config)).init(jax.random.key(0)))
    data = SyntheticLM(vocab=jget_smoke_config("qwen2-0.5b").vocab,
                       seq_len=R_SEQ, global_batch=R_BATCH, n_workers=R_N,
                       seed=0)
    batches = [data.batch(s) for s in range(R_STEPS)]
    jl, jparams = _jax_zoo_round(kind, params_np, batches)
    tl, state = _torch_zoo_round(kind, params_np, batches)
    assert state.step == R_STEPS and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    diff = np.concatenate([
        np.abs(b.numpy() - np.asarray(a)).reshape(-1) for a, b in
        zip(jax.tree.leaves(jparams), T.leaves(state.params))])
    assert np.mean(diff > 1e-5) < 1e-3 and diff.max() <= 9e-4
    if ZOO_ROUNDS[kind][5]:
        assert len(state.inflight) == len(T.leaves(state.params))


# -- the rest of ``optim``: sgd, clip_by_global_norm, chain, schedules --------

from repro import optim as joptim  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402


def _grad_trees(seed=0):
    rng = np.random.default_rng(seed)
    return [{"a": rng.standard_normal((7, 5)).astype(np.float32),
             "b": {"c": rng.standard_normal(33).astype(np.float32)}}
            for _ in range(3)]


def _run_opt(jopt, topt, steps=3):
    """The two optimizers over the same grads, eager: JAX's update and the
    port's, from the same params; the port's params after every step."""
    trees = _grad_trees()
    jp = jax.tree.map(jnp.asarray, trees[0])
    tp = T.params_from_jax(trees[0], "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for g in trees[1:steps + 1] + trees[:max(0, steps - 2)]:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(T.params_from_jax(g, "cpu"), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        out.append((jp, tp))
    return out


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_matches_jax_bitwise(momentum, nesterov):
    """``optim.sgd`` (plain, heavy-ball, Nesterov) on a warmup schedule:
    every step's params equal JAX's eager update bit for bit."""
    sched = (joptim.linear_warmup(0.1, 2), toptim.linear_warmup(0.1, 2))
    for jp, tp in _run_opt(joptim.sgd(sched[0], momentum, nesterov),
                           toptim.sgd(sched[1], momentum, nesterov)):
        for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
            _same(a, b)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_and_chain_match_jax(max_norm):
    """``chain(clip_by_global_norm(c), sgd(constant(lr)))``: the clip
    scale comes from the global norm (a reduction in another order, fault
    c), so within 2 ulp; no clip (c above the norm) is bitwise."""
    jopt = joptim.chain(joptim.clip_by_global_norm(max_norm),
                        joptim.sgd(joptim.constant(0.05)))
    topt = toptim.chain(toptim.clip_by_global_norm(max_norm),
                        toptim.sgd(toptim.constant(0.05)))
    for jp, tp in _run_opt(jopt, topt):
        for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
            if max_norm > 100:
                _same(a, b)
            else:
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=3e-7, atol=0)


def _schedule_args(kind, steps, warmup):
    """A schedule's arguments for a run of ``steps``: warmup steps about a
    twentieth of the run (or none), WSD's plateau 0.7 and decay 0.25 of it,
    cosine to the run's end."""
    w = max(steps // 20, 1) if warmup else 0
    return {"constant": (3e-4,), "linear_warmup": (3e-4, w),
            "cosine": (3e-4, steps, w),
            "wsd": (3e-4, w, int(steps * 0.7), max(int(steps * 0.25), 1))
            }[kind]


@pytest.mark.parametrize("kind", ["constant", "linear_warmup", "wsd",
                                  "cosine"])
def test_schedules_match_jax(kind):
    """Each schedule at every step of runs of 3, 50 and 1000 steps (warmup,
    plateau, decay, past the end), with and without warmup, equal to
    ``jax.jit(schedule)``: the lr of JAX's jitted optimizer step, whose
    products by constant reciprocals, fused multiply-adds, ``cosf`` and
    ``powf`` differ from the eager value by up to 7 ulp (ROADMAP fault
    x)."""
    for warmup in (True, False):
        for steps in (3, 50, 1000):
            args = _schedule_args(kind, steps, warmup)
            jf = jax.jit(getattr(joptim, kind)(*args))
            tf = getattr(toptim, kind)(*args)
            for s in range(steps + 5):
                assert tf(s) == float(jf(jnp.asarray(s, jnp.int32))), \
                    (kind, args, s)


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedule_is_the_jitted_trainers_lr(kind):
    """The lr that JAX's jitted ``sgd(schedule).update`` applies (its
    update of a gradient of 1 is -lr), read at every step of a 1000-step
    run, equals the port's schedule: ``jax.jit(schedule)`` is the
    trainer's value."""
    args = _schedule_args(kind, 1000, True)
    update = jax.jit(joptim.sgd(getattr(joptim, kind)(*args)).update)
    tf = getattr(toptim, kind)(*args)
    one = jnp.ones((), jnp.float32)
    for s in range(1005):
        u, _ = update(one, {"count": jnp.asarray(s, jnp.int32),
                            "mom": None}, one)
        assert -float(u) == tf(s), (kind, s)


def test_xla_cos_bitwise():
    """``random.xla_cos`` (glibc's ``cosf``, which XLA CPU calls) against
    jitted ``jnp.cos`` on 2**20 values spread over [0, pi] (the schedules'
    range), 2**16 random f32 bit patterns (every reduction path) and the
    edges of its paths and their f32 neighbours below, bit for bit (NaN
    where JAX's is NaN)."""
    rng = np.random.default_rng(0)
    edges = np.array([2**-12, 0.75, 120.0, np.pi / 2, np.pi, 1.0,
                      np.finfo(np.float32).max, np.finfo(np.float32).tiny,
                      1e-45, 2**23], np.float32)
    x = np.concatenate([
        np.linspace(0, np.pi, 2**20, dtype=np.float32),
        rng.integers(0, 2**32, 2**16, dtype=np.uint64).astype(
            np.uint32).view(np.float32),
        edges, -edges, np.nextafter(edges, np.float32(0)),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)])
    want = np.asarray(jax.jit(jnp.cos)(x))
    got = R.xla_cos(x)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def test_xla_pow_bitwise():
    """``random.xla_pow`` (glibc's ``powf``, which XLA CPU calls) against
    jitted ``jnp.power`` on 2**16 exponents in [0, 1] (and 0, 1, 1/2) for
    WSD-like bases and a few others, bit for bit; 0 ** t is 0 and x ** 0
    is 1."""
    rng = np.random.default_rng(1)
    t = np.concatenate([np.array([0.0, 1.0, 0.5], np.float32),
                        rng.random(2**16, dtype=np.float32)])
    for base in (0.01, 0.1, 0.5, 0.9, 1e-6, 1.0, 3.0, 0.0):
        b = np.float32(base)
        want = np.asarray(jax.jit(jnp.power)(b, t))
        got = R.xla_pow(b, t)
        np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the serving push protocol: envelopes, replicas, resync, the fleet
# ---------------------------------------------------------------------------
#
# The pushes are JAX's (``repro.launch.serve.DeltaPusher``, eager, as JAX's
# fleet runs them); the port's replica decodes them and must rebuild JAX's
# w bit for bit.  JAX applies a push outside ``jit``: w + lam * q rounds
# twice, the product and the sum; the lam = 0.9 cases tell that apart from
# the fused form the jitted trainer's broadcast takes (at lam = 0.5 the two
# agree: 0.5 * q is exact).

import dataclasses  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.core import ExperimentSpec as TSpec  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from test_wire_codecs import ZOO  # noqa: E402

PUSH_D = 96
PUSHES = 5
LAMS = (1.0, 0.9)
BF16_PUSH_SPECS = ["topk:7", "qsgd:16", "block_topk:16,4", "natural"]
TREE_RULES = "*embed*=qsgd:16;*norm*=identity"
#: the codecs whose encode divides by a norm of the innovation (fault c:
#: torch's reduction, not XLA's)
NORMED = ("sign", "qsgd", "qsgd_wide", "qsgd_odd")


def _port_comp(comp):
    """The port's compressor of a JAX zoo object (same class, same
    fields)."""
    return getattr(tcomp, type(comp).__name__)(**dataclasses.asdict(comp))


def _jt(a):
    """A JAX payload component or leaf as the port's tensor with the same
    bits: uint32 words as int32, bf16 through its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _raw(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _jenv_to_port(env):
    """A JAX envelope as the port's: the same versions, kind and payload
    bits."""
    pays = [tuple(_jt(a) for a in p) for p in env.payloads]
    return twire.DeltaEnvelope(version=env.version,
                               base_version=env.base_version, payloads=pays,
                               kind=env.kind)


def _flat_traj(key, t):
    return jax.random.normal(jax.random.fold_in(key, t), (PUSH_D,))


def _tree_traj(key, t):
    k = jax.random.fold_in(key, t)
    return {"embed": jax.random.normal(jax.random.fold_in(k, 0), (8, 16)),
            "layers": {"w": jax.random.normal(jax.random.fold_in(k, 1),
                                              (4, 4)),
                       "norm": jax.random.normal(jax.random.fold_in(k, 2),
                                                 (4,))}}


def _assert_w_equal(jw, tw, msg=""):
    jl, tl = jax.tree.leaves(jw), T.leaves(tw)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(np.shape(a)) == tuple(b.shape), msg
        np.testing.assert_array_equal(_raw(b), _raw(a), err_msg=msg)


def _replica_rebuilds_jax(jcomp_obj, lam, make_x, *, wire_dtype="float32",
                          rules=None, seed=0):
    """JAX's pusher over PUSHES pushes; a port replica fed its envelopes
    equals JAX's w bitwise after every push."""
    key = jax.random.key(seed)
    jdl = jefbv.Downlink(compressor=jcomp_obj, lam=lam)
    tdl = tefbv.Downlink(compressor=_port_comp(jcomp_obj), lam=lam)
    jr = jwire.parse_leaf_rules(rules) if rules else None
    tr = twire.parse_leaf_rules(rules) if rules else None
    jp = jserve.DeltaPusher(jdl, make_x(key, 0), key=key,
                            wire_dtype=wire_dtype, rules=jr)
    rep = tlaunch.ServeReplica(
        tdl, T.tree_map(_jt, jax.tree.map(np.asarray, jp.w)),
        wire_dtype=wire_dtype, rules=tr)
    for t in range(1, PUSHES + 1):
        env = jp.push(make_x(key, t))
        assert rep.push(_jenv_to_port(env)) == "applied"
        assert rep.version == jp.version == t
        _assert_w_equal(jp.w, rep.params, f"push {t}")
    return jp, rep


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("name,comp", ZOO, ids=[n for n, _ in ZOO])
def test_port_replica_rebuilds_jax_w_bitwise(name, comp, lam):
    """Every zoo codec, f32 wire: the port's ``apply_push`` of JAX's
    payloads is JAX's w bit for bit over five pushes (the identity at
    lam 1 a snapshot, assigned)."""
    jp, _ = _replica_rebuilds_jax(comp, lam, _flat_traj,
                                  seed=sum(map(ord, name)))
    want = "snapshot" if (name, lam) == ("identity", 1.0) else "delta"
    assert jp.downlink.push_kind() == want


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("spec", BF16_PUSH_SPECS)
def test_port_replica_rebuilds_jax_w_bf16_wire(spec, lam):
    _replica_rebuilds_jax(jcomp.make_compressor(spec), lam, _flat_traj,
                          wire_dtype="bfloat16")


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("wire_dtype", ["float32", "bfloat16"])
def test_port_replica_rebuilds_jax_w_tree_rules(wire_dtype, lam):
    """The per-leaf wire (``*embed*=qsgd:16;*norm*=identity`` over
    block-top-k): each leaf through its own codec, a ruled push always a
    delta."""
    jp, rep = _replica_rebuilds_jax(
        jcomp.make_compressor("block_topk:16,4"), lam, _tree_traj,
        wire_dtype=wire_dtype, rules=TREE_RULES)
    assert rep.downlink.push_kind(wire_dtype, rep.rules) == "delta"


def _exact_traj(key, t):
    """Multiples of 1/64 with |x| <= 4 (from JAX's key): every L1 and L2
    sum of a difference of two of them is exact in f32, so torch's norm
    is XLA's."""
    u = jax.random.randint(jax.random.fold_in(key, t), (PUSH_D,), -256, 257)
    return u.astype(jnp.float32) / 64


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("name,comp", ZOO, ids=[n for n, _ in ZOO])
def test_port_push_payloads_equal_jax(name, comp, lam):
    """The port's ``encode_push`` puts JAX's bits on the wire under the
    same key and returns JAX's w: on normal draws for the codecs that take
    no norm; for sign and QSGD on values whose norms are exact in f32,
    where torch's norm is XLA's (fault c: elsewhere they agree given JAX's
    norm)."""
    make = _exact_traj if name in NORMED else _flat_traj
    key = jax.random.key(11)
    jdl = jefbv.Downlink(compressor=comp, lam=lam)
    tdl = tefbv.Downlink(compressor=_port_comp(comp), lam=lam)
    x0, x1 = make(key, 0), make(key, 1)
    jw, jpay = jdl.encode_push(jserve.push_key(key, 1), x1, x0)
    tw, tpay = tdl.encode_push(tlaunch.push_key(R.key(11), 1), _jt(x1),
                               _jt(x0))
    assert len(jpay) == len(tpay) == 1
    for a, b in zip(jpay[0], tpay[0]):
        assert tuple(np.shape(a)) == tuple(b.shape), name
        np.testing.assert_array_equal(_raw(b), _raw(a), err_msg=name)
    _assert_w_equal(jw, tw, name)


def test_push_key_is_the_rounds_downlink_key():
    for v in (1, 2, 7):
        want = jax.random.key_data(jserve.push_key(jax.random.key(5), v))
        np.testing.assert_array_equal(
            np.asarray(tlaunch.push_key(R.key(5), v)), np.asarray(want))


@pytest.mark.parametrize("name,comp", ZOO, ids=[n for n, _ in ZOO])
def test_push_bits_equal_jax(name, comp):
    """``push_bits`` and ``checkpoint_push_bits`` are JAX's for every
    codec, on a vector and on the ruled tree; a push's payload bytes are
    its bits less the header."""
    key = jax.random.key(5)
    for make, rules in ((_flat_traj, None), (_tree_traj, TREE_RULES)):
        x = make(key, 0)
        tx = T.tree_map(_jt, jax.tree.map(np.asarray, x))
        jfmt = jefbv.Downlink(compressor=comp).serve_format(
            x, rules=jwire.parse_leaf_rules(rules) if rules else None)
        tdl = tefbv.Downlink(compressor=_port_comp(comp))
        tr = twire.parse_leaf_rules(rules) if rules else None
        tfmt = tdl.serve_format(tx, rules=tr)
        assert twire.push_bits(tfmt) == jwire.push_bits(jfmt), name
        assert twire.checkpoint_push_bits(tfmt) == \
            jwire.checkpoint_push_bits(jfmt), name
        assert twire.PUSH_HEADER_BITS == jwire.PUSH_HEADER_BITS == 128
        pusher = tlaunch.DeltaPusher(tdl, tx, key=R.key(5), rules=tr)
        env = pusher.push(T.tree_map(_jt, jax.tree.map(
            np.asarray, make(key, 1))))
        assert 8 * twire.payload_bytes(env.payloads) == \
            twire.push_bits(tfmt) - twire.PUSH_HEADER_BITS, name


def test_port_pushes_stale_refused_and_idempotent():
    dl = tefbv.Downlink.parse("topk:7")
    key = jax.random.key(0)
    x = [_jt(_flat_traj(key, t)) for t in range(3)]
    pusher = tlaunch.DeltaPusher(dl, x[0], key=R.key(0))
    rep = tlaunch.ServeReplica(dl, pusher.w)
    env1, env2 = pusher.push(x[1]), pusher.push(x[2])
    assert rep.push(env1) == rep.push(env2) == "applied"
    before = [t.clone() for t in T.leaves(rep.params)]
    assert rep.push(env2) == "stale" and rep.push(env1) == "stale"
    assert rep.version == 2
    for a, b in zip(T.leaves(rep.params), before):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="monotonic"):
        twire.DeltaEnvelope(version=1, base_version=1, payloads=[])
    with pytest.raises(ValueError, match="kind"):
        twire.DeltaEnvelope(version=2, base_version=1, payloads=[],
                            kind="patch")


def test_gap_resyncs_bitwise_from_jax_checkpoint(tmp_path):
    """JAX's pusher writes a checkpoint a version; push 2 is dropped, so
    the port replica sees a gap at push 3, restores JAX's newest
    checkpoint (spec-gated: the port's spec has JAX's fingerprint) and
    ends at JAX's w bit for bit."""
    from repro.core import ExperimentSpec as JSpec

    fields = dict(downlink="qsgd:16", d=PUSH_D, n=2)
    jspec, tspec = JSpec(**fields), TSpec(**fields)
    assert jspec.fingerprint() == tspec.fingerprint()
    key = jax.random.key(1)
    jdl = jefbv.Downlink.parse("qsgd:16")
    jp = jserve.DeltaPusher(jdl, _tree_traj(key, 0), key=key,
                            ckpt_dir=str(tmp_path), spec=jspec)
    rep = tlaunch.ServeReplica(
        tefbv.Downlink.parse("qsgd:16"),
        T.tree_map(_jt, jax.tree.map(np.asarray, jp.w)),
        ckpt_dir=str(tmp_path), spec=tspec)
    assert rep.push(_jenv_to_port(jp.push(_tree_traj(key, 1)))) == "applied"
    jp.push(_tree_traj(key, 2))                       # dropped
    env3 = _jenv_to_port(jp.push(_tree_traj(key, 3)))
    assert env3.base_version == 2 and rep.version == 1
    assert rep.push(env3) == "resync"
    assert rep.resyncs == 1 and rep.version == jp.version == 3
    _assert_w_equal(jp.w, rep.params)


def test_gap_without_checkpoint_dir_is_loud_and_snapshots_repair():
    key = jax.random.key(2)
    x = [_jt(_flat_traj(key, t)) for t in range(3)]
    for spec, outcome in (("topk:7", "raise"), ("identity", "applied")):
        dl = tefbv.Downlink.parse(spec)
        pusher = tlaunch.DeltaPusher(dl, x[0], key=R.key(2))
        rep = tlaunch.ServeReplica(dl, pusher.w)
        pusher.push(x[1])                              # dropped
        env2 = pusher.push(x[2])
        if outcome == "raise":
            with pytest.raises(RuntimeError, match="resync"):
                rep.push(env2)
        else:
            assert env2.kind == "snapshot" and rep.push(env2) == "applied"
            assert torch.equal(rep.params.view(torch.int32),
                               x[2].view(torch.int32))


#: JAX's ``run_fleet`` metrics of the committed ``serve_delta.json``
SERVE_DELTA = {"fingerprint": "7d408c73e1bcf250", "replicas": 2,
               "pushes": 3, "requests": 8, "tokens": 64,
               "delta_bits_per_push": 2_734_560,
               "checkpoint_bits_per_push": 10_935_936}


def test_serve_cli_runs_the_committed_fleet_spec(tmp_path, capsys):
    """``serve --spec examples/specs/serve_delta.json --device cpu``: JAX's
    metrics (8 requests: 2 replicas x 2 waves x 2 slots), every replica
    pinned to the pusher after every push (asserted inside), a checkpoint
    a version under ``--ckpt-dir``."""
    spec = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "specs", "serve_delta.json")
    m = tlaunch.main(["serve", "--spec", spec, "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    for k, v in SERVE_DELTA.items():
        assert m[k] == v, k
    assert f"{m['push_ratio']:.6f}" == "0.250053"
    out = capsys.readouterr().out
    assert "delta 2734560 vs checkpoint 10935936 bits/push (0.250053x)" in out
    assert "fingerprint=7d408c73e1bcf250" in out
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{v:08d}.npz" for v in range(4)]


def test_serve_cli_single_model_and_refusals(tmp_path, capsys):
    gen = tlaunch.main(["serve", "--arch", "mamba2-130m", "--smoke",
                        "--batch", "2", "--prompt-len", "4", "--gen", "6",
                        "--device", "cpu"])
    assert gen.shape == (2, 6)
    assert "[serve] arch=mamba2-smoke batch=2 prompt=4 gen=6" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):
        tlaunch.parse_serve_args(["--prompt-len", "20", "--gen", "20",
                                  "--max-len", "32"])
    assert "--max-len" in capsys.readouterr().err
    # JAX's serve driver has no --sanitize (fault ab): argparse refuses it
    with pytest.raises(SystemExit):
        tlaunch.parse_serve_args(["--sanitize"])
    assert "unrecognized arguments: --sanitize" in capsys.readouterr().err
    # a model axis is no refusal (fault y): the fleet runs in one process
    # and reads no mesh, as JAX's
    meshed = tmp_path / "mesh.json"
    meshed.write_text(TSpec(problem="qwen2-0.5b", smoke=True,
                            backend="shard_map", mesh="1x2", n=1,
                            serve="gen:4,max_len:8").to_json())
    m = tlaunch.main(["serve", "--spec", str(meshed), "--device", "cpu"])
    assert m["tokens"] > 0 and m["replicas"] >= 1
