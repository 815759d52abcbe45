"""The port's compressors, wire accounting and leaf paths against
``repro``.  Inputs from numpy seeds; tolerance: none (bitwise, exact).

Two later sections hold the rest of the compressor zoo against jitted JAX
and the compressor bench run on the CPU against the JAX bench; each
section's notes head it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import compressor_bench as jbench
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import compressors as jcomp
from repro.distributed import wire as jwire
from repro.models import build_model as jbuild_model
from repro_torch import random as R
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import compressors as tcomp
from repro_torch.distributed import wire as twire
from repro_torch.launch import compressor_bench as tbench
from repro_torch.models.model import build_model

SMOKE_BITS = 5_776_384
FULL_BITS = 1_976_131_584
FULL_PARAMS = 494_032_768
SMOKE_RANDK_BITS = 2_244_608      # randk:4096
FULL_RANDK_BITS = 541_450_240     # randk:1048576


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread, for the reason test_torch_model.py's
    copy gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape,block,kb", [
    ((4096,), 512, 16), ((1000,), 256, 8), ((64, 300), 128, 4),
    ((128,), 128, 128), ((5, 7, 11), 128, 2), ((896,), 256, 16)])
def test_block_topk_call_bitwise(shape, block, kb):
    x = np.random.default_rng(block + kb).standard_normal(shape).astype(
        np.float32)
    want = np.asarray(jcomp.BlockTopK(block, kb)(None, jnp.asarray(x)))
    got = tcomp.BlockTopK(block, kb)(None, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_block_topk_ties_bitwise():
    x = np.random.default_rng(5).integers(-2, 3, (8 * 256,)).astype(
        np.float32)
    want = np.asarray(jcomp.BlockTopK(256, 16)(None, jnp.asarray(x)))
    got = tcomp.BlockTopK(256, 16)(None, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("spec", ["block_topk:256,16", "block_topk:1024,64",
                                  "identity", "qsgd:16", "qsgd:400",
                                  "randk:8", "randk:1048576"])
def test_certified_constants_equal(spec):
    j, t = jcomp.make_compressor(spec), tcomp.make_compressor(spec)
    for d in (896, 4_358_144):
        assert (t.eta(d), t.omega(d), t.omega_av(d, 2)) == \
            (j.eta(d), j.omega(d), j.omega_av(d, 2))


@pytest.mark.parametrize("spec", ["natural", "topk:64", "scaled_randk:8",
                                  "sign"])
def test_unported_compressors_refused(spec, capsys):
    """Every zoo compressor is ported (``make_compressor`` builds it), and
    since the per-leaf wire slice the trainer takes each of them: the
    driver refuses none (their rounds are held against JAX's
    ``compress_local`` below)."""
    from repro_torch.launch import train

    assert tcomp.make_compressor(spec) == jcomp_equivalent(spec)
    assert spec.partition(":")[0] in train.TRAIN_COMPRESSORS
    args = train.parse_args(["--device", "cpu", "--compressor", spec])
    assert args.compressor == spec
    assert "not yet ported" not in capsys.readouterr().err


def jcomp_equivalent(spec):
    """The port's compressor with the JAX one's fields."""
    j = jcomp.make_compressor(spec)
    return getattr(tcomp, type(j).__name__)(**dataclasses.asdict(j))


def _jax_smoke_abstract():
    return jbuild_model(jget_smoke_config("qwen2-0.5b")).init_abstract()


def test_smoke_tree_paths_shapes_and_bits_equal_jax():
    jtree = _jax_smoke_abstract()
    ttree = build_model(get_smoke_config("qwen2-0.5b")).init_abstract()
    assert twire.leaf_paths(ttree) == jwire.leaf_paths(jtree)
    assert [tuple(l.shape) for l in jax.tree.leaves(jtree)] == \
        [tuple(l.shape) for l in twire.T.leaves(ttree)]
    jfmt = jwire.format_for(jcomp.BlockTopK(256, 16), jtree)
    tfmt = twire.format_for(tcomp.BlockTopK(256, 16), ttree)
    assert tfmt.bits_per_round() == jfmt.bits_per_round() == SMOKE_BITS
    assert tfmt.dense_bits() == jfmt.dense_bits()
    assert [l.nb for l in tfmt.leaves] == [l.nb for l in jfmt.leaves]


def test_full_size_bits_exact_on_abstract_tree():
    tree = build_model(get_config("qwen2-0.5b")).init_abstract()
    fmt = twire.format_for(tcomp.BlockTopK(256, 16), tree)
    assert len(fmt.leaves) == 14
    assert sum(l.size for l in fmt.leaves) == FULL_PARAMS
    assert fmt.bits_per_round() == FULL_BITS
    assert f"{fmt.bits_per_round() / fmt.dense_bits():.4f}" == "0.1250"
    assert fmt.bits_per_round(n_workers=2) == 2 * FULL_BITS


def test_payload_bytes_match_bits():
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    lw = twire.LeafWire(shape=(1000,), size=1000, block=256, kb=8)
    payload, _ = twire.fused_pack(lw, x, torch.zeros_like(x), 0.5)
    assert 8 * twire.payload_bytes(payload) == lw.payload_bits


def test_small_leaf_clamps_kb_like_jax():
    tree = {"tiny": torch.zeros(5), "big": torch.zeros(300)}
    jtree = {"tiny": jnp.zeros(5), "big": jnp.zeros(300)}
    t = twire.format_for(tcomp.BlockTopK(256, 16), tree)
    j = jwire.format_for(jcomp.BlockTopK(256, 16), jtree)
    assert [(l.nb, l.kb) for l in t.leaves] == [(l.nb, l.kb) for l in j.leaves]
    assert t.bits_per_round() == j.bits_per_round()


@pytest.mark.parametrize("shape,k", [((1000,), 1), ((1000,), 64),
                                     ((64, 300), 4096), ((896,), 896),
                                     ((5, 7, 11), 100)])
def test_randk_call_bitwise(shape, k):
    """``(x * mask) * f32(d / k)`` at the positions of
    ``jax.random.choice``, under the trainer's leaf-key chain; a NaN at an
    unselected position stays a NaN (NaN * 0), as in JAX."""
    x = np.random.default_rng(k).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::97] = np.nan
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 1), 2)
    tk = R.fold_in(R.fold_in(R.key(0), 1), 2)
    want = np.asarray(jax.jit(jcomp.RandK(k).__call__)(jk, jnp.asarray(x)))
    got = tcomp.RandK(k)(tk, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_randk_bits_exact_full_and_smoke():
    """randk:1048576 on the full tree: 8 leaves keep k, the 6 smaller ones
    clamp k to their size (``clamp_for_leaf``); 0.0342x dense."""
    full = build_model(get_config("qwen2-0.5b")).init_abstract()
    fmt = twire.format_for(tcomp.RandK(1_048_576), full)
    assert fmt.bits_per_round() == FULL_RANDK_BITS
    assert f"{fmt.bits_per_round() / fmt.dense_bits():.4f}" == "0.0342"
    assert [l.k for l in fmt.leaves].count(1_048_576) == 8
    assert sum(l.size for l in fmt.leaves if l.has_kernel) == 5_576_576
    jtree = _jax_smoke_abstract()
    ttree = build_model(get_smoke_config("qwen2-0.5b")).init_abstract()
    jfmt = jwire.format_for(jcomp.RandK(4096), jtree)
    tfmt = twire.format_for(tcomp.RandK(4096), ttree)
    assert tfmt.bits_per_round() == jfmt.bits_per_round() == SMOKE_RANDK_BITS
    assert [(l.kind, l.k, l.has_kernel) for l in tfmt.leaves] == \
        [(l.kind, l.k, l.has_kernel) for l in jfmt.leaves]


@pytest.mark.parametrize("spec,size", [("randk:8", 5), ("randk:8", 8),
                                       ("randk:8", 300),
                                       ("block_topk:256,16", 5)])
def test_clamp_for_leaf_like_jax(spec, size):
    t = twire.clamp_for_leaf(tcomp.make_compressor(spec), size)
    j = jwire.clamp_for_leaf(jcomp.make_compressor(spec), size)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    unclamped = tcomp.make_compressor(spec)
    if size >= 16:
        assert twire.clamp_for_leaf(unclamped, size) is unclamped

# ---------------------------------------------------------------------------
# The compressor zoo
#
# The port's compressor zoo (``repro_torch.core.compressors``) against
# jitted JAX under the same threefry keys.  Inputs from numpy seeds;
# tolerance: none (bit for bit), with two stated exceptions:
#
# * SignNorm's L1 scale is a reduction whose order differs (ROADMAP fault
#   c): its inputs are multiples of 1/16 whose sums are exact in f32 in any
#   order, so the scales agree and the outputs are compared bit for bit.
# * Natural's exponent: the port takes floor(log2|x|) and 2**e exactly, XLA's
#   f32 ``log2`` and ``exp2`` are not exact everywhere (fault j).  The test
#   finds, with numpy's exact ``frexp``/``ldexp``, the elements where XLA's
#   are inexact, and asserts that every difference from JAX falls on one of
#   them and none elsewhere.  On 65,536 standard normals it found 5
#   differences (15 elements where XLA is inexact); on 65,536 values within
#   3 ulp of a power of two, 54,817 (57,814).
# ---------------------------------------------------------------------------


def keys(a=1, b=2):
    """The same key in both packages: fold_in(fold_in(key(0), a), b)."""
    return (jax.random.fold_in(jax.random.fold_in(jax.random.key(0), a), b),
            R.fold_in(R.fold_in(R.key(0), a), b))


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def assert_bits(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(bits(want), bits(got.astype(want.dtype)))


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def port_of(j):
    """The port's compressor with the JAX one's class and fields."""
    return getattr(tcomp, type(j).__name__)(**dataclasses.asdict(j))


CALL_SPECS = ["identity", "topk:1", "topk:64", "topk:385", "randk:64",
              "scaled_randk:1", "scaled_randk:300", "comp:10,100",
              "comp:64,64", "mix:1,1", "mix:20,300", "block_topk:256,16",
              "frac_topk:50", "frac_comp:10,200", "qsgd:16"]
SHAPES = [(1000,), (64, 300), (5, 7, 11)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("spec", CALL_SPECS)
def test_call_bitwise(spec, shape):
    """``C(key, x)`` equals jitted JAX's; a NaN and a -0.0 ride along where
    the compressor's output does not reduce over them (QSGD keeps a -0.0
    input's sign, as ``jnp.sign`` does)."""
    j = jcomp.make_compressor(spec)
    t = tcomp.make_compressor(spec)
    assert t == port_of(j)
    x = normal(len(spec), shape)
    if not spec.startswith("qsgd"):  # a NaN would make the norm NaN
        x.reshape(-1)[7] = np.nan
    x.reshape(-1)[11] = -0.0
    if spec.startswith("qsgd"):  # sums exact in f32: the norm agrees
        x = np.round(x * 4) / 4
    jk, tk = keys()
    want = jax.jit(j.__call__)(jk, jnp.asarray(x))
    assert_bits(want, t(tk, torch.from_numpy(x)))


ENCODE_SPECS = ["topk:64", "randk:64", "scaled_randk:300", "comp:10,100",
                "mix:20,300", "mix:655,327", "block_topk:256,16",
                "frac_topk:50", "frac_comp:10,200"]


@pytest.mark.parametrize("spec", ENCODE_SPECS)
def test_encode_and_decode_bitwise(spec):
    """``encode`` (values and positions) equals jitted JAX's, and where the
    compressor has a ``decode`` it rebuilds ``__call__``'s output."""
    j = jcomp.make_compressor(spec)
    t = tcomp.make_compressor(spec)
    d = 1 << 16 if spec == "mix:655,327" else 4096
    x = normal(3, (d,))
    jk, tk = keys(4, 5)
    want = jax.jit(j.encode)(jk, jnp.asarray(x))
    got = t.encode(tk, torch.from_numpy(x))
    for w, g in zip(want, got):
        assert_bits(w, g)
    if type(j).decode is not jcomp.Compressor.decode:
        dec = t.decode(got, d).reshape(-1)
        assert_bits(j.decode(want, d).reshape(-1), dec)
        # the same values as the dense output (whose unselected negatives
        # are -0.0, x * 0, where a decode writes +0.0)
        np.testing.assert_array_equal(
            np.asarray(jax.jit(j.__call__)(jk, jnp.asarray(x))), dec.numpy())


def test_mix_tie_order():
    """MixKK's k' random picks are the top k' of 2**16 uniforms: equal
    draws are common there, and the lower position must come first."""
    d = 1 << 16
    jk, tk = keys(6, 7)
    u = np.asarray(jax.random.uniform(jk, (d,)))
    assert len(np.unique(u)) < d  # ties exist at this size
    j, t = jcomp.MixKK(0, 4000), tcomp.MixKK(0, 4000)
    x = normal(8, (d,))
    want = jax.jit(j.encode)(jk, jnp.asarray(x))
    got = t.encode(tk, torch.from_numpy(x))
    assert_bits(want[1], got[1])


def test_sign_norm_exact_sums():
    """Fault c avoided: multiples of 1/16, so |x| sums exactly in f32."""
    for d in (4096, 1000):
        x = np.round(normal(9, (d,)) * 16) / 16
        x[:5] = 0.0
        x[5] = -0.0
        jk, tk = keys()
        want = jax.jit(jcomp.SignNorm().__call__)(jk, jnp.asarray(x))
        assert_bits(want, tcomp.SignNorm()(tk, torch.from_numpy(x)))


def _xla_inexact(x):
    """Elements where XLA's f32 floor(log2(.)) or exp2 of the exponents the
    natural compressor uses is not exact, found with numpy's exact
    frexp/ldexp."""
    a = np.abs(x)
    safe = np.where(a > 0, a, np.float32(1))
    exact_e = (np.frexp(safe)[1] - 1).astype(np.float32)
    xla_e = np.asarray(jax.jit(lambda s: jnp.floor(jnp.log2(s)))(safe))
    exp2 = jax.jit(jnp.exp2)
    bad = xla_e != exact_e
    for e in (xla_e, xla_e + 1):
        bad |= np.asarray(exp2(e)) != np.ldexp(np.float32(1),
                                               e.astype(np.int32))
    return bad


@pytest.mark.parametrize("inputs", ["normal", "near_powers_of_two"])
def test_natural_differs_only_where_xla_is_inexact(inputs):
    d = 1 << 16
    rng = np.random.default_rng(10)
    if inputs == "normal":
        x = normal(10, (d,))
    else:  # within 3 ulp of 2**e, both signs
        p2 = np.ldexp(np.float32(1), rng.integers(-100, 100, d))
        x = np.nextafter(p2, np.float32(np.inf) * rng.choice([-1, 1], d))
        for _ in range(2):
            x = np.where(rng.random(d) < 0.5, x,
                         np.nextafter(x, np.float32(-np.inf)))
        x = (x * rng.choice([-1, 1], d)).astype(np.float32)
    x[:3] = [0.0, -0.0, np.nan]
    jk, tk = keys(11, 12)
    want = np.asarray(jax.jit(jcomp.Natural().__call__)(jk, jnp.asarray(x)))
    got = tcomp.Natural()(tk, torch.from_numpy(x)).numpy()
    differs = bits(want) != bits(got)
    inexact = _xla_inexact(x)
    assert not np.any(differs & ~inexact)
    if inputs == "near_powers_of_two":
        assert differs.any()
    # the port's exponents are the exact ones: each output is +-2**e or
    # +-2**(e + 1) with e = floor(log2|x|), or 0
    a = np.abs(x[3:])
    e = np.frexp(a)[1] - 1
    mag = np.abs(got[3:])
    assert np.all((mag == np.ldexp(np.float32(1), e))
                  | (mag == np.ldexp(np.float32(1), e + 1)))


def test_natural_exponent_helpers_exact():
    e = torch.arange(-160, 140, dtype=torch.float32)
    with np.errstate(over="ignore"):
        want = np.ldexp(np.float32(1), e.numpy().astype(np.int32),
                        dtype=np.float32)
    np.testing.assert_array_equal(tcomp.exp2_int(e).numpy().view(np.uint32),
                                  want.astype(np.float32).view(np.uint32))
    x = torch.tensor([1.0, 1.5, 2.0, np.nextafter(np.float32(2), 0),
                      1e-40, 3e38, np.inf])
    np.testing.assert_array_equal(
        tcomp.floor_log2(x).numpy(),
        [0, 0, 1, 0, -133, 127, np.inf])


@pytest.mark.parametrize("n,m", [(4, 2), (7, 3), (5, 5), (1, 1)])
def test_mnice_joint_and_marginal(n, m):
    """joint_call: the first m of ``jax.random.permutation(round_key, n)``
    keep (n/m) x; __call__: one uniform draw."""
    j, t = jcomp.MNice(n, m), tcomp.MNice(n, m)
    x = normal(n * m, (300,))
    for r in range(4):
        jk, tk = keys(r, 13)
        for w in range(n):
            want = jax.jit(j.joint_call, static_argnums=1)(jk, w,
                                                           jnp.asarray(x))
            assert_bits(want, t.joint_call(tk, w, torch.from_numpy(x)))
        want = jax.jit(j.__call__)(jk, jnp.asarray(x))
        assert_bits(want, t(tk, torch.from_numpy(x)))


TABLE = ["identity", "none", "topk:64", "randk:8", "scaled_randk:8",
         "comp:1,56", "comp:64,64", "mix:8,56", "block_topk:256,16",
         "block_topk:1024,64", "sign", "natural", "qsgd:16", "qsgd:400",
         "frac_topk:50", "frac_comp:10,200"]


@pytest.mark.parametrize("spec", TABLE)
def test_certified_constants_over_the_table(spec):
    j, t = jcomp.make_compressor(spec), tcomp.make_compressor(spec)
    assert t == port_of(j)
    for d in (896, 4_358_144):
        for n in (1, 2, 5):
            assert (t.eta(d), t.omega(d), t.omega_av(d, n)) == \
                (j.eta(d), j.omega(d), j.omega_av(d, n))
    mn_j, mn_t = jcomp.MNice(5, 2), tcomp.MNice(5, 2)
    assert mn_t.omega_av(896, 5) == mn_j.omega_av(896, 5)
    assert tcomp.MNice(1, 1).omega_av(896, 1) == 0.0


def test_unknown_compressor_raises_like_jax():
    for mod in (jcomp, tcomp):
        with pytest.raises(ValueError, match="unknown compressor"):
            mod.make_compressor("bogus:3")


@pytest.mark.parametrize("members,n", [((), 2), (("topk:4", "sign"), 1),
                                       (("mnice",), 3)])
def test_expand_fleet_errors_like_jax(members, n):
    def build(mod):
        return tuple(mod.MNice(3, 2) if m == "mnice"
                     else mod.make_compressor(m) for m in members)

    with pytest.raises(ValueError) as jerr:
        jcomp.expand_fleet(build(jcomp), n)
    with pytest.raises(ValueError) as terr:
        tcomp.expand_fleet(build(tcomp), n)
    assert str(terr.value) == str(jerr.value)


def test_expand_fleet_round_robin():
    j = jcomp.expand_fleet((jcomp.TopK(4), jcomp.QSGD(16)), 5)
    t = tcomp.expand_fleet((tcomp.TopK(4), tcomp.QSGD(16)), 5)
    assert t == tuple(port_of(c) for c in j)

# ---------------------------------------------------------------------------
# The compressor bench
#
# The port's compressor bench (``repro_torch.launch.compressor_bench``)
# run on the CPU: its rows carry the JAX bench's names, and its
# ``wire/codec_*`` rows are those of the JAX bench's
# ``codec_payload_rows()``, character for character.
# ---------------------------------------------------------------------------


JAX_COMPRESSOR_ROWS = ["topk_1pc", "randk_1pc", "comp_k_kp",
                       "block_topk_core", "natural", "qsgd_s16",
                       "block_topk_ref"]


@pytest.fixture(scope="module")
def cpu_rows():
    return tbench.main(["--device", "cpu"])


def test_codec_rows_equal_jax(cpu_rows):
    want = {r["name"]: r["derived"] for r in jbench.codec_payload_rows()}
    got = {r["name"]: r["derived"] for r in cpu_rows
           if r["name"].startswith("wire/codec_")}
    assert len(want) == 9
    assert got == want


def test_row_names(cpu_rows, capsys):
    names = [r["name"] for r in cpu_rows]
    assert names[:7] == [f"compressor/{n}" for n in JAX_COMPRESSOR_ROWS]
    assert names[7:10] == ["compressor/block_topk_kernel",
                           "wire/unfused_compress_pack", "wire/fused_pack"]
    assert names[-1] == "wire/fused_pack_bytes"
    assert "not measured on cpu" in cpu_rows[-1]["derived"]
    assert all(float(r["us_per_call"]) > 0 for r in cpu_rows[:10])
    # the printed CSV form: name,us_per_call,derived
    tbench.emit(cpu_rows[:1])
    assert capsys.readouterr().out == \
        f"{names[0]},{cpu_rows[0]['us_per_call']},d=65536\n"


def test_fused_pack_row_payload_bits_equal_jax(cpu_rows):
    """The JAX bench's ``packed_vs_dense`` row: d = 2**16, block 1024,
    kb 16."""
    from repro.distributed import wire as jwire

    lw = jwire.LeafWire(shape=(1 << 16,), size=1 << 16, block=1024, kb=16)
    bits = jwire.WireFormat((lw,)).bits_per_round()
    row = next(r for r in cpu_rows if r["name"] == "wire/fused_pack")
    assert row["derived"] == f"d={1 << 16} payload_bits={bits}"


def test_full_needs_the_card():
    import torch

    with pytest.raises(RuntimeError, match="cuda"):
        tbench.full_rows(torch.device("cpu"))


# ---------------------------------------------------------------------------
# The spec grammar
#
# ``repro/core/specgrammar.py``'s parsers and printers, in the port's
# ``core/compressors.py``: every case of ``tests/test_specgrammar.py`` (its
# lists are imported, so a case added there runs here too), with the port's
# parse equal to JAX's (same classes, same fields) and its format equal to
# JAX's character for character, errors included.  Tolerance: none.
# ---------------------------------------------------------------------------

import json as _json  # noqa: E402
import pathlib  # noqa: E402

from test_specgrammar import CODEC_SPECS as G_CODECS  # noqa: E402
from test_specgrammar import DOWNLINK_SPECS as G_DOWNLINKS  # noqa: E402
from test_specgrammar import FLEET_SPECS as G_FLEETS  # noqa: E402
from test_specgrammar import LEAF_RULE_SPECS as G_RULES  # noqa: E402
from test_specgrammar import PIPELINE_SPECS as G_PIPES  # noqa: E402

from repro.core import specgrammar as jgrammar  # noqa: E402
from repro.core import efbv as jefbv_  # noqa: E402
from repro_torch.core import efbv as tefbv_  # noqa: E402

SPECS_DIR = pathlib.Path(__file__).resolve().parents[1] / "examples" / "specs"


def _errors_alike(jfn, tfn):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as jerr:
        jfn()
    with pytest.raises(ValueError) as terr:
        tfn()
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


@pytest.mark.parametrize("spec", G_CODECS)
def test_grammar_atom_parse_and_format_like_jax(spec):
    j, t = jgrammar.parse_compressor(spec), tcomp.parse_compressor(spec)
    assert t == port_of(j) == tcomp.make_compressor(spec)
    canon = tcomp.format_compressor(t)
    assert canon == jgrammar.format_compressor(j)
    assert tcomp.parse_compressor(canon) == t


def test_grammar_atom_errors_like_jax():
    assert tcomp.format_compressor(tcomp.make_compressor("none")) == \
        "identity"
    msg = _errors_alike(lambda: jgrammar.format_compressor(jcomp.MNice(4, 2)),
                        lambda: tcomp.format_compressor(tcomp.MNice(4, 2)))
    assert "no spec-string spelling" in msg
    msg = _errors_alike(lambda: jgrammar.parse_compressor("nope:3"),
                        lambda: tcomp.parse_compressor("nope:3"))
    assert "unknown compressor 'nope'; known:" in msg


@pytest.mark.parametrize("spec", G_FLEETS)
def test_grammar_fleet_parse_and_format_like_jax(spec):
    n = 8
    j, t = jgrammar.parse_fleet(spec, n), tcomp.parse_fleet(spec, n)
    assert t == tuple(port_of(c) for c in j) == tcomp.make_fleet(spec, n)
    assert len(t) == n
    canon = tcomp.format_fleet(t)
    assert canon == jgrammar.format_fleet(j)
    assert tcomp.parse_fleet(canon, n) == t


@pytest.mark.parametrize("spec,n", [(" ; ", 4), ("sign;sign;sign", 2)])
def test_grammar_fleet_errors_like_jax(spec, n):
    _errors_alike(lambda: jcomp.make_fleet(spec, n),
                  lambda: tcomp.make_fleet(spec, n))


@pytest.mark.parametrize("spec", G_RULES)
def test_grammar_leaf_rules_parse_and_format_like_jax(spec):
    j = jgrammar.parse_leaf_rules(spec)
    t = tcomp.parse_leaf_rules(spec)
    assert t == tuple((p, port_of(c)) for p, c in j)
    assert twire.parse_leaf_rules(spec) == t
    canon = tcomp.format_leaf_rules(t)
    assert canon == jgrammar.format_leaf_rules(j)
    assert tcomp.parse_leaf_rules(canon) == t


def test_grammar_leaf_rules_catch_all_and_errors_like_jax():
    rules = tcomp.parse_leaf_rules("embed*=qsgd:16;sign")
    assert rules == (("embed*", tcomp.QSGD(16)), ("*", tcomp.SignNorm()))
    assert tcomp.format_leaf_rules(rules) == "embed*=qsgd:16;*=sign"
    for bad in ("=qsgd:16", "embed*=", "embed*=mnice:4,2"):
        _errors_alike(lambda: jwire.parse_leaf_rules(bad),
                      lambda: twire.parse_leaf_rules(bad))
    _errors_alike(
        lambda: jgrammar.format_leaf_rules((("e*", jcomp.MNice(4, 2)),)),
        lambda: tcomp.format_leaf_rules((("e*", tcomp.MNice(4, 2)),)))
    spec = "embed*=qsgd:16;*norm*=identity"
    jrules, trules = jwire.parse_leaf_rules(spec), twire.parse_leaf_rules(spec)
    for path in ("embed", "layers/norm", "head"):
        jr = jwire.resolve_leaf(jrules, path, None)
        assert twire.resolve_leaf(trules, path, None) == (
            None if jr is None else port_of(jr))


@pytest.mark.parametrize("spec", G_DOWNLINKS + ["qsgd:16@0.5", "randk:8"])
def test_grammar_downlink_parse_and_format_like_jax(spec):
    jpair, tpair = jgrammar.parse_downlink(spec), tcomp.parse_downlink(spec)
    jdl, tdl = jefbv_.Downlink.parse(spec), tefbv_.Downlink.parse(spec)
    if jpair is None:
        assert tpair is None and jdl is None and tdl is None
    else:
        assert tpair == (port_of(jpair[0]), jpair[1])
        assert tdl == tefbv_.Downlink(compressor=tpair[0], lam=tpair[1])
    canon = tcomp.format_downlink(tpair)
    assert canon == jgrammar.format_downlink(jpair)
    assert tcomp.parse_downlink(canon) == tpair
    assert tcomp.format_downlink(tdl) == canon


def test_grammar_downlink_canonical_spellings():
    assert tcomp.format_downlink(None) == "none"
    assert tcomp.format_downlink((tcomp.QSGD(16), 1.0)) == "qsgd:16"
    assert tcomp.format_downlink((tcomp.TopK(64), 0.9)) == "topk:64@0.9"
    assert tcomp.parse_downlink("topk:64@0.9") == (tcomp.TopK(64), 0.9)


@pytest.mark.parametrize("spec", G_PIPES + ["depth:2"])
def test_grammar_pipeline_parse_and_format_like_jax(spec):
    depth = tcomp.parse_pipeline(spec)
    assert depth == jgrammar.parse_pipeline(spec)
    canon = tcomp.format_pipeline(depth)
    assert canon == jgrammar.format_pipeline(depth)
    assert tcomp.parse_pipeline(canon) == depth
    if depth <= 1:
        assert tefbv_.Pipeline.parse(spec) == tefbv_.Pipeline(depth=depth)
        assert tcomp.format_pipeline(tefbv_.Pipeline(depth=depth)) == canon
    else:
        _errors_alike(lambda: jefbv_.Pipeline.parse(spec),
                      lambda: tefbv_.Pipeline.parse(spec))


@pytest.mark.parametrize("bad", ["depth:", "async", "depth:x"])
def test_grammar_pipeline_bad_spec_like_jax(bad):
    msg = _errors_alike(lambda: jefbv_.Pipeline.parse(bad),
                        lambda: tefbv_.Pipeline.parse(bad))
    assert f"pipeline spec {bad!r} (want off | depth:0 | depth:1)" in msg


@pytest.mark.parametrize("path", sorted(SPECS_DIR.glob("*.json")),
                         ids=lambda p: p.stem)
def test_grammar_committed_spec_files_like_jax(path):
    payload = _json.loads(path.read_text())
    n = int(payload.get("n", 1))
    fleet = tcomp.parse_fleet(payload.get("compressor", "identity"), n)
    assert tcomp.format_fleet(fleet) == jgrammar.format_fleet(
        jgrammar.parse_fleet(payload.get("compressor", "identity"), n))
    pair = tcomp.parse_downlink(payload.get("downlink", ""))
    assert tcomp.parse_downlink(tcomp.format_downlink(pair)) == pair
    rules = tcomp.parse_leaf_rules(payload.get("leaf_codecs", ""))
    assert tcomp.format_leaf_rules(rules) == jgrammar.format_leaf_rules(
        jgrammar.parse_leaf_rules(payload.get("leaf_codecs", "")))
    depth = tcomp.parse_pipeline(payload.get("pipeline", "off"))
    assert tcomp.parse_pipeline(tcomp.format_pipeline(depth)) == depth


def test_contract_scaled_and_bias_variance_like_jax():
    """``scaled`` multiplies the output; the Monte-Carlo (bias, variance)
    estimate draws the same keys as JAX's, so rand-k's agrees to f32
    rounding (JAX's vmapped sums run in another order)."""
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    y = tcomp.scaled(tcomp.TopK(8), 0.5)(None, torch.from_numpy(x))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jcomp.TopK(8)(None, jnp.asarray(x))) * 0.5)
    from repro.core.contract import bias_variance_estimate as jbve
    want = jbve(jcomp.RandK(8), jax.random.key(3), jnp.asarray(x), 64)
    got = tcomp.bias_variance_estimate(tcomp.RandK(8), R.key(3),
                                       torch.from_numpy(x), 64)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tcomp.RandK(8).alpha(64) == jcomp.RandK(8).alpha(64)


# ---------------------------------------------------------------------------
# The trainer's wire: every zoo uplink, wire dtypes, and the per-leaf wire
#
# ``aggregate.compress_local`` (sparse_allgather) against JAX's, jitted as
# the JAX trainer runs it, on a small nested tree with a (2, 128) leaf, a
# 3-value leaf, a size-1 leaf and a 0-d leaf, at f32, bf16 and f16: every
# payload component and every h' bitwise.  JAX runs its Pallas kernels in
# interpret mode (``REPRO_WIRE_KERNEL=interpret``): the port's kernel
# wrappers follow the kernels (faults e, f), and every plain codec rounds
# h + lam d as XLA does under ``jit`` (one FMA, two roundings after a
# decode that ends in a select; faults a, r).  Inputs are multiples of 1/64
# with |x| <= 1, so the QSGD norm and the sign scale are exact sums in any
# order (fault c) and natural's exponents are exact in XLA too; natural on
# normal draws differs only where XLA's log2/exp2 are inexact (fault j).
# Then ``TreeWire`` against JAX's ``tree_format_for`` and the cases of
# JAX's ``tests/test_tree_wire.py``: single-leaf parity over the zoo,
# composed bits, degenerate leaves and zero messages.
# ---------------------------------------------------------------------------

from repro.core.efbv import EFBV as JEFBV  # noqa: E402
from repro.distributed import aggregate as jagg  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core.efbv import EFBV  # noqa: E402
from repro_torch.distributed import aggregate as tagg  # noqa: E402

ZOO_UPLINKS = ["identity", "topk:64", "randk:64", "scaled_randk:64",
               "comp:16,128", "mix:16,32", "block_topk:128,8",
               "block_topk:32,4", "sign", "natural", "qsgd:16",
               "frac_topk:50", "frac_comp:10,200"]
WIRE_DTYPES = ["float32", "bfloat16", "float16"]
LAM_W = 0.37


def _small_tree(seed, normal_draws=False):
    rng = np.random.default_rng(seed)

    def leaf(shape):
        if normal_draws:
            return rng.standard_normal(shape).astype(np.float32)
        return (rng.integers(-64, 65, shape) / 64).astype(np.float32)

    return {"a": leaf((40, 64)), "b": {"w": leaf((2, 128)),
                                       "bias": leaf((3,))},
            "c": leaf((1,)), "d": leaf(())}


def _wire_bits(a):
    """The raw bytes of a payload component or h' (numpy or torch; a
    bitmap's uint32 words are the port's int32 words)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _both_compress_local(spec, dt, g, h, monkeypatch, rules=None):
    monkeypatch.setenv("REPRO_WIRE_KERNEL", "interpret")
    jr = tuple(jwire.parse_leaf_rules(rules)) if rules else None
    tr = twire.parse_leaf_rules(rules) if rules else None
    jalgo = JEFBV(jcomp.make_compressor(spec), lam=LAM_W, nu=0.5,
                  leaf_rules=jr)
    talgo = EFBV(tcomp.make_compressor(spec), lam=LAM_W, nu=0.5,
                 leaf_rules=tr)
    jk, tk = keys(13, 3)
    want = jax.jit(lambda k, g_, h_: jagg.compress_local(
        jalgo, k, g_, h_, mode="sparse_allgather", wire_dtype=dt))(
            jk, jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, h))
    got = tagg.compress_local(talgo, tk, T.params_from_jax(g, "cpu"),
                              T.params_from_jax(h, "cpu"),
                              mode="sparse_allgather", wire_dtype=dt)
    return want, got


@pytest.mark.parametrize("dt", WIRE_DTYPES)
@pytest.mark.parametrize("spec", ZOO_UPLINKS)
def test_compress_local_zoo_bitwise_vs_jitted_jax(spec, dt, monkeypatch):
    (jm, jh), (tm, th) = _both_compress_local(
        spec, dt, _small_tree(1), _small_tree(2), monkeypatch)
    jmsg, tmsg = jax.tree.leaves(jm), T.leaves(tm)
    assert len(jmsg) == len(tmsg)
    for w, t in zip(jmsg, tmsg):
        assert tuple(np.shape(w)) == tuple(t.shape)
        assert np.asarray(w).dtype.itemsize == t.element_size()
        np.testing.assert_array_equal(_wire_bits(w), _wire_bits(t))
    for w, t in zip(jax.tree.leaves(jh), T.leaves(th)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(_wire_bits(w), _wire_bits(t))
    fmt = twire.format_for(tcomp.make_compressor(spec),
                           T.params_from_jax(_small_tree(1), "cpu"),
                           wire_dtype=dt)
    assert 8 * twire.payload_bytes(tm) == fmt.bits_per_round()


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("spec", ["block_topk:128,8", "block_topk:32,4",
                                  "topk:64", "identity"])
def test_compress_local_non_f32_wire_specials_like_jax(spec, dt,
                                                       monkeypatch):
    """-0.0 innovations (g = -0.0, h = +0.0), a NaN, and values beyond
    f16's range on a bf16/f16 wire: the plain path's payload rounds them
    to the wire type as XLA converts, and h' tracks the rounded values,
    bitwise JAX's jitted ``compress_local``."""
    g, h = _small_tree(9), _small_tree(10)
    g["a"][0, :16], h["a"][0, :16] = -0.0, 0.0
    g["a"][1, 3] = np.nan
    g["a"][2, :4] = [7e4, -9e4, 3e38, -3e38]
    g["b"]["w"][0, :8], h["b"]["w"][0, :8] = -0.0, 0.0
    (jm, jh), (tm, th) = _both_compress_local(spec, dt, g, h, monkeypatch)
    for w, t in zip(jax.tree.leaves(jm), T.leaves(tm)):
        np.testing.assert_array_equal(_wire_bits(w), _wire_bits(t))
    for w, t in zip(jax.tree.leaves(jh), T.leaves(th)):
        np.testing.assert_array_equal(_wire_bits(w), _wire_bits(t))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_compress_local_natural_differs_only_where_xla_is_inexact(
        dt, monkeypatch):
    """Natural on normal draws: exponents and h' differ from JAX's only at
    the values whose exponent XLA takes inexactly (fault j)."""
    g, h = _small_tree(3, True), _small_tree(4, True)
    (jm, jh), (tm, th) = _both_compress_local("natural", dt, g, h,
                                              monkeypatch)
    for j, (gl, hl) in enumerate(zip(jax.tree.leaves(g),
                                     jax.tree.leaves(h))):
        inexact = _xla_inexact((gl - hl).reshape(-1))
        exps_differ = np.asarray(jm[j][0]) != tm[j][0].numpy()
        h_differ = (np.asarray(jax.tree.leaves(jh)[j]).reshape(-1).view(
            np.uint32) != T.leaves(th)[j].reshape(-1).numpy().view(
                np.uint32))
        assert not np.any(exps_differ & ~inexact)
        assert not np.any(h_differ & ~inexact)
        np.testing.assert_array_equal(_wire_bits(jm[j][1]),
                                      _wire_bits(tm[j][1]))


def test_compress_local_leaf_rules_bitwise_vs_jitted_jax(monkeypatch):
    """Per-leaf rules on the small tree: QSGD, identity, sign and top-k
    leaves beside block-top-k, on a bf16 wire."""
    rules = "a=qsgd:16;*bias=identity;c=sign;d=topk:4"
    (jm, jh), (tm, th) = _both_compress_local(
        "block_topk:32,4", "bfloat16", _small_tree(5), _small_tree(6),
        monkeypatch, rules)
    for w, t in zip(jax.tree.leaves(jm), T.leaves(tm)):
        np.testing.assert_array_equal(_wire_bits(w), _wire_bits(t))
    for w, t in zip(jax.tree.leaves(jh), T.leaves(th)):
        np.testing.assert_array_equal(_wire_bits(w), _wire_bits(t))


def test_wire_dtype_codecs_and_bits_like_jax():
    """Every codec's kind, value dtype, bits and kernel flag at each wire
    dtype equal JAX's; QSGD, sign and natural ignore the dtype; a bad
    dtype is refused with JAX's message."""
    ttree = T.params_from_jax(_small_tree(1), "cpu")
    for spec in ZOO_UPLINKS:
        for dt in WIRE_DTYPES:
            j = jwire.format_for(jcomp.make_compressor(spec), _small_tree(1),
                                 wire_dtype=dt)
            t = twire.format_for(tcomp.make_compressor(spec), ttree,
                                 wire_dtype=dt)
            assert [(c.kind, c.payload_bits, c.has_kernel,
                     getattr(c, "val_dtype", None)) for c in t.leaves] == \
                [(c.kind, c.payload_bits, c.has_kernel,
                  getattr(c, "val_dtype", None)) for c in j.leaves], \
                (spec, dt)
    with pytest.raises(ValueError, match="not in"):
        twire.codec_of(tcomp.TopK(4), (8,), 8, "float64").payload_bits


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("spec", ["block_topk:256,16", "randk:64"])
def test_non_f32_wire_takes_the_plain_path(spec, dt):
    """A kernel codec on a bf16/f16 wire: ``auto`` takes the plain encode
    -> decode -> update before any launch (h' tracks the rounded values),
    ``cuda`` raises; the payload values are the rounded f32 ones."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    codec = twire.codec_of(tcomp.make_compressor(spec), (1000,), 1000, dt)
    assert not codec.has_kernel
    g = torch.from_numpy(normal(1, (1000,)))
    h = torch.from_numpy(normal(2, (1000,)))
    reset_launches()
    (vals, idx), hn = codec.encode_update(R.key(3), g, h, LAM_W)
    assert not any(LAUNCHES.values())
    assert vals.dtype == twire.val_torch_dtype(dt)
    d = codec.decode((vals, idx))
    np.testing.assert_array_equal(hn.numpy(), (h + LAM_W * d).numpy())
    with pytest.raises(ValueError, match="cuda"):
        codec.encode_update(R.key(3), g, h, LAM_W, kernel="cuda")


def test_tree_wire_equals_jax_on_smoke_tree():
    """``TreeWire`` of the smoke qwen2 tree under the mixed-codec rules:
    paths, kinds, bits by leaf and the composed total equal JAX's
    ``tree_format_for`` (BENCH_bits ``tree_wire``: 6,832,160 bits,
    0.147847x dense); no rules is the flat format."""
    rules = "*embed*=qsgd:16;*norm*=identity"
    ttree = build_model(get_smoke_config("qwen2-0.5b")).init_abstract()
    j = jwire.tree_format_for(jcomp.BlockTopK(256, 16),
                              _jax_smoke_abstract(),
                              rules=jwire.parse_leaf_rules(rules))
    t = twire.tree_format_for(tcomp.BlockTopK(256, 16), ttree,
                              rules=twire.parse_leaf_rules(rules))
    assert isinstance(t, twire.TreeWire)
    assert t.paths == j.paths
    assert [c.kind for c in t.leaves] == [c.kind for c in j.leaves]
    assert t.bits_by_leaf() == j.bits_by_leaf()
    assert t.bits_per_round() == sum(t.bits_by_leaf()) == 6_832_160
    assert f"{t.bits_per_round() / t.dense_bits():.6f}" == "0.147847"
    assert [_fields(c) for c in t.compressors] == \
        [_fields(c) for c in j.compressors]
    flat = twire.tree_format_for(tcomp.BlockTopK(256, 16), ttree)
    assert type(flat) is twire.WireFormat
    assert flat.bits_per_round() == SMOKE_BITS


def _fields(c):
    return (type(c).__name__, dataclasses.asdict(c))


TREE_ZOO = ["identity", "topk:8", "randk:8", "scaled_randk:8", "comp:4,16",
            "mix:4,4", "block_topk:32,4", "sign", "natural", "qsgd:16",
            "frac_topk:125"]


@pytest.mark.parametrize("spec", TREE_ZOO)
def test_tree_wire_single_leaf_parity_over_the_zoo(spec):
    """A one-leaf TreeWire (no rules) is the flat wire: payload and h'
    bitwise the flat codec's under ``fold_in(key, 0)``, its bits the
    codec's; the payload equals JAX's TreeWire's (jitted) and decodes to
    the compressor's dense output."""
    x = exact_sum_normal(7, 64)
    h = exact_sum_normal(8, 64)
    tree = {"x": torch.from_numpy(x)}
    fmt = twire.TreeWire.for_tree(tcomp.make_compressor(spec), tree)
    codec = twire.codec_of(tcomp.make_compressor(spec), (64,), 64)
    assert fmt.leaves == (codec,) and fmt.bits_by_leaf() == \
        (codec.payload_bits,)
    jk, tk = keys(21, 22)
    pays, hn = fmt.encode_update(tk, tree, {"x": torch.from_numpy(h)},
                                 LAM_W)
    p0, h0 = codec.encode_update(R.fold_in(tk, 0), torch.from_numpy(x),
                                 torch.from_numpy(h), LAM_W)
    for a, b in zip(pays[0], p0):
        assert torch.equal(a, b)
    assert torch.equal(hn["x"], h0)
    jfmt = jwire.TreeWire.for_tree(jcomp.make_compressor(spec),
                                   {"x": jnp.zeros(64)})
    jp = jax.jit(lambda k, g_, h_: jfmt.encode_update(k, g_, h_, LAM_W)[0])(
        jk, {"x": jnp.asarray(x)}, {"x": jnp.asarray(h)})
    for a, b in zip(jp[0], pays[0]):
        assert_bits(a, b)
    dense = fmt.decode(pays)["x"]
    want = fmt.compressors[0](R.fold_in(tk, 0), torch.from_numpy(x - h))
    np.testing.assert_array_equal(dense.numpy(), want.numpy())


def exact_sum_normal(seed, d):
    """Multiples of 1/64 with |x| <= 4: norms and L1 sums exact in f32."""
    return (np.random.default_rng(seed).integers(-256, 257, d) / 64).astype(
        np.float32)


NESTED = {"embed": (16, 8), "mlp": {"w": (64,), "bias": (1,)}, "scale": ()}
MIXED_RULES = "embed*=qsgd:16;*bias=identity"


def _nested(lib, t=NESTED):
    """NESTED's tree of zeros in JAX or torch."""
    if isinstance(t, dict):
        return {k: _nested(lib, v) for k, v in t.items()}
    return (jnp.zeros if lib == "jax" else torch.zeros)(t)


def test_tree_wire_composed_bits_is_sum_of_leaf_bits():
    fmt = twire.TreeWire.for_tree(tcomp.make_compressor("block_topk:32,4"),
                                  _nested("torch"),
                                  rules=twire.parse_leaf_rules(MIXED_RULES))
    j = jwire.TreeWire.for_tree(jcomp.make_compressor("block_topk:32,4"),
                                _nested("jax"),
                                rules=jwire.parse_leaf_rules(MIXED_RULES))
    assert [c.kind for c in fmt.leaves] == ["qsgd_quant", "dense_pack",
                                            "block_sparse", "block_sparse"]
    assert fmt.bits_by_leaf() == j.bits_by_leaf()
    per_worker = fmt.bits_per_round()
    assert per_worker == sum(fmt.bits_by_leaf()) == j.bits_per_round()
    assert fmt.bits_per_round(n_workers=4) == 4 * per_worker
    assert fmt.dense_bits() == 32 * (16 * 8 + 64 + 1 + 1)
    # the bits follow the path, not where the leaf sits in the tree
    named = [("embed", torch.zeros(16, 8)), ("w", torch.zeros(64)),
             ("tiny", torch.zeros(5))]
    layouts = [dict(named), {"outer": dict(named[::-1])},
               (dict(named[:1]), dict(named[1:]))]
    rules = twire.parse_leaf_rules("*embed*=qsgd:16")
    fmts = [twire.TreeWire.for_tree(tcomp.TopK(8), t, rules=rules)
            for t in layouts]
    assert len({f.bits_per_round() for f in fmts}) == 1
    assert len({tuple(sorted(f.bits_by_leaf())) for f in fmts}) == 1


DEGENERATE = {"scalar": (), "one": (1,), "tiny": (3,), "wide": (64,)}


@pytest.mark.parametrize("spec", ["topk:8", "randk:8", "scaled_randk:8",
                                  "block_topk:32,4", "mix:4,4", "comp:4,16",
                                  "qsgd:16", "sign", "natural"])
def test_tree_wire_degenerate_leaves(spec):
    """k above a leaf's size clamps per leaf: encode, decode, zero and
    masked messages work on 0-d, size-1 and size-3 leaves, each payload
    equal to JAX's (jitted), and the masked and zero messages decode to
    exactly zero."""
    ttree = {k: torch.zeros(s) for k, s in DEGENERATE.items()}
    jtree = {k: jnp.zeros(s) for k, s in DEGENERATE.items()}
    fmt = twire.TreeWire.for_tree(tcomp.make_compressor(spec), ttree)
    jfmt = jwire.TreeWire.for_tree(jcomp.make_compressor(spec), jtree)
    assert fmt.bits_by_leaf() == jfmt.bits_by_leaf()
    jk, tk = keys(3, 4)
    jks, tks = jfmt.leaf_keys(jk), fmt.leaf_keys(tk)
    for j, codec in enumerate(fmt.leaves):
        delta = exact_sum_normal(100 + j, codec.size)
        payload = codec.encode(tks[j], torch.from_numpy(delta))
        want = jax.jit(jfmt.leaves[j].encode)(jks[j], jnp.asarray(delta))
        for a, b in zip(want, payload):
            assert_bits(a, b)
        assert codec.decode(payload).shape == (codec.size,)
        zero = twire.zero_message(codec, tks[j], "cpu")
        assert not codec.decode(zero).any()
        masked = codec.mask_message(payload, 0.0)
        assert not codec.decode(masked).any()


@pytest.mark.parametrize("spec", ["block_topk:32,4", "qsgd:16", "natural",
                                  "mix:4,4"])
def test_tree_wire_zero_messages_like_jax(spec):
    """The pipelined priming payloads of a mixed tree: leaf j keyed
    ``fold_in(base, j)``, bitwise JAX's ``zero_messages``, decoding to
    exactly zero; ``mask_messages`` at 0 zeroes a real message."""
    rules = "embed*=qsgd:16;*bias=identity"
    fmt = twire.TreeWire.for_tree(tcomp.make_compressor(spec),
                                  _nested("torch"),
                                  rules=twire.parse_leaf_rules(rules))
    jfmt = jwire.TreeWire.for_tree(jcomp.make_compressor(spec),
                                   _nested("jax"),
                                   rules=jwire.parse_leaf_rules(rules))
    jk, tk = keys(5, 6)
    got = fmt.zero_messages(tk, "cpu")
    want = jfmt.zero_messages(jk)
    for w, t in zip(jax.tree.leaves(want), T.leaves(got)):
        assert_bits(w, t)
    for leaf in T.leaves(fmt.decode(got)):
        assert not leaf.any()
    g = T.tree_map(lambda z: torch.ones_like(z), _nested("torch"))
    pays, _ = fmt.encode_update(tk, g, _nested("torch"), LAM_W)
    for leaf in T.leaves(fmt.decode(fmt.mask_messages(pays, 0.0))):
        assert not leaf.any()
    stacked = [tuple(torch.stack([a, a]) for a in p) for p in pays]
    total = fmt.decode_sum(stacked)
    one = fmt.decode(pays)
    for a, b in zip(T.leaves(total), T.leaves(one)):
        np.testing.assert_array_equal(a.numpy(), (b + b).numpy())


# -- the fine-tuning harness's wire: expert-sparse rules, the zoo rows, and
# -- the fsdp layout -----------------------------------------------------------

import json  # noqa: E402
import os  # noqa: E402

from conftest import run_with_devices  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import ExperimentSpec, build  # noqa: E402
from repro_torch.distributed import aggregate as tagg  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.layers import EXPERT_LEAVES, is_spec  # noqa: E402
from repro_torch.optim.optimizers import adamw  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

SPECS_DIR = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "specs")
#: ``BENCH_bits.json``'s ``zoo_scaling`` rows of the committed fsdp specs,
#: as literals: fingerprint, up, down and total bits, vs dense both ways
ZOO_ROWS = {
    "zoo_mamba2_fsdp.json": ("6a9502177435874c", 5_484_544, 2_734_432,
                             8_218_976, 0.150313),
    "zoo_qwen2_fsdp.json": ("e379cbd8a0e45487", 23_105_536, 11_553_216,
                            34_658_752, 0.150002),
    "finetune_moe.json": ("f67bc877b3e73340", 21_024_768, 13_658_528,
                          34_683_296, 0.12697),
}
FAMILY_SMOKES = ("qwen2-0.5b", "granite-moe-3b-a800m", "mamba2-130m",
                 "zamba2-7b", "whisper-medium", "qwen2-vl-2b")


def _spec(name):
    return ExperimentSpec.from_json(open(os.path.join(SPECS_DIR,
                                                      name)).read())


def test_expert_sparse_rules_equal_jax_and_the_committed_spec():
    """``expert_sparse_rules`` is JAX's on granite-moe's smoke tree (the
    committed ``finetune_moe.json`` rules) and on its full tree cut to 8
    layers (8 of 40 experts routed: K = 0.2 of the dense budget), for
    block-top-k and top-k bases, with JAX's errors."""
    from repro.configs import get_config as jget_config

    for full, layers in ((False, None), (True, 8)):
        jcfg = (jget_config if full else jget_smoke_config)(
            "granite-moe-3b-a800m")
        tcfg = (get_config if full else get_smoke_config)(
            "granite-moe-3b-a800m")
        if layers:
            jcfg = dataclasses.replace(jcfg, n_layers=layers)
            tcfg = dataclasses.replace(tcfg, n_layers=layers)
        jtree = jbuild_model(jcfg).init_abstract()
        ttree = build_model(tcfg).init_abstract()
        kw = dict(n_experts=tcfg.n_experts,
                  experts_per_tok=tcfg.experts_per_tok)
        for base in ("block_topk:256,16", "topk:100"):
            want = jloop.expert_sparse_rules(
                jtree, jcomp.make_compressor(base), **kw)
            got = tlaunch.expert_sparse_rules(
                ttree, tcomp.make_compressor(base), **kw)
            assert got == want
        if not full:
            assert got.split(";")[0] == "layers/moe/wd=topk:50"
            assert _spec("finetune_moe.json").leaf_codecs == \
                tlaunch.expert_sparse_rules(
                    ttree, tcomp.make_compressor("block_topk:256,16"), **kw)
    assert (kw["experts_per_tok"], kw["n_experts"]) == (8, 40)
    with pytest.raises(ValueError, match="entry budget"):
        tlaunch.expert_sparse_rules(ttree, tcomp.make_compressor("qsgd:16"),
                                    **kw)
    with pytest.raises(ValueError, match="no MoE subtree"):
        tlaunch.expert_sparse_rules({"w": torch.zeros(4, 4)},
                                    tcomp.BlockTopK(256, 16), **kw)


@pytest.mark.parametrize("name", list(ZOO_ROWS))
def test_zoo_scaling_rows_pinned(name):
    """Each committed fsdp spec's fingerprint and its round's exact bits
    on its smoke tree, as ``BENCH_bits.json``'s ``zoo_scaling`` row holds
    them (literals here); the moe row's expert leaves at exactly half of
    their dense block-top-k bits."""
    fp, up, down, total, ratio = ZOO_ROWS[name]
    spec = _spec(name)
    assert spec.fingerprint() == fp and spec.backend == "fsdp"
    run = build(spec)
    tree = build_model(get_smoke_config(spec.problem)).init_abstract()
    rb = run.round_bits(tree)
    assert (rb["up"], rb["down"], rb["total"]) == (up, down, total)
    assert round(rb["total"] / rb["dense_both_ways"], 6) == ratio
    if spec.leaf_codecs:
        paths = twire.leaf_paths(tree)
        expert = [i for i, p in enumerate(paths)
                  if p.split("/")[-1] in EXPERT_LEAVES
                  and "moe" in p.split("/")]
        bits = [sum(twire.tree_format_for(
            run.compressor, tree, wire_dtype=spec.wire_dtype,
            rules=rules).bits_by_leaf()[i] for i in expert)
            for rules in (run.leaf_rules, (("*", run.compressor),))]
        assert bits == [1_572_864, 3_145_728]


_JAX_FSDP_LAYOUT = """
    import json
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_mesh
    from repro.models import build_model
    from repro.optim import adamw, constant
    from repro.train import fsdp_specs, fsdp_state_shardings, init_train_state

    def specs(tree):
        return [[list(e) if isinstance(e, tuple) else e for e in tuple(
            s.spec if isinstance(s, NamedSharding) else s)]
            for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
                x, (P, NamedSharding)))]

    out = {}
    for arch in ARCHS:
        model = build_model(get_smoke_config(arch))
        shapes = jax.eval_shape(model.init, jax.random.key(0))
        for shape in SHAPES:
            mesh = make_mesh(shape)
            state = jax.eval_shape(lambda p: init_train_state(
                p, adamw(constant(1e-3)), mesh, bidirectional=True), shapes)
            sh = fsdp_state_shardings(mesh, model.param_specs(), state)
            out[f"{arch} {shape[0]}x{shape[1]}"] = {
                "fsdp_specs": specs(fsdp_specs(mesh, model.param_specs(),
                                               shapes)),
                "params": specs(sh.params), "w": specs(sh.w),
                "h": specs(sh.h), "h_avg": specs(sh.h_avg),
                "m": specs(sh.opt_state["m"]), "v": specs(sh.opt_state["v"]),
                "count": specs(sh.opt_state["count"])}
    print("FSDP_LAYOUT " + json.dumps(out))
"""


#: the meshes of the fsdp layout check: worker axes alone, and with a
#: 'model' axis of 2 and 4
FSDP_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2), (2, 4))
#: JAX's fsdp layouts, computed once for every mesh (one subprocess)
_JAX_FSDP = {}


def _jax_fsdp_layouts():
    if not _JAX_FSDP:
        code = _JAX_FSDP_LAYOUT.replace("ARCHS", repr(FAMILY_SMOKES)).replace(
            "SHAPES", repr(FSDP_MESHES))
        out = run_with_devices(code, 8)
        _JAX_FSDP.update(json.loads(out.split("FSDP_LAYOUT ", 1)[1]))
    return _JAX_FSDP


@pytest.mark.parametrize("shape", FSDP_MESHES,
                         ids=[f"{a}x{b}" for a, b in FSDP_MESHES])
def test_fsdp_specs_and_state_shardings_equal_jax(shape):
    """``fsdp_specs`` and ``fsdp_state_shardings`` (``Run.state_shardings``
    of an fsdp spec) give JAX's specs leaf for leaf, as tuples, for the
    smoke tree of each family on the mesh (JAX on eight host devices in a
    subprocess); m, v and h_avg take the fsdp spec of the first param of
    their shape (JAX's ``spec_for``), whose worker dim differs from their
    own param's only at the leaves of ``FSDP_BY_SHAPE``.  On a 'model'
    axis the worker axes take the first dim that neither the model spec
    shards nor the worker count leaves a remainder on."""
    want_all = _jax_fsdp_layouts()
    js = lambda tree: json.loads(json.dumps(  # noqa: E731
        T.leaves(tree, is_leaf=is_spec)))
    n, m = shape
    key = f"{n}x{m}"
    for arch in FAMILY_SMOKES:
        model = build_model(get_smoke_config(arch))
        logical = model.init_abstract()
        mesh = tagg.make_mesh(shape)
        spec = ExperimentSpec(backend="fsdp", problem=arch, smoke=True,
                              mesh=key, n=n, d=64, downlink="qsgd:16")
        run = build(spec)
        state = run.init_state(logical, adamw(lambda s: 1e-3))
        sh = run.state_shardings(mesh, model.param_specs(), state)
        w = want_all[f"{arch} {key}"]
        fspecs = ttrainer.fsdp_specs(mesh, model.param_specs(), logical)
        assert js(fspecs) == w["fsdp_specs"], (arch, key)
        for k in ("params", "w", "h", "h_avg"):
            assert js(getattr(sh, k)) == w[k], (arch, key, k)
        for k in ("m", "v"):
            assert js(sh.opt_state[k]) == w[k], (arch, key, k)
        assert js(sh.opt_state["count"]) == w["count"]
        dims = tagg.fsdp_dims(sh.params, mesh)
        by_shape = tagg.fsdp_dims(sh.opt_state["m"], mesh)
        assert tagg.fsdp_dims(sh.h_avg, mesh) == by_shape
        paths = twire.leaf_paths(logical)
        assert [(paths[j], dims[j], by_shape[j])
                for j in range(len(dims)) if dims[j] != by_shape[j]] \
            == FSDP_BY_SHAPE.get((arch, key), []), (arch, key)


#: the leaves whose m, v and h_avg JAX's shape-keyed ``spec_for`` gives
#: the fsdp spec of another param of their shape, with another worker dim
#: (None: whole) than their own param's, by (arch, mesh): (path, param's
#: dim, that dim).  The port lays m, v and h_avg out so too
#: (``FsdpShards.slot_of``; ``tests/test_torch_aggregate.py::
#: test_slots_lie_as_jax_lays_them_out``).
FSDP_BY_SHAPE = {
    ("qwen2-0.5b", "4x1"): [("layers/attn/wq", 1, 2), ("layers/ln1", 1, None),
                        ("layers/ln2", 1, None)],
    ("granite-moe-3b-a800m", "4x1"): [("layers/attn/wq", 1, 2)],
    ("zamba2-7b", "1x1"): [("shared_attn/attn/wo", 1, 0)],
    ("zamba2-7b", "2x1"): [("shared_attn/attn/wo", 1, 0)],
    ("zamba2-7b", "4x1"): [("shared_attn/attn/wo", 1, 0)],
    ("zamba2-7b", "2x2"): [("shared_attn/attn/wo", 1, 0)],
    ("zamba2-7b", "2x4"): [("shared_attn/attn/wo", 1, 0)],
    ("whisper-medium", "4x1"): [("encoder/attn/wo", 2, 1),
                            ("layers/attn/wo", 2, 1),
                            ("layers/xattn/wo", 2, 1)],
    ("qwen2-vl-2b", "4x1"): [("layers/attn/wq", 1, 2), ("layers/ln1", 1, None),
                         ("layers/ln2", 1, None)],
}
