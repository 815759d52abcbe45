"""The port's compress_local + combine_global against the JAX ones, n = 2.

Identical f32 gradients and control variates (numpy, from a seed) go
through both packages.  The JAX side runs under ``jax.jit``, as its
trainer does, with the Pallas pack kernel in interpret mode: under jit the
interpret kernel's h update stays a multiply then an add, while the master
update and the dense worker update are contracted into FMAs.  The port
spells each site the same way, so everything is compared bit for bit:
payloads, h_i, g and h_avg.

With n = 2 the scatter-sum of duplicate indices is exact in either order
(0 + a + b == 0 + b + a), so the decode order cannot differ either.

Rand-k (the ``RandKSparse`` codec): the positions are drawn from the same
keys in both packages, so payloads, h_i, g and h_avg are compared bit for
bit against the Pallas kernel in interpret mode, and the (n, k) decode-sum
at n = 3, where the order of three colliding values matters.

The last section holds every wire codec against the JAX package's; its own
notes head it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressors import BlockTopK as JBlockTopK
from repro.core.compressors import RandK as JRandK
from repro.core.efbv import EFBV as JEFBV
from repro.distributed import aggregate as jagg
from repro_torch import random as R
from repro_torch import tree as T
from repro_torch.core.compressors import BlockTopK, RandK
from repro_torch.core.efbv import EFBV
from repro_torch.distributed import aggregate as tagg

N = 2
LAM, NU = 0.37, 0.61
SHAPES = {"a": (1000,), "b": {"c": (64, 300), "d": (896,)}, "e": (3, 512)}


def _tree(rng):
    def leaf(shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"a": leaf(SHAPES["a"]),
            "b": {"c": leaf(SHAPES["b"]["c"]), "d": leaf(SHAPES["b"]["d"])},
            "e": leaf(SHAPES["e"])}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    grads = [_tree(rng) for _ in range(N)]
    hs = [_tree(rng) for _ in range(N)]
    h_avg = _tree(rng)
    return grads, hs, h_avg


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_tree_bitwise(want, got):
    wl, gl = jax.tree.leaves(want), T.leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert np.asarray(w).shape == g.shape
        np.testing.assert_array_equal(_bits(w), _bits(g))


def _jax_round(mode, grads, hs, h_avg, comp=None):
    algo = JEFBV(comp or JBlockTopK(256, 16), lam=LAM, nu=NU)
    local = jax.jit(lambda k, g, h: jagg.compress_local(algo, k, g, h,
                                                        mode=mode))
    combine = jax.jit(lambda m, ha: jagg.combine_global(
        algo, m, ha, n_workers=N, mode=mode))
    key = jax.random.key(9)
    msgs, h_new = zip(*[local(jax.random.fold_in(key, i), g, h)
                        for i, (g, h) in enumerate(zip(grads, hs))])
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *msgs)
    g, h_avg_new = combine(stacked, h_avg)
    return msgs, h_new, g, h_avg_new


def _torch_round(mode, grads, hs, h_avg, comp=None):
    algo = EFBV(comp or BlockTopK(256, 16), lam=LAM, nu=NU)
    to_t = lambda t: T.tree_map(torch.from_numpy, t)  # noqa: E731
    key = R.key(9)
    out = [tagg.compress_local(algo, R.fold_in(key, i), to_t(g), to_t(h),
                               mode=mode)
           for i, (g, h) in enumerate(zip(grads, hs))]
    msgs, h_new = zip(*out)
    g, h_avg_new = tagg.combine_global(algo, tagg.stack_messages(msgs),
                                       to_t(h_avg), n_workers=N, mode=mode)
    return msgs, h_new, g, h_avg_new


@pytest.mark.parametrize("kernel", ["auto", "oracle"])
def test_sparse_allgather_bitwise_vs_jax_interpret(monkeypatch, kernel):
    """``auto`` goes through the kernel wrapper (its plain version on CPU
    tensors), ``oracle`` through the layout-spec oracle."""
    monkeypatch.setenv("REPRO_WIRE_KERNEL", "interpret")
    monkeypatch.setenv("REPRO_TORCH_WIRE_KERNEL", kernel)
    grads, hs, h_avg = _inputs(0)
    want = _jax_round("sparse_allgather", grads, hs, h_avg)
    got = _torch_round("sparse_allgather", grads, hs, h_avg)
    for w, t in zip(want, got):
        _assert_tree_bitwise(w, t)


def test_dense_psum_bitwise_vs_jax():
    grads, hs, h_avg = _inputs(1)
    want = _jax_round("dense_psum", grads, hs, h_avg)
    got = _torch_round("dense_psum", grads, hs, h_avg)
    for w, t in zip(want, got):
        _assert_tree_bitwise(w, t)


def _assert_h_within_one_operand_ulp(h_old, want, got, ulps=1):
    """|want - got| <= ``ulps`` ulps of the largest of |h|, |lam d| and the
    result: the fused and the unfused spelling differ only in the rounding
    of lam * d and of the sum, at most half an ulp each (cancellation can
    make that many ulps of a small result)."""
    for h0, w, t in zip(jax.tree.leaves(h_old), jax.tree.leaves(want),
                        T.leaves(got)):
        w, t = np.asarray(w), t.numpy()
        big = np.maximum(np.maximum(np.abs(h0), np.abs(w - h0)), np.abs(w))
        assert np.all(np.abs(w - t) <= ulps * np.spacing(big))


def test_sparse_and_dense_agree():
    """The wire format changes, Algorithm 1 does not: both modes give the
    same g and h_avg for a deterministic compressor.  h_i differs only in
    rounding: the sparse path's h update is the kernel's multiply-then-add,
    the dense path's the jitted worker update's FMA."""
    grads, hs, h_avg = _inputs(2)
    _, h_s, g_s, ha_s = _torch_round("sparse_allgather", grads, hs, h_avg)
    _, h_d, g_d, ha_d = _torch_round("dense_psum", grads, hs, h_avg)
    for a, b in zip(T.leaves((g_s, ha_s)), T.leaves((g_d, ha_d))):
        assert torch.equal(a, b)
    for h0, a, b in zip(hs, h_s, h_d):
        _assert_h_within_one_operand_ulp(
            h0, T.tree_map(lambda x: x.numpy(), a), b)


def test_jitted_oracle_fuses_the_h_update(monkeypatch):
    """Fault (e): the JAX package's jitted jnp oracle (its off-TPU default)
    contracts h + lam * d into an FMA, the Pallas kernel does not.  The
    port follows the kernel, so against the jitted oracle the payloads are
    equal and h_i agrees within one ulp of the update's larger operand."""
    monkeypatch.setenv("REPRO_WIRE_KERNEL", "oracle")
    grads, hs, h_avg = _inputs(3)
    j_msgs, j_h, _, _ = _jax_round("sparse_allgather", grads, hs, h_avg)
    t_msgs, t_h, _, _ = _torch_round("sparse_allgather", grads, hs, h_avg)
    for w, t in zip(j_msgs, t_msgs):
        _assert_tree_bitwise(w, t)
    for h0, w, t in zip(hs, j_h, t_h):
        _assert_h_within_one_operand_ulp(h0, w, t)


def test_efbv_init_matches_jax():
    _, _, h_avg = _inputs(4)
    jstate = JEFBV(JBlockTopK(256, 16), lam=LAM, nu=NU).init(
        jax.tree.map(jnp.asarray, h_avg), N)
    tstate = EFBV(BlockTopK(256, 16), lam=LAM, nu=NU).init(
        T.tree_map(torch.from_numpy, h_avg), N)
    _assert_tree_bitwise(jstate.h, tstate.h)
    _assert_tree_bitwise(jstate.h_avg, tstate.h_avg)
    assert int(jstate.step) == tstate.step == 0


# -- rand-k ------------------------------------------------------------------

def _codecs(size, k):
    return JRandK(k).codec((size,)), RandK(k).codec((size,))


def _keys(*data):
    jk, tk = jax.random.key(4), R.key(4)
    for d in data:
        jk, tk = jax.random.fold_in(jk, d), R.fold_in(tk, d)
    return jk, tk


@pytest.mark.parametrize("size,k", [(500, 300), (70_001, 5000), (896, 896)])
def test_randk_codec_encode_decode_bitwise(size, k):
    jc, tc = _codecs(size, k)
    x = np.random.default_rng(size).standard_normal(size).astype(np.float32)
    jk, tk = _keys(size)
    want = jax.jit(jc.encode)(jk, jnp.asarray(x))
    got = tc.encode(tk, torch.from_numpy(x))
    assert got[1].dtype == torch.int32
    _assert_tree_bitwise(want, got)
    _assert_tree_bitwise(jax.jit(jc.decode)(want), tc.decode(got))
    assert 8 * sum(a.numel() * a.element_size() for a in got) == \
        tc.payload_bits == jc.payload_bits


@pytest.mark.parametrize("n", [2, 3])
def test_randk_decode_sum_bitwise(n):
    """Worker-stacked (n, k) payloads on a small leaf, so positions collide
    across workers (three at a time for n = 3): the sum is taken in
    ascending worker order, as XLA's scatter takes it."""
    size, k = 500, 300
    jc, tc = _codecs(size, k)
    rng = np.random.default_rng(n)
    msgs_j, msgs_t = [], []
    for i in range(n):
        x = (rng.standard_normal(size) * 10.0 ** rng.integers(-3, 4, size)
             ).astype(np.float32)
        jk, tk = _keys(n, i)
        msgs_j.append(jc.encode(jk, jnp.asarray(x)))
        msgs_t.append(tc.encode(tk, torch.from_numpy(x)))
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *msgs_j)
    tstack = tagg.stack_messages(msgs_t)
    _assert_tree_bitwise(jax.jit(jc.decode_sum)(jstack), tc.decode_sum(tstack))
    if n == 3:
        counts = np.bincount(np.asarray(jstack[1]).reshape(-1),
                             minlength=size)
        assert (counts == 3).any()


@pytest.mark.parametrize("kernel", ["auto", "oracle"])
@pytest.mark.parametrize("size,k", [(70_001, 5000), (3001, 3001), (896, 1)])
def test_randk_encode_update_bitwise_vs_jax_interpret(size, k, kernel):
    """The port's kernel path (its plain version here) and its encode ->
    decode -> update both equal the Pallas kernel in interpret mode."""
    jc, tc = _codecs(size, k)
    rng = np.random.default_rng(k)
    g = rng.standard_normal(size).astype(np.float32)
    h = rng.standard_normal(size).astype(np.float32)
    h[::5] = -0.0
    jk, tk = _keys(size, k)
    want = jc.encode_update(jk, jnp.asarray(g), jnp.asarray(h), LAM,
                            kernel="interpret")
    got = tc.encode_update(tk, torch.from_numpy(g), torch.from_numpy(h), LAM,
                           kernel=kernel)
    _assert_tree_bitwise(want, got)


def test_randk_jitted_oracle_fuses_the_h_update():
    """Fault (f): JAX's jitted rand-k oracle (its off-TPU default) contracts
    h + lam * d into an FMA; its Pallas kernel and its eager oracle do not.
    The port follows the kernel: the payloads are equal, and h' agrees
    with the jitted oracle within one ulp of the update's larger operand.
    On these inputs (jax 0.9.0 on the CPU) 1,531 of the 70,001 values
    differ: the count ROADMAP.md records."""
    size, k = 70_001, 5000
    jc, tc = _codecs(size, k)
    rng = np.random.default_rng(0)
    g = rng.standard_normal(size).astype(np.float32)
    h = rng.standard_normal(size).astype(np.float32)
    jk, tk = _keys(size, k)
    (jv, ji), jh = jax.jit(lambda k_, g_, h_: jc.encode_update(
        k_, g_, h_, LAM, kernel="oracle"))(jk, jnp.asarray(g), jnp.asarray(h))
    (tv, ti), th = tc.encode_update(tk, torch.from_numpy(g),
                                    torch.from_numpy(h), LAM)
    _assert_tree_bitwise((jv, ji), (tv, ti))
    _assert_h_within_one_operand_ulp([h], [jh], [th])
    assert (_bits(jh) != _bits(th.numpy())).sum() == 1531


@pytest.mark.parametrize("size", [2**24 - 1, 2**24, 136_134_656])
def test_randk_has_kernel_below_2_24_like_jax(size):
    """Codec metadata only: a leaf takes the kernel below 2**24 values, as
    in the JAX package."""
    jc, tc = _codecs(size, 1_048_576)
    assert tc.has_kernel == jc.has_kernel == (size < 2**24)
    assert tc.scale == float(np.float32(size / 1_048_576))


def test_randk_cuda_mode_raises_on_cpu_tensors():
    _, tc = _codecs(1000, 10)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tc.encode_update(R.key(0), torch.zeros(1000), torch.zeros(1000), LAM,
                         kernel="cuda")


def test_randk_encode_update_takes_the_kernel_above_2_24(monkeypatch):
    """Unlike the JAX package, the port has no size dispatch: a leaf of
    2**24 values goes through the kernel wrapper too (its plain version on
    this CPU tensor), bit-equal to the encode -> decode -> update.  The
    positions come from a cheap stand-in for the shuffle (one strided
    draw), the same on both paths: the shuffle is tested on its own."""
    from repro_torch.distributed import wire

    size, k = 2**24, 4096
    _, tc = _codecs(size, k)
    assert not tc.has_kernel
    calls = []
    kernel = wire.ops.randk_update
    monkeypatch.setattr(wire.ops, "randk_update",
                        lambda *a: calls.append(1) or kernel(*a))
    monkeypatch.setattr(R, "choice", lambda key, n, k_, device: torch.arange(
        int(key[1]) % 97, n, n // k_, dtype=torch.int32)[:k_])
    rng = np.random.default_rng(24)
    g = torch.from_numpy(rng.standard_normal(size, dtype=np.float32))
    h = torch.from_numpy(rng.standard_normal(size, dtype=np.float32))
    sel = torch.arange(5, size, size // k)[:k]   # the stand-in's R.key(5)
    g[sel[:8]], h[sel[:8]] = -0.0, 0.0
    g[sel[8:16]], h[sel[8:16]] = -0.0, -0.0
    h[sel[16:24]] = -0.0
    h[:4] = -0.0
    got = tc.encode_update(R.key(5), g, h, LAM)
    assert calls == [1]
    want = tc.encode_update(R.key(5), g, h, LAM, kernel="oracle")
    _assert_tree_bitwise(want, got)


def test_randk_sparse_round_bitwise_vs_jax_interpret(monkeypatch):
    """compress_local + combine_global over the sparse wire with rand-k,
    n = 2, per-leaf keys fold_in(fold_in(key, i), j), against the Pallas
    kernel in interpret mode: payloads, h_i, g and h_avg bit for bit."""
    monkeypatch.setenv("REPRO_WIRE_KERNEL", "interpret")
    grads, hs, h_avg = _inputs(5)
    want = _jax_round("sparse_allgather", grads, hs, h_avg, comp=JRandK(64))
    got = _torch_round("sparse_allgather", grads, hs, h_avg, comp=RandK(64))
    for w, t in zip(want, got):
        _assert_tree_bitwise(w, t)


def test_randk_dense_round_vs_jax():
    """The dense path (``RandK.__call__`` and the worker update
    h + lam * d, an FMA as in the jitted JAX update): d_i, g and h_avg bit
    for bit.  Under jit XLA also merges the two constant factors of
    lam * ((x * mask) * f32(d/k)) into one, f32(lam * d/k), before its
    FMA.  The two products lam * f32(x * mask * d/k) and
    (x * mask) * f32(lam * d/k) each carry one rounding of relative 2**-24
    (together at most two ulps of lam * d), and each sum one more half
    ulp, so h_i agrees within three ulps of the update's larger operand
    (two measured)."""
    grads, hs, h_avg = _inputs(5)
    want = _jax_round("dense_psum", grads, hs, h_avg, comp=JRandK(64))
    got = _torch_round("dense_psum", grads, hs, h_avg, comp=RandK(64))
    for w, t in zip(want[::2], got[::2]):
        _assert_tree_bitwise(w, t)
    _assert_tree_bitwise(want[3], got[3])
    for h0, w, t in zip(hs, want[1], got[1]):
        _assert_h_within_one_operand_ulp(h0, w, t, ulps=3)


# -- the pipelined exchange --------------------------------------------------

from repro.core import compressors as jcomp  # noqa: E402
from repro.core.efbv import PIPELINE_FOLD as JPIPELINE_FOLD  # noqa: E402
from repro.distributed import wire as jwire  # noqa: E402
from repro_torch.core import compressors as tcomp  # noqa: E402
from repro_torch.core.efbv import PIPELINE_FOLD  # noqa: E402
from repro_torch.distributed import wire as twire  # noqa: E402

CODEC_SPECS = ["block_topk:16,4", "qsgd:16", "randk:8"]


def _codec_pair(spec, size=96):
    return (jwire.codec_of(jcomp.make_compressor(spec), (size,), size),
            twire.codec_of(tcomp.make_compressor(spec), (size,), size))


def _tile(payload, n):
    return tuple(torch.stack([a] * n) for a in payload)


@pytest.mark.parametrize("spec", CODEC_SPECS)
def test_zero_message_equals_jax_and_decodes_to_zero(spec):
    """The priming message of leaf j under the PIPELINE_FOLD key: equal to
    JAX's bit for bit, and it decodes to zeros alone and tiled over 4
    workers."""
    assert PIPELINE_FOLD == JPIPELINE_FOLD
    jc, tc = _codec_pair(spec)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(0),
                                               JPIPELINE_FOLD), 3)
    tk = R.fold_in(R.fold_in(R.key(0), PIPELINE_FOLD), 3)
    want = jwire.zero_message(jc, jk)
    got = twire.zero_message(tc, tk, "cpu")
    _assert_tree_bitwise(want, got)
    zeros = np.zeros(96, np.float32)
    np.testing.assert_array_equal(_bits(tc.decode_sum(got).numpy()),
                                  _bits(zeros))
    np.testing.assert_array_equal(
        _bits(tc.decode_sum(_tile(got, 4)).numpy()), _bits(zeros))


@pytest.mark.parametrize("spec", CODEC_SPECS)
def test_mask_message_identity_and_zero(spec):
    """m = 1 leaves a message bit for bit (one and 4 stacked); m = 0 makes
    it decode to zero in value; both equal JAX's ``mask_message`` with the
    same scalar bit for bit."""
    jc, tc = _codec_pair(spec)
    x = np.random.default_rng(5).standard_normal(96).astype(np.float32)
    x[::7] = -x[::7]
    msg = tc.encode(R.key(2), torch.from_numpy(x))
    for payload in (msg, _tile(msg, 4)):
        _assert_tree_bitwise(payload, twire.mask_message(payload, 1.0))
        jpayload = tuple(jnp.asarray(a.numpy()) for a in payload)
        for m in (0.0, 1.0):
            _assert_tree_bitwise(jc.mask_message(jpayload, m),
                                 twire.mask_message(payload, m))
    # value zero: QSGD decodes a masked negative level to -0.0, as JAX does
    np.testing.assert_array_equal(
        tc.decode_sum(twire.mask_message(msg, 0.0)).numpy(),
        np.zeros(96, np.float32))


def test_pipeline_chunks_equal_jax():
    for n in range(1, 9):
        assert twire.pipeline_chunks(n) == jwire.pipeline_chunks(n)


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("spec", CODEC_SPECS)
def test_chunked_decode_sum_equals_jax(spec, chunks):
    """4 stacked payloads of each codec (JAX's encodes, handed to both
    packages: QSGD's norms differ in their last bits between the two, fault
    (c)), decoded in 1, 2 and 4 worker chunks summed in ascending order, bit
    for bit; 3 chunks of 4 raise."""
    jc, tc = _codec_pair(spec)
    rng = np.random.default_rng(len(spec) + chunks)
    msgs_j = []
    for i in range(4):
        x = (rng.standard_normal(96) * 10.0 ** rng.integers(-3, 4, 96)
             ).astype(np.float32)
        msgs_j.append(jc.encode(_keys(chunks, i)[0], jnp.asarray(x)))
    msgs_t = [tuple(torch.from_numpy(np.array(a)) for a in m)
              for m in msgs_j]
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *msgs_j)
    tstack = tagg.stack_messages(msgs_t)
    _assert_tree_bitwise(jwire.chunked_decode_sum(jc, jstack, chunks),
                         twire.chunked_decode_sum(tc, tstack, chunks))
    with pytest.raises(ValueError, match="split"):
        twire.chunked_decode_sum(tc, tstack, 3)


@pytest.mark.parametrize("spec", CODEC_SPECS)
def test_compress_local_stream_equals_no_stream(spec, monkeypatch):
    """The port's compress_local (one pack kernel) against JAX's with
    ``stream=True`` (the pipelined trainer's pack) and ``stream=False``:
    the same payloads and h_i for every ported codec.  Integer inputs keep
    QSGD's squared sums exact in f32, so both packages' norms agree."""
    monkeypatch.setenv("REPRO_WIRE_KERNEL", "interpret")
    jcomp_ = jcomp.make_compressor(spec)
    comp = tcomp.make_compressor(spec)
    grads, hs, _ = _inputs(6)
    g, h = (T.tree_map(lambda a: np.rint(4 * a).astype(np.float32), t[0])
            for t in (grads, hs))
    got = tagg.compress_local(EFBV(comp, lam=LAM, nu=NU),
                              R.fold_in(R.key(9), 0),
                              T.tree_map(torch.from_numpy, g),
                              T.tree_map(torch.from_numpy, h),
                              mode="sparse_allgather")
    for stream in (False, True):
        want = jagg.compress_local(JEFBV(jcomp_, lam=LAM, nu=NU),
                                   jax.random.fold_in(jax.random.key(9), 0),
                                   g, h, mode="sparse_allgather",
                                   stream=stream)
        _assert_tree_bitwise(want, got)

# ---------------------------------------------------------------------------
# The wire codecs
#
# The port's wire codecs (``repro_torch.distributed.wire``) against the
# JAX package's: payload arrays, decodes, exact bit counts, the bitmap
# helpers, ``clamp_for_leaf`` and ``mask_message``.  Inputs from numpy
# seeds; tolerance: none (bit for bit).  Bitmaps are compared as the uint32
# words JAX sends (the port holds them as int32 with the same bits).  Where
# a payload reduces (the sign codec's L1 scale, the QSGD norm: ROADMAP
# fault c) the inputs are multiples of 1/16 whose sums are exact in f32 in
# any order; the natural codec's exponents may differ where XLA's f32
# ``log2``/``exp2`` is inexact (fault j), and nowhere else.
# ---------------------------------------------------------------------------


D = 1 << 12
SPECS = ["identity", "topk:40", "randk:40", "scaled_randk:40", "comp:40,400",
         "mix:20,20", "block_topk:1024,16", "sign", "natural", "qsgd:16",
         "frac_topk:10", "frac_comp:10,100"]


def keys(a=3):
    return (jax.random.fold_in(jax.random.key(0), a),
            R.fold_in(R.key(0), a))


def as_np(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def codecs(spec, d=D):
    return (jwire.codec_of(jcomp.make_compressor(spec), (d,), d),
            twire.codec_of(tcomp.make_compressor(spec), (d,), d))


def exact_sum_input(seed, d=D):
    """Multiples of 1/16, |x| <= 4: sums and squared sums exact in f32."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-64, 65, d) / 16).astype(np.float32)
    x[::97] = -0.0
    return x


def xla_inexact_natural(x):
    """Elements whose natural exponent XLA may get wrong (fault j)."""
    a = np.abs(x)
    safe = np.where(a > 0, a, np.float32(1))
    exact = (np.frexp(safe)[1] - 1).astype(np.float32)
    xla = np.asarray(jax.jit(lambda s: jnp.floor(jnp.log2(s)))(safe))
    bad = xla != exact
    for e in (xla, xla + 1):
        bad |= np.asarray(jax.jit(jnp.exp2)(e)) != np.ldexp(
            np.float32(1), e.astype(np.int32))
    return bad


@pytest.mark.parametrize("spec", SPECS)
def test_payload_decode_and_bits_equal_jax(spec):
    jc, tc = codecs(spec)
    assert (tc.kind, tc.payload_bits) == (jc.kind, jc.payload_bits)
    x = exact_sum_input(len(spec)) if spec.startswith(("sign", "qsgd")) \
        else np.random.default_rng(1).standard_normal(D).astype(np.float32)
    jk, tk = keys()
    want = jax.jit(jc.encode)(jk, jnp.asarray(x))
    got = tc.encode(tk, torch.from_numpy(x))
    assert 8 * twire.payload_bytes(got) == tc.payload_bits
    assert len(want) == len(got)
    jdec = np.asarray(jax.jit(jc.decode)(want))
    tdec = tc.decode(got).numpy()
    if spec == "natural":
        bad = xla_inexact_natural(x)
        np.testing.assert_array_equal(as_np(want[0])[~bad],
                                      as_np(got[0])[~bad])
        np.testing.assert_array_equal(as_np(want[1]), as_np(got[1]))
        # the port's decode is exact: +-2**e, 0 at the sentinel
        e = got[0].numpy().astype(np.int32)
        mag = np.where(e == -128, 0, np.ldexp(np.float32(1), e))
        np.testing.assert_array_equal(np.abs(tdec), mag)
        np.testing.assert_array_equal(as_np(jdec)[~bad], as_np(tdec)[~bad])
        return
    for w, g in zip(want, got):
        assert np.asarray(w).shape == tuple(g.shape)
        np.testing.assert_array_equal(as_np(w), as_np(g))
    np.testing.assert_array_equal(as_np(jdec), as_np(tdec))


@pytest.mark.parametrize("spec", ["sign", "natural", "identity", "topk:40",
                                  "block_topk:1024,16"])
def test_decode_sum_of_stacked_payloads(spec):
    """Two workers' payloads stacked on a leading axis decode to the sum of
    their decodes, as JAX's ``decode_sum`` (-0.0 + -0.0 sums to +0.0)."""
    jc, tc = codecs(spec)
    xs = [exact_sum_input(s) for s in (5, 6)]
    tp = [tc.encode(keys(s)[1], torch.from_numpy(x))
          for s, x in zip((7, 8), xs)]
    stacked = tuple(torch.stack(parts) for parts in zip(*tp))
    jstacked = tuple(jnp.asarray(a.numpy()) for a in stacked)
    if spec in ("sign", "natural"):  # the bitmap: uint32 words
        jstacked = (jstacked[0], jstacked[1].view(jnp.uint32))
    want = np.asarray(jc.decode_sum(jstacked))
    np.testing.assert_array_equal(as_np(want),
                                  as_np(tc.decode_sum(stacked)))


@pytest.mark.parametrize("m", [0, 17, 31, 32, 33, 1000])
def test_pack_bits_round_trip_and_equal_jax(m):
    b = np.random.default_rng(m).random(m) < 0.5
    if m:
        b[-1] = True  # the top bit of a full word: int32 sign bit
    words = twire.pack_bits(torch.from_numpy(b))
    assert words.dtype == torch.int32
    assert words.numel() == twire.bitmap_words(m) == jwire.bitmap_words(m)
    np.testing.assert_array_equal(
        as_np(words), np.asarray(jwire.pack_bits(jnp.asarray(b))))
    np.testing.assert_array_equal(twire.unpack_bits(words, m).numpy(), b)


CLAMP = [("topk:8", 5), ("topk:8", 8), ("randk:8", 3), ("scaled_randk:8", 2),
         ("comp:4,16", 10), ("comp:4,16", 3), ("comp:4,16", 16),
         ("mix:4,16", 10), ("mix:4,16", 3), ("mix:4,16", 100),
         ("block_topk:256,16", 5), ("block_topk:256,16", 300),
         ("qsgd:16", 1), ("sign", 1), ("natural", 1), ("frac_topk:10", 1),
         ("frac_comp:10,100", 1), ("identity", 1)]


@pytest.mark.parametrize("spec,size", CLAMP)
def test_clamp_for_leaf_every_family(spec, size):
    j = jwire.clamp_for_leaf(jcomp.make_compressor(spec), size)
    t = twire.clamp_for_leaf(tcomp.make_compressor(spec), size)
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jc, tc = codecs(spec, size)
    assert (tc.kind, tc.payload_bits) == (jc.kind, jc.payload_bits)


def test_codec_of_falls_back_to_dense():
    """An object that declares no codec gets the dense value stream, and
    m-nice the base class's."""
    def plain(key, x):
        return x * 2

    jc = jwire.codec_of(plain, (10,), 10)
    tc = twire.codec_of(plain, (10,), 10)
    assert (tc.kind, tc.payload_bits) == (jc.kind, jc.payload_bits)
    jm = jwire.codec_of(jcomp.MNice(4, 2), (10,), 10)
    tm = twire.codec_of(tcomp.MNice(4, 2), (10,), 10)
    assert (tm.kind, tm.payload_bits) == (jm.kind, jm.payload_bits)


@pytest.mark.parametrize("m,stacked", [(1.0, False), (0.0, False),
                                       (0.0, True)])
def test_natural_mask_message(m, stacked):
    """The natural codec gates on its sentinel exponent -128, not by
    scaling: m = 1 is the identity, m = 0 decodes to zero, on one message
    and on 3 worker-stacked ones."""
    jc, tc = codecs("natural")
    x = np.random.default_rng(2).standard_normal(D).astype(np.float32)
    x[:4] = 0.0
    tp = tc.encode(keys()[1], torch.from_numpy(x))
    if stacked:
        tp = tuple(torch.stack([a, a, a]) for a in tp)
    jp = (jnp.asarray(tp[0].numpy()), jnp.asarray(tp[1].numpy()).view(
        jnp.uint32))
    want = jc.mask_message(jp, m)
    got = tc.mask_message(tp, m)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(as_np(w), as_np(g))
    if m == 1.0:
        for a, b in zip(tp, got):
            assert torch.equal(a, b)
    else:
        assert not tc.decode_sum(got).any()


@pytest.mark.parametrize("spec", ["sign", "natural", "identity", "mix:20,20",
                                  "comp:40,400"])
def test_zero_message_decodes_to_zero_like_jax(spec):
    jc, tc = codecs(spec)
    jk, tk = keys(9)
    want = jwire.zero_message(jc, jk)
    got = twire.zero_message(tc, tk, "cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(as_np(w), as_np(g))
    assert not tc.decode_sum(got).any()


@pytest.mark.parametrize("spec", ["sign", "natural", "identity", "topk:40"])
def test_generic_encode_update_equals_jax_eager(spec):
    """Codecs without a kernel: encode -> decode -> h + lam * d, each op
    rounded on its own, as JAX's base ``encode_update`` computes it outside
    ``jit``; ``cuda`` raises for them."""
    jc, tc = codecs(spec)
    g, h = exact_sum_input(11), exact_sum_input(12)
    jk, tk = keys()
    want, wh = jc.encode_update(jk, jnp.asarray(g), jnp.asarray(h), 0.37,
                                kernel="oracle")
    got, gh = tc.encode_update(tk, torch.from_numpy(g), torch.from_numpy(h),
                               0.37)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(as_np(w), as_np(t))
    np.testing.assert_array_equal(as_np(wh), as_np(gh))
    with pytest.raises(ValueError, match="cuda"):
        tc.encode_update(tk, torch.from_numpy(g), torch.from_numpy(h), 0.37,
                         kernel="cuda")
