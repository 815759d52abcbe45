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

Then every wire codec against the JAX package's, partial participation
against the JAX package's, and the multi-process exchange (one process per
worker group, gloo on the CPU) against the one-process loop; each section's
own notes head it.
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


# ---------------------------------------------------------------------------
# Partial participation
#
# ``random.bernoulli``, ``Participation.sample_mask``, the (n,) form of
# ``mask_message``, the federated bit accounting and ``compress_local(mask=)``
# against the JAX package's, bit for bit; then one federated smoke round of
# the port's trainer against a JAX round assembled from its public pieces
# with JAX's masks (the tolerances of tests/test_torch_train.py: matmul
# sums differ in order between the two frameworks).
# ---------------------------------------------------------------------------

from repro.core import efbv as jefbv  # noqa: E402
from repro_torch.core.efbv import Participation  # noqa: E402
from repro_torch.core.efbv import participation_key  # noqa: E402

JParticipation, jparticipation_key = (jefbv.Participation,
                                      jefbv.participation_key)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.7, 1.0])
@pytest.mark.parametrize("n", [1, 5, 64])
def test_bernoulli_equals_jax(p, n):
    for d in range(4):
        jk, tk = _keys(d, n)
        want = np.asarray(jax.random.bernoulli(jk, p, (n,)))
        np.testing.assert_array_equal(R.bernoulli(tk, p, n, "cpu").numpy(),
                                      want)


@pytest.mark.parametrize("spec", ["full", "bernoulli:0.5", "bernoulli:0.3",
                                  "bernoulli:1.0", "fixed:1", "fixed:2",
                                  "fixed:3"])
@pytest.mark.parametrize("n", [3, 4, 8])
def test_sample_mask_equals_jax(spec, n):
    jp, tp = JParticipation.parse(spec), Participation.parse(spec)
    assert (tp.is_full, tp.fraction(n)) == (jp.is_full, jp.fraction(n))
    for d in range(5):
        jk, tk = _keys(d)
        want = np.asarray(jp.sample_mask(jparticipation_key(jk), n))
        got = tp.sample_mask(participation_key(tk), n, "cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", ["bernoulli:0", "bernoulli:1.5", "fixed:0",
                                  "half", "fixed"])
def test_participation_refuses_bad_specs(spec):
    with pytest.raises(ValueError):
        JParticipation.parse(spec)
    with pytest.raises(ValueError):
        Participation.parse(spec)


def test_fixed_participation_refuses_more_than_n():
    with pytest.raises(ValueError, match="only 2 workers"):
        Participation.parse("fixed:3").sample_mask(R.key(0), 2, "cpu")


@pytest.mark.parametrize("spec", CODEC_SPECS + ["natural", "sign",
                                                "identity"])
def test_stacked_mask_message_equals_jax(spec):
    """The (n,) mask gates each worker's row of the stacked payload: rows
    at 0 decode to zero, rows at 1 stay bit for bit; equal to JAX's."""
    jc, tc = _codec_pair(spec)
    rng = np.random.default_rng(len(spec))
    msgs = [tc.encode(R.fold_in(R.key(3), i), torch.from_numpy(
        rng.standard_normal(96).astype(np.float32))) for i in range(4)]
    stacked = tagg.stack_messages(msgs)
    mask = np.array([1, 0, 1, 0], np.float32)
    got = tc.mask_message(stacked, torch.from_numpy(mask))
    jstacked = tuple(jnp.asarray(a.numpy()) for a in stacked)
    if jc.kind in ("sign_pack", "natural_pack"):  # the bitmap: uint32 words
        jstacked = (jstacked[0], jstacked[1].view(jnp.uint32))
    want = jc.mask_message(jstacked, jnp.asarray(mask))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(as_np(w), as_np(t))
    for i in range(4):
        row = tuple(a[i] for a in got)
        if mask[i]:
            _assert_tree_bitwise(tuple(a[i] for a in stacked), row)
        else:
            assert not tc.decode(row).any()


@pytest.mark.parametrize("spec", ["block_topk:256,16", "qsgd:16",
                                  "randk:64"])
@pytest.mark.parametrize("n,mask", [(4, [1, 0, 1, 1]), (5, [0, 0, 0, 0, 0]),
                                    (33, [1] * 33), (2, [1, 0])])
def test_federated_bits_equal_jax(spec, n, mask):
    jtree = {"a": jnp.zeros((1000,)), "b": jnp.zeros((64, 300))}
    ttree = {"a": torch.zeros(1000), "b": torch.zeros(64, 300)}
    jfmt = jwire.format_for(jcomp.make_compressor(spec), jtree)
    tfmt = twire.format_for(tcomp.make_compressor(spec), ttree)
    for parts in (None, 0, 3, 1.5, float(n), 0.25 * n):
        want = jfmt.bits_per_round(n_workers=n, participants=parts)
        got = tfmt.bits_per_round(n_workers=n, participants=parts)
        assert got == want and type(got) is type(want)
    mask = np.asarray(mask, np.float32)
    want = jwire.federated_round_bits(jfmt, mask)
    assert twire.federated_round_bits(tfmt, torch.from_numpy(mask)) == want
    assert twire.federated_round_bits(tfmt, mask) == want
    down = twire.format_for(tcomp.QSGD(16), ttree)
    jdown = jwire.format_for(jcomp.QSGD(16), jtree)
    assert twire.total_round_bits(tfmt, down, n_workers=n,
                                  participants=0.5 * n) == \
        jwire.total_round_bits(jfmt, jdown, n_workers=n,
                               participants=0.5 * n)


@pytest.mark.parametrize("mode", ["sparse_allgather", "dense_psum"])
@pytest.mark.parametrize("m", [0.0, 1.0])
def test_compress_local_mask_equals_jax(mode, m, monkeypatch):
    """At m = 0 the message decodes to zero and h_i stays stale; at m = 1
    both gates are bitwise identities (the unmasked round's message and
    h_i).  Equal to JAX's ``compress_local(mask=)`` bit for bit."""
    monkeypatch.setenv("REPRO_WIRE_KERNEL", "interpret")
    grads, hs, _ = _inputs(8)
    jalgo = JEFBV(JBlockTopK(256, 16), lam=LAM, nu=NU)
    talgo = EFBV(BlockTopK(256, 16), lam=LAM, nu=NU)
    local = jax.jit(lambda k, g, h, mm: jagg.compress_local(
        jalgo, k, g, h, mode=mode, mask=mm))
    want = local(jax.random.key(9), grads[0], hs[0], jnp.float32(m))
    to_t = lambda t: T.tree_map(torch.from_numpy, t)  # noqa: E731
    got = tagg.compress_local(talgo, R.key(9), to_t(grads[0]), to_t(hs[0]),
                              mode=mode, mask=torch.tensor(m))
    for w, t in zip(want, got):
        _assert_tree_bitwise(w, t)
    plain = tagg.compress_local(talgo, R.key(9), to_t(grads[0]),
                                to_t(hs[0]), mode=mode)
    if m:
        _assert_tree_bitwise(plain, got)
    else:
        _assert_tree_bitwise(hs[0], got[1])


SMOKE_N, SMOKE_SEQ, SMOKE_BATCH, SMOKE_STEPS = 2, 16, 8, 3


def _smoke_cfg():
    """The qwen2 smoke config cut to one layer (852,736 params, under
    2**20) with f32 activations."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen2-0.5b"), n_layers=1,
                               activation_dtype="float32")


def test_federated_smoke_round_matches_jax():
    """fixed:1 of 2 workers for three steps, block-top-k up: the port's
    trainer against a JAX round of ``compress_local(mask=)`` and
    ``combine_global`` with JAX's masks, from the same params and
    batches.  Masks and participants are equal; losses within rtol 1e-5."""
    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.models import build_model as jbuild_model
    from repro.optim import adamw as jadamw
    from repro.optim import apply_updates as japply_updates
    from repro.optim import cosine as jcosine
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine
    from repro_torch.train.trainer import init_train_state, make_train_step

    jcfg = dataclasses.replace(jget_smoke_config("qwen2-0.5b"), n_layers=1,
                               activation_dtype="float32")
    jmodel = jbuild_model(jcfg)
    params_np = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    data = SyntheticLM(vocab=jcfg.vocab, seq_len=SMOKE_SEQ,
                       global_batch=SMOKE_BATCH, n_workers=SMOKE_N, seed=0)
    jpart, tpart = JParticipation.parse("fixed:1"), Participation.parse(
        "fixed:1")
    # JAX: the trainer's pieces, one worker after another
    algo = JEFBV(JBlockTopK(256, 16), lam=LAM, nu=NU)
    opt = jadamw(jcosine(3e-4, total_steps=SMOKE_STEPS, warmup_steps=1),
                 weight_decay=0.01)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b)[0]))
    local = jax.jit(lambda k, g, h, m: jagg.compress_local(
        algo, k, g, h, mode="sparse_allgather", mask=m))
    combine = jax.jit(lambda msg, ha: jagg.combine_global(
        algo, msg, ha, n_workers=SMOKE_N, mode="sparse_allgather"))
    params = params_np
    zeros = jax.tree.map(jnp.zeros_like, params)
    hs, h_avg, opt_state = [zeros] * SMOKE_N, zeros, opt.init(params)
    jlosses, jmasks = [], []
    per = SMOKE_BATCH // SMOKE_N
    for step in range(SMOKE_STEPS):
        batch = data.batch(step)
        k = jax.random.fold_in(jax.random.key(0), step)
        mask = jpart.sample_mask(jparticipation_key(k), SMOKE_N)
        msgs, losses = [], []
        for i in range(SMOKE_N):
            bi = {kk: v[i * per:(i + 1) * per] for kk, v in batch.items()}
            loss, grads = grad_fn(params, bi)
            msg, hs[i] = local(jax.random.fold_in(k, i), grads, hs[i],
                               mask[i])
            msgs.append(msg)
            losses.append(float(loss))
        g, h_avg = combine(jax.tree.map(lambda *x: jnp.stack(x), *msgs),
                           h_avg)
        updates, opt_state = opt.update(g, opt_state, params)
        params = japply_updates(params, updates)
        jlosses.append(float(np.mean(losses)))
        jmasks.append(np.asarray(mask))
    # the port
    model = build_model(_smoke_cfg())
    talgo = EFBV(BlockTopK(256, 16), lam=LAM, nu=NU)
    topt = adamw(cosine(3e-4, total_steps=SMOKE_STEPS, warmup_steps=1),
                 weight_decay=0.01)
    state = init_train_state(T.params_from_jax(params_np, "cpu"), topt,
                             n_workers=SMOKE_N, algo=talgo,
                             agg_mode="sparse_allgather")
    step_fn = make_train_step(model.loss, topt, talgo, n_workers=SMOKE_N,
                              agg_mode="sparse_allgather",
                              participation=tpart)
    for step in range(SMOKE_STEPS):
        k = R.fold_in(R.key(0), step)
        np.testing.assert_array_equal(
            tpart.sample_mask(participation_key(k), SMOKE_N, "cpu").numpy(),
            jmasks[step])
        state, m = step_fn(state, data.batch(step), k)
        assert float(m["participants"]) == 1.0
        np.testing.assert_allclose(float(m["loss"]), jlosses[step],
                                   rtol=1e-5)
    diff = np.concatenate([
        np.abs(b.numpy() - np.asarray(a)).reshape(-1) for a, b in
        zip(jax.tree.leaves(params), T.leaves(state.params))])
    assert np.mean(diff > 1e-5) < 1e-3 and diff.max() <= 9e-4


# ---------------------------------------------------------------------------
# One process per worker group (torch.distributed, gloo on the CPU)
#
# Ranks are spawned with torch.multiprocessing, rendezvous through a
# file:// store under tmp_path (no port to race for), one thread each, and
# a join time limit of DIST_TIMEOUT_S: a hung rank fails its test.  The
# one-process loop is the reference, run here with one thread too (CPU
# matmuls sum in another order with more threads).  Tolerance: none
# (bitwise), except dense_psum at n = 4, where the all-reduce's summation
# order differs from torch.mean's (below).
# ---------------------------------------------------------------------------

import contextlib  # noqa: E402
import io  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402

import torch.multiprocessing as tmp  # noqa: E402

from repro_torch.core.efbv import Downlink, Pipeline  # noqa: E402

DIST_TIMEOUT_S = 120
#: dense_psum at n = 4: gloo sums the four d_i in another order than
#: torch.mean (((d0 + d1) + d2) + d3); each d_bar differs by a few ulps, and
#: AdamW's normalised step turns that into params within 1e-6 of each other
#: after three steps (lr 3e-4); the losses agree to rtol 1e-6
DENSE4_PARAMS_ATOL, DENSE4_LOSS_RTOL = 1e-6, 1e-6

#: name -> (agg, uplink, downlink, pipelined, participation, n)
DIST_CASES = {
    "block_topk": ("sparse_allgather", "block_topk:256,16", False, False,
                   "full", 2),
    "pipelined": ("sparse_allgather", "block_topk:256,16", True, True,
                  "full", 2),
    "qsgd": ("sparse_allgather", "qsgd:16", True, False, "full", 2),
    "randk": ("sparse_allgather", "randk:4096", False, False, "full", 2),
    "dense_psum": ("dense_psum", "block_topk:256,16", False, False, "full",
                   2),
    "dense_psum_pipelined": ("dense_psum", "block_topk:256,16", False, True,
                             "full", 2),
    "fixed1": ("sparse_allgather", "block_topk:256,16", False, False,
               "fixed:1", 2),
    "bernoulli": ("sparse_allgather", "qsgd:16", True, False,
                  "bernoulli:0.5", 2),
    "n4": ("sparse_allgather", "block_topk:256,16", False, False, "full", 4),
    "n4_pipelined": ("sparse_allgather", "block_topk:256,16", True, True,
                     "fixed:3", 4),
    "dense_psum_n4": ("dense_psum", "block_topk:256,16", False, False,
                      "full", 4),
}


def _train_case(name, group=None):
    """SMOKE_STEPS steps of case ``name`` from params of a fixed seed:
    (losses, participants, final state as numpy: params, h_avg, w, this
    rank's h)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine
    from repro_torch.train.trainer import init_train_state, make_train_step

    agg, spec, down, pipelined, part, n = DIST_CASES[name]
    cfg = _smoke_cfg()
    model = build_model(cfg)
    algo = EFBV(tcomp.make_compressor(spec), lam=LAM, nu=NU)
    opt = adamw(cosine(3e-4, total_steps=SMOKE_STEPS, warmup_steps=1),
                weight_decay=0.01)
    pipeline = Pipeline(1) if pipelined else None
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    state = init_train_state(params, opt, n_workers=n, bidirectional=down,
                             algo=algo, agg_mode=agg, pipeline=pipeline,
                             group=group)
    step = make_train_step(model.loss, opt, algo, n_workers=n, agg_mode=agg,
                           downlink=Downlink(tcomp.QSGD(16)) if down
                           else None, pipeline=pipeline,
                           participation=Participation.parse(part),
                           group=group)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SMOKE_SEQ,
                       global_batch=SMOKE_BATCH, n_workers=n, seed=1)
    losses, parts = [], []
    for s in range(SMOKE_STEPS):
        state, m = step(state, data.batch(s), R.fold_in(R.key(SMOKE_N), s))
        losses.append(float(m["loss"]))
        parts.append(float(m.get("participants", n)))
    as_np = lambda t: None if t is None else T.tree_map(  # noqa: E731
        lambda a: a.numpy().copy(), t)
    return {"losses": losses, "participants": parts,
            "params": as_np(state.params), "h_avg": as_np(state.h_avg),
            "w": as_np(state.w), "h": as_np(state.h)}


def _rank_main(rank, world, store, fn, args, join):
    """One spawned rank, with RANK and WORLD_SIZE as torchrun sets them:
    join the group (file:// store) and run ``fn(group, *args)``, or with
    ``join`` False run ``fn(*args)``, which joins it itself; save the
    result for the parent."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if not join:
        out = fn(*args)
    else:
        group = tagg.WorkerGroup.join(args[0], backend="gloo", device="cpu",
                                      init_method=f"file://{store}/store")
        try:
            out = fn(group, *args)
        finally:
            group.close()
    torch.save(out, f"{store}/rank{rank}.pt")


def _spawn(tmp_path, world, fn, *args, join=True):
    """Run ``fn`` on ``world`` gloo ranks; their results in rank order.
    Fails (and kills every rank) when a rank raises or the ranks are not
    done within DIST_TIMEOUT_S."""
    ctx = tmp.start_processes(_rank_main, args=(world, str(tmp_path), fn,
                                                args, join),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks not done in {DIST_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _case_on_group(group, n, name):
    return _train_case(name, group)


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tree_bits_equal(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("name", [c for c in DIST_CASES
                                  if c != "dense_psum_n4"])
def test_multiprocess_step_equals_one_process_bitwise(name, tmp_path):
    """2 gloo ranks (n/2 workers each) against the one-process loop: the
    losses, participants, params, h_avg and w of three steps bit for bit on
    every rank, and each rank's h the loop's rows of its workers."""
    n = DIST_CASES[name][-1]
    with _one_thread():
        want = _train_case(name)
    ranks = _spawn(tmp_path, 2, _case_on_group, n, name)
    for r, got in enumerate(ranks):
        assert got["losses"] == want["losses"]
        assert got["participants"] == want["participants"]
        for k in ("params", "h_avg", "w"):
            if want[k] is not None:
                _tree_bits_equal(want[k], got[k])
        rows = T.tree_map(lambda a: a[r * n // 2:(r + 1) * n // 2],
                          want["h"])
        _tree_bits_equal(rows, got["h"])


def test_dense_psum_four_ranks_within_tolerance(tmp_path):
    """n = 4 on 4 ranks: the all-reduce's order differs from torch.mean's,
    so within DENSE4_*; the ranks agree with each other bit for bit."""
    with _one_thread():
        want = _train_case("dense_psum_n4")
    ranks = _spawn(tmp_path, 4, _case_on_group, 4, "dense_psum_n4")
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=DENSE4_LOSS_RTOL)
        for a, b in zip(T.leaves(want["params"]), T.leaves(got["params"])):
            np.testing.assert_allclose(b, a, rtol=0, atol=DENSE4_PARAMS_ATOL)
        _tree_bits_equal(ranks[0]["params"], got["params"])
        _tree_bits_equal(ranks[0]["h_avg"], got["h_avg"])


def _rings(group, n):
    rng = np.random.default_rng(group.rank)
    x = torch.from_numpy(rng.integers(0, 256, (5, 7), dtype=np.uint8))
    out = torch.empty((group.world, 5, 7), dtype=torch.uint8)
    torch.distributed.all_gather(list(out.unbind(0)), x)
    return {"ring": tagg.ring_allgather(group, x).numpy(),
            "gather": out.numpy()}


def test_ring_allgather_equals_all_gather(tmp_path):
    """3 ranks: the ring's P - 1 hops give what one all-gather gives, in
    rank order, on every rank."""
    ranks = _spawn(tmp_path, 3, _rings, 3)
    for got in ranks:
        np.testing.assert_array_equal(got["ring"], got["gather"])
        np.testing.assert_array_equal(got["ring"], ranks[0]["gather"])


TRANSPORT_SPECS = ["block_topk:256,16", "qsgd:16", "qsgd:200", "randk:37",
                   "identity"]


@pytest.mark.parametrize("spec", TRANSPORT_SPECS)
def test_byte_transport_round_trip(spec):
    """Every payload the trainer sends (TRAIN_COMPRESSORS; QSGD at s = 200
    has int16 levels) on leaves of odd sizes: 3 workers' messages packed
    into one byte buffer and viewed back equal ``stack_messages`` bit for
    bit, -0.0 and NaN values included, each component 4-byte aligned."""
    from repro_torch.launch.train import TRAIN_COMPRESSORS
    assert spec.partition(":")[0] in TRAIN_COMPRESSORS
    algo = EFBV(tcomp.make_compressor(spec), lam=LAM, nu=NU)
    rng = np.random.default_rng(len(spec))
    shapes = {"a": (1001,), "b": (3, 257), "c": (5,)}
    msgs = []
    for i in range(3):
        g = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
        g["a"][:3] = torch.tensor([-0.0, float("nan"), -5.0])
        h = T.tree_map(torch.zeros_like, g)
        msgs.append(tagg.compress_local(algo, R.fold_in(R.key(1), i), g, h,
                                        mode="sparse_allgather")[0])
    layout, row = tagg.byte_layout(msgs[0])
    assert row % tagg.ALIGN == 0 and all(off % tagg.ALIGN == 0
                                         for _, _, off, _ in layout)
    buf = tagg.pack_bytes(msgs)
    assert buf.dtype == torch.uint8 and tuple(buf.shape) == (3, row)
    got = tagg.unpack_bytes(buf, msgs[0])
    want = tagg.stack_messages(msgs)
    for w, t in zip(T.leaves(want), T.leaves(got)):
        assert w.dtype == t.dtype and w.shape == t.shape
        assert torch.equal(w.contiguous().view(torch.uint8),
                           t.contiguous().view(torch.uint8))
    if spec == "qsgd:200":
        assert T.leaves(got)[1].dtype == torch.int16


def test_worker_group_slices_like_jax():
    """Rank r of P owns workers [r n/P, (r + 1) n/P), as the JAX package's
    process_worker_slice numbers them; n % P != 0 is refused."""
    from repro.launch.mesh import process_worker_slice
    for n, P in [(2, 2), (4, 2), (8, 4), (6, 3), (5, 1)]:
        for r in range(P):
            g = tagg.WorkerGroup(n_workers=n, rank=r, world=P,
                                 backend="gloo", device=torch.device("cpu"))
            assert g.workers == process_worker_slice((n, 1), P, r)
    with pytest.raises(ValueError, match="whole workers"):
        tagg.WorkerGroup(n_workers=3, rank=0, world=2, backend="gloo",
                         device=torch.device("cpu"))
    with pytest.raises(ValueError, match="backend"):
        tagg.WorkerGroup(n_workers=2, rank=0, world=2, backend="mpi",
                         device=torch.device("cpu"))


# -- the driver ---------------------------------------------------------------

from repro_torch.launch import train as tlaunch  # noqa: E402

CLI = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "2", "--steps", "3",
       "--global-batch", "4", "--seq", "16", "--agg", "sparse_allgather",
       "--device", "cpu", "--log-every", "1"]


def _cli_rank(n, store, argv):
    """One rank of the driver: ``main`` joins the group itself (the store
    by --dist-init); returns what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.main(argv + ["--dist-backend", "gloo", "--dist-init",
                             f"file://{store}/driver"])
    return out.getvalue()


def _steps(text):
    """The step lines without their timing."""
    return [line.rsplit(" (", 1)[0] for line in text.splitlines()
            if line.startswith("[train] step")]


@pytest.mark.parametrize("flags", [
    ["--compressor", "block_topk:256,16", "--downlink", "qsgd:16",
     "--pipeline", "depth:1"],
    ["--compressor", "block_topk:256,16", "--participation", "fixed:1"]])
def test_cli_two_ranks_print_the_one_process_run(flags, tmp_path):
    """The driver on 2 gloo ranks: rank 0 prints the one-process run's
    bits and step lines (losses to the printed digit), the header
    ``ranks=2 backend=gloo`` and the exchange line; rank 1 prints
    nothing."""
    argv = CLI + flags
    with _one_thread(), contextlib.redirect_stdout(io.StringIO()) as one:
        tlaunch.main(argv)
    ranks = _spawn(tmp_path, 2, _cli_rank, 2, str(tmp_path), argv,
                   join=False)
    assert ranks[1] == ""
    out = ranks[0]
    assert " ranks=2 backend=gloo " in out
    assert _steps(out) == _steps(one.getvalue()) and len(_steps(out)) == 3
    wire_lines = [l for l in one.getvalue().splitlines() if "wire:" in l]
    assert wire_lines and all(l in out.splitlines() for l in wire_lines)
    assert "[train] exchange: ranks=2 backend=gloo 3 exchanges, " \
        f"{2 * 5_776_384 // 8} B per rank per round" in out


def test_cli_participation_prints_federated_lines(capsys):
    """--participation is ported: the header, the JAX driver's federated
    wire line, the total through participants=, and |S|=k/n each step."""
    with _one_thread():
        tlaunch.main(CLI + ["--compressor", "block_topk:256,16",
                            "--participation", "fixed:1", "--downlink",
                            "qsgd:16"])
    out = capsys.readouterr().out
    assert " participation=fixed:1 " in out
    assert "[train] wire: federated round (mask bitmap + E|S_t|=1 of 2 " \
        "payloads) ~0.69 MiB total (0.500x the full-participation round)" \
        in out
    assert f"total {32 + 5_776_384 + 11_553_216} bits/round up+down" in out
    assert out.count("|S|=1/2 ") == 3


@pytest.mark.parametrize("spec", ["bernoulli:0.5", "bernoulli:1", "full"])
def test_cli_parses_participation(spec, capsys):
    args = tlaunch.parse_args(["--smoke", "--device", "cpu",
                               "--participation", spec])
    assert Participation.parse(args.participation) == \
        Participation.parse(spec)


@pytest.mark.parametrize("spec", ["fixed:0", "some", "bernoulli:2"])
def test_cli_refuses_bad_participation(spec, capsys):
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--smoke", "--device", "cpu", "--participation",
                            spec])
    assert "--participation" in capsys.readouterr().err


def test_cli_needs_a_backend_under_torchrun(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--smoke", "--device", "cpu"])
    assert "--dist-backend" in capsys.readouterr().err
    args = tlaunch.parse_args(["--smoke", "--device", "cpu",
                               "--dist-backend", "gloo"])
    assert args.dist_backend == "gloo"


@pytest.mark.parametrize("cards,rank,want", [
    (2, 1, "cuda:1"), (4, 1, "cuda:1"), (1, 1, "cuda:0"), (0, 0, "cuda:0")])
def test_rank_device_rule(cards, rank, want):
    """cuda:LOCAL_RANK with a card per local rank, else every rank on
    cuda:0 (gloo only); the CPU when asked."""
    assert str(tlaunch.rank_device("cuda", "gloo", rank, 2, cards)) == want
    assert str(tlaunch.rank_device("cpu", "gloo", rank, 2, cards)) == "cpu"


@pytest.mark.parametrize("device,cards", [("cuda", 1), ("cuda", 0),
                                          ("cpu", 2)])
def test_nccl_refused_on_a_shared_device(device, cards):
    """nccl refuses two ranks on one GPU, and the CPU: the rule raises,
    and never runs gloo instead."""
    with pytest.raises(ValueError, match="nccl"):
        tlaunch.rank_device(device, "nccl", 1, 2, cards)
    assert str(tlaunch.rank_device("cuda", "nccl", 1, 2, 2)) == "cuda:1"
