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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressors import BlockTopK as JBlockTopK
from repro.core.efbv import EFBV as JEFBV
from repro.distributed import aggregate as jagg
from repro_torch import tree as T
from repro_torch.core.compressors import BlockTopK
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


def _jax_round(mode, grads, hs, h_avg):
    algo = JEFBV(JBlockTopK(256, 16), lam=LAM, nu=NU)
    local = jax.jit(lambda g, h: jagg.compress_local(algo, None, g, h,
                                                     mode=mode))
    combine = jax.jit(lambda m, ha: jagg.combine_global(
        algo, m, ha, n_workers=N, mode=mode))
    msgs, h_new = zip(*[local(g, h) for g, h in zip(grads, hs)])
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *msgs)
    g, h_avg_new = combine(stacked, h_avg)
    return msgs, h_new, g, h_avg_new


def _torch_round(mode, grads, hs, h_avg):
    algo = EFBV(BlockTopK(256, 16), lam=LAM, nu=NU)
    to_t = lambda t: T.tree_map(torch.from_numpy, t)  # noqa: E731
    out = [tagg.compress_local(algo, None, to_t(g), to_t(h), mode=mode)
           for g, h in zip(grads, hs)]
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


def _assert_h_within_one_operand_ulp(h_old, want, got):
    """|want - got| <= one ulp of the largest of |h|, |lam d| and the
    result: the fused and the unfused spelling differ only in the rounding
    of lam * d and of the sum, at most half an ulp each (cancellation can
    make that many ulps of a small result)."""
    for h0, w, t in zip(jax.tree.leaves(h_old), jax.tree.leaves(want),
                        T.leaves(got)):
        w, t = np.asarray(w), t.numpy()
        big = np.maximum(np.maximum(np.abs(h0), np.abs(w - h0)), np.abs(w))
        assert np.all(np.abs(w - t) <= np.spacing(big))


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
