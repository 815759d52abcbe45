"""The port's threefry PRNG against ``jax.random`` (threefry2x32,
partitionable, 64-bit types off), bit for bit: keys, ``fold_in`` with the
small per-worker / per-leaf data and the 32-bit round-key tags, ``split``,
the 32-bit ``bits`` and f32 ``uniform`` draws at every size class the
QSGD codec uses, and the shuffle behind ``permutation`` and
``choice(replace=False)`` that picks rand-k's positions.  Tolerance:
none."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import efbv as jefbv
from repro_torch import random as R
from repro_torch.core import efbv as tefbv
from repro_torch.kernels import LAUNCHES, reset_launches


def _jkey_data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, 2**32 + 7, -1,
                                  2**40 + 3])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(R.key(seed),
                                  _jkey_data(jax.random.key(seed)))


@pytest.mark.parametrize("data", [
    0, 1, 2, 13, 2**31, 2**32 - 1,
    jefbv.DOWNLINK_FOLD, jefbv.PARTICIPATION_FOLD, jefbv.RESAMPLE_FOLD,
    jefbv.PIPELINE_FOLD, jefbv.REFERENCE_FOLD])
def test_fold_in_matches_jax(data):
    for seed in (0, 7):
        want = jax.random.fold_in(jax.random.key(seed), data)
        np.testing.assert_array_equal(R.fold_in(R.key(seed), data),
                                      _jkey_data(want))


def test_fold_tags_copied_from_jax():
    for name in ("DOWNLINK_FOLD", "PARTICIPATION_FOLD", "RESAMPLE_FOLD",
                 "PIPELINE_FOLD", "REFERENCE_FOLD"):
        assert getattr(tefbv, name) == getattr(jefbv, name)
    k = jax.random.fold_in(jax.random.key(3), 2)
    tk = R.fold_in(R.key(3), 2)
    np.testing.assert_array_equal(tefbv.downlink_key(tk),
                                  _jkey_data(jefbv.downlink_key(k)))


@pytest.mark.parametrize("n", [1, 2, 5, 64])
def test_split_matches_jax(n):
    k = jax.random.fold_in(jax.random.key(0), 9)
    want = _jkey_data(jax.random.split(k, n))
    np.testing.assert_array_equal(R.split(R.fold_in(R.key(0), 9), n), want)


def _step_leaf_key(seed, step, worker, leaf):
    """The trainer's chain: fold_in(fold_in(fold_in(key(seed), step),
    worker), leaf), in both packages."""
    jk, tk = jax.random.key(seed), R.key(seed)
    for d in (step, worker, leaf):
        jk, tk = jax.random.fold_in(jk, d), R.fold_in(tk, d)
    return jk, tk


@pytest.mark.parametrize("n", [1, 7, 1024, 70_001, 2**20])
def test_uniform_matches_jax(n):
    jk, tk = _step_leaf_key(0, 2, 1, 13)
    want = np.asarray(jax.random.uniform(jk, (n,)))
    got = R.uniform(tk, n, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("n", [3, 4096, 70_001])
def test_bits_match_jax(n):
    jk, tk = _step_leaf_key(5, 0, 0, 0)
    want = np.asarray(jax.random.bits(jk, (n,)))
    got = R.bits(tk, n, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_downlink_draw_matches_jax():
    """The downlink's leaf-key chain: fold_in(fold_in(step_key,
    DOWNLINK_FOLD), j)."""
    jk = jax.random.fold_in(jax.random.key(0), 1)
    tk = R.fold_in(R.key(0), 1)
    jk = jax.random.fold_in(jefbv.downlink_key(jk), 4)
    tk = R.fold_in(tefbv.downlink_key(tk), 4)
    want = np.asarray(jax.random.uniform(jk, (4097,)))
    np.testing.assert_array_equal(R.uniform(tk, 4097, "cpu").numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_cpu_draws_launch_nothing():
    reset_launches()
    R.uniform(R.key(0), 100, device="cpu")
    R.bits(R.key(0), 100, device="cpu")
    assert LAUNCHES["threefry_uniform"] == 0
    assert R.uniform(R.key(0), 0, device="cpu").shape == (0,)



@pytest.mark.parametrize("n", [1, 2, 896, 3072, 65536, 2**20])
def test_permutation_matches_jax(n):
    jk, tk = _step_leaf_key(0, 1, 1, 3)
    want = np.asarray(jax.random.permutation(jk, n))
    got = R.permutation(tk, n, device="cpu")
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,m", [(1, 1), (896, 896), (3072, 1), (70_001, 5000),
                                 (2**20, 2**19)])
def test_choice_matches_jax(n, m):
    jk, tk = _step_leaf_key(2, 0, 1, 7)
    want = np.asarray(jax.random.choice(jk, n, shape=(m,), replace=False))
    got = R.choice(tk, n, m, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_shuffle_sort_keys_collide_at_2_20():
    """At 2**20 positions the 32-bit sort keys of a round collide (about
    128 pairs expected), so the bitwise match above holds only because the
    sort is stable and orders the keys as unsigned."""
    _, tk = _step_leaf_key(0, 1, 1, 3)
    n = 2**20
    _, sub = R.split(tk)
    keys = R.bits(sub, n, device="cpu").numpy().view(np.uint32)
    assert n - np.unique(keys).size > 0
    assert (keys >= 2**31).any() and (keys < 2**31).any()


def _jax_sort_rounds(n):
    jaxpr = jax.make_jaxpr(lambda k: jax.random.permutation(k, n))(
        jax.random.key(0))
    return str(jaxpr).count(" sort[")


@pytest.mark.parametrize("n,rounds", [(1, 0), (2, 1), (1625, 1), (1626, 2),
                                      (2_642_245, 2), (2_642_246, 3),
                                      (136_134_656, 3)])
def test_shuffle_rounds_switch_points(n, rounds):
    """0 -> 1 -> 2 -> 3 sort rounds, equal to the sorts in JAX's
    program."""
    assert R.shuffle_rounds(n) == rounds == _jax_sort_rounds(n)


def test_choice_refuses_a_sample_larger_than_n():
    with pytest.raises(ValueError, match="larger sample"):
        R.choice(R.key(0), 5, 6, device="cpu")
    assert R.choice(R.key(0), 5, 0, device="cpu").shape == (0,)


def test_cpu_permutation_launches_nothing():
    reset_launches()
    R.permutation(R.key(0), 3000, device="cpu")
    assert LAUNCHES["threefry_uniform"] == 0


# -- randint, ranged uniform and normal (the reference problems' draws) ------

@pytest.mark.parametrize("n,lo,hi", [(1000, 0, 7), (4096, 0, 100),
                                     (777, -5, 70000), (50, 3, 3),
                                     (300, 10, 2), (64, 0, 1),
                                     (513, -2**31, 2**31 - 1)])
@pytest.mark.parametrize("seed", [0, 5])
def test_randint_matches_jax(n, lo, hi, seed):
    """``jax.random.randint``'s two draws and uint32 modulus, bit for bit
    (span 1 when hi <= lo; the full int32 range; spans above 2**16)."""
    want = np.asarray(jax.random.randint(jax.random.key(seed), (n,), lo, hi))
    got = R.randint(R.key(seed), n, lo, hi, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_minibatch_draws_match_jax():
    """``LogReg.minibatch_grads``' row indices: randint under each worker's
    ``split(key, n)[i]``, as JAX's vmap over the split keys draws them."""
    k = jax.random.fold_in(jax.random.key(2), jefbv.RESAMPLE_FOLD)
    want = np.asarray(jax.vmap(
        lambda kk: jax.random.randint(kk, (5,), 0, 21))(jax.random.split(k, 6)))
    tk = R.fold_in(R.key(2), tefbv.RESAMPLE_FOLD)
    got = np.stack([R.randint(kk, 5, 0, 21, "cpu").numpy()
                    for kk in R.split(tk, 6)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(-1.5, 1.5), (0.0, 1.0), (-3.0, 0.25),
                                   (float(np.nextafter(np.float32(-1.0),
                                                       np.float32(0.0))),
                                    1.0)])
def test_ranged_uniform_matches_jax(lo, hi):
    """``uniform(minval=, maxval=)`` bit for bit: the fused
    floats * (hi - lo) + lo that XLA computes inside JAX's jitted uniform
    (two roundings differ on [-1.5, 1.5))."""
    n = 1 << 16
    want = np.asarray(jax.random.uniform(jax.random.key(4), (n,), minval=lo,
                                         maxval=hi))
    got = R.uniform(R.key(4), n, "cpu", minval=lo, maxval=hi).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 9])
def test_normal_within_tolerance_of_jax(seed):
    """``normal`` = sqrt(2) * erf_inv(u) of JAX's exact uniform, with XLA
    CPU's own f32 erf_inv (fault p, closed): bitwise with
    ``jax.random.normal`` on 2**20 values, no residue.  (``torch.erfinv``
    differed on 619,440 of them, by up to 5.8e-6 relative.)"""
    n = 1 << 20
    want = np.asarray(jax.random.normal(jax.random.key(seed), (n,)))
    got = R.normal(R.key(seed), n, "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_erf_inv_is_xlas_bitwise():
    """``random.erf_inv`` against jitted ``jax.lax.erf_inv`` on 2**20
    values spread over (-1, 1) (both branches of its log1p, w < 5 and
    w >= 5), and at 0, +-1, +-0.5 and the ends of normal's range."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    x = np.concatenate([
        np.random.default_rng(0).uniform(-1, 1, 1 << 20),
        [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, lo, -lo, 1e-30]]
    ).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = R.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fma_rounds_once():
    """``random.fma`` is round(a * b + c) with one rounding: against the
    exact value in Python's fractions on values where two roundings
    differ."""
    from fractions import Fraction

    rng = np.random.default_rng(1)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)
    got = R.fma(torch.from_numpy(a), torch.from_numpy(b),
                torch.from_numpy(c)).numpy()
    exact = [np.float32(float(Fraction(float(x)) * Fraction(float(y))
                              + Fraction(float(z))))
             for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(exact, np.float32))
    assert (got != (a * b + c)).any()


# -- many keys at once: the draws of vmap over a worker axis -----------------

def _worker_keys(n, seed=4):
    """(JAX's, the port's) split(fold_in(key(seed), 2), n): a round's
    worker keys."""
    jk = jax.random.split(jax.random.fold_in(jax.random.key(seed), 2), n)
    tk = R.split(R.fold_in(R.key(seed), 2), n)
    np.testing.assert_array_equal(tk, _jkey_data(jk))
    return jk, tk


@pytest.mark.parametrize("n", [1, 16, 1000])
def test_fold_in_and_split_over_key_arrays_match_jax(n):
    """``fold_in`` and ``split`` of an (n, 2) key array, one vectorised
    pass, equal ``vmap`` of JAX's (the leaf keys fold_in(keys[i], j) and a
    shuffle round's ``k, sub = split(k)`` of every worker)."""
    jk, tk = _worker_keys(n)
    for data in (0, 13, jefbv.DOWNLINK_FOLD):
        np.testing.assert_array_equal(
            R.fold_in(tk, data),
            _jkey_data(jax.vmap(partial(jax.random.fold_in, data=data))(jk)))
    for m in (2, 3):
        got = R.split(tk, m)
        assert got.shape == (n, m, 2)
        np.testing.assert_array_equal(
            got, _jkey_data(jax.vmap(partial(jax.random.split, num=m))(jk)))


@pytest.mark.parametrize("n,m", [(16, 1), (16, 7), (16, 56), (3, 4099),
                                 (1000, 112)])
def test_row_draws_match_jax_under_vmap(n, m):
    """``bits_rows``, ``uniform_rows`` and ``randint_rows``: row i is JAX's
    draw under keys[i], as ``vmap`` draws it, bit for bit."""
    jk, tk = _worker_keys(n)
    got = R.bits_rows(tk, m, device="cpu")
    assert got.shape == (n, m) and got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.asarray(jax.vmap(partial(jax.random.bits, shape=(m,)))(jk)))
    np.testing.assert_array_equal(
        R.uniform_rows(tk, m, device="cpu").numpy().view(np.uint32),
        np.asarray(jax.vmap(partial(jax.random.uniform, shape=(m,)))(
            jk)).view(np.uint32))
    np.testing.assert_array_equal(
        R.randint_rows(tk, m, 0, 37, device="cpu").numpy(),
        np.asarray(jax.vmap(partial(jax.random.randint, shape=(m,),
                                    minval=0, maxval=37))(jk)))


@pytest.mark.parametrize("n,m,k", [(16, 1, 1), (16, 56, 1), (16, 150, 150),
                                   (4, 1626, 9), (1000, 56, 1)])
def test_permutation_and_choice_rows_match_jax_under_vmap(n, m, k):
    """One row shuffle for all workers (one draw and one stable sort a
    round; 2 rounds above 1625) equals ``vmap`` of JAX's permutation and
    choice."""
    jk, tk = _worker_keys(n)
    got = R.permutation_rows(tk, m, device="cpu")
    assert got.shape == (n, m) and got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.vmap(
            partial(jax.random.permutation, x=m))(jk)))
    np.testing.assert_array_equal(
        R.choice_rows(tk, m, k, device="cpu").numpy(),
        np.asarray(jax.vmap(partial(jax.random.choice, a=m, shape=(k,),
                                    replace=False))(jk)))


@pytest.mark.parametrize("n,m,distinct", [(16, 56, 3), (8, 150, 2),
                                          (4, 4096, 64)])
def test_stable_order_keeps_ties_in_order_like_lax_sort(n, m, distinct):
    """The shuffle's sort with forced ties: equal uint32 keys (a few
    distinct values over both halves of the range, as int32 both signs)
    keep their column order, as JAX's ``lax.sort_key_val`` under vmap
    orders them (threefry draws tie too rarely to test this through the
    draws)."""
    rng = np.random.default_rng(distinct)
    u = (rng.integers(0, distinct, (n, m)) * (2**32 // distinct)).astype(
        np.uint32)
    order = R.stable_order(torch.from_numpy(u.view(np.int32)))
    cols = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32), (n, m))
    _, want = jax.vmap(jax.lax.sort_key_val)(jnp.asarray(u), cols)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want))


def test_row_draws_are_one_call_and_one_key_copy(monkeypatch):
    """Each batched draw makes one row-draw call and one copy of its keys,
    whatever n is (a 2-round permutation: two calls, still one copy); on
    the CPU nothing launches."""
    calls = {"rows": 0, "copies": 0}
    rows, copy = R._rows, R.key_tensor

    def counted_rows(*a):
        calls["rows"] += 1
        return rows(*a)

    def counted_copy(*a):
        calls["copies"] += 1
        return copy(*a)

    monkeypatch.setattr(R, "_rows", counted_rows)
    monkeypatch.setattr(R, "key_tensor", counted_copy)
    reset_launches()
    for n in (2, 300):
        tk = R.split(R.key(n), n)
        for fn, want in ((lambda: R.uniform_rows(tk, 9, "cpu"), (1, 1)),
                         (lambda: R.randint_rows(tk, 9, 0, 5, "cpu"), (1, 1)),
                         (lambda: R.permutation_rows(tk, 40, "cpu"), (1, 1)),
                         (lambda: R.choice_rows(tk, 1700, 3, "cpu"),
                          (2, 1))):
            calls.update(rows=0, copies=0)
            fn()
            assert (calls["rows"], calls["copies"]) == want
    assert not any(LAUNCHES.values())
