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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread, for the reason test_torch_model.py's
    copy gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
                                   (4, 1626, 9), (1000, 56, 1), (16, 2, 2),
                                   (16, 2, 1), (16, 3, 3), (16, 3, 2)])
def test_permutation_and_choice_rows_match_jax_under_vmap(n, m, k):
    """One row shuffle for all workers (the row-shuffle wrapper's plain
    version on the CPU: a draw and a stable sort a round, 2 rounds above
    1625, then the cut) equals ``vmap`` of JAX's permutation and choice;
    so does ``ref.shuffle_rows_ref`` on the subkeys, which the card's
    kernel is held to."""
    from repro_torch.kernels import ref

    jk, tk = _worker_keys(n)
    want_p = np.asarray(jax.vmap(partial(jax.random.permutation, x=m))(jk))
    want_c = np.asarray(jax.vmap(partial(jax.random.choice, a=m, shape=(k,),
                                         replace=False))(jk))
    got = R.permutation_rows(tk, m, device="cpu")
    assert got.shape == (n, m) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_p)
    choice = R.choice_rows(tk, m, k, device="cpu")
    assert choice.shape == (n, k) and choice.is_contiguous()
    np.testing.assert_array_equal(choice.numpy(), want_c)
    sub, rows = R._shuffle_keys(tk, m, "cpu")
    assert rows == n and sub.shape == (R.shuffle_rounds(m) * n, 2)
    np.testing.assert_array_equal(
        ref.shuffle_rows_ref(sub, n, m, k).numpy(), want_c)


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
    whatever n is; a row shuffle one call of the row-shuffle wrapper (every
    round: a 2-round permutation too) and one copy of all rounds' keys; on
    the CPU nothing launches."""
    calls = {"rows": 0, "shuffles": 0, "copies": 0}
    rows, shuffle, copy = R._rows, R._shuffle, R.key_tensor

    def counted(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(R, "_rows", counted("rows", rows))
    monkeypatch.setattr(R, "_shuffle", counted("shuffles", shuffle))
    monkeypatch.setattr(R, "key_tensor", counted("copies", copy))
    reset_launches()
    for n in (2, 300):
        tk = R.split(R.key(n), n)
        for fn, want in ((lambda: R.uniform_rows(tk, 9, "cpu"), (1, 0, 1)),
                         (lambda: R.randint_rows(tk, 9, 0, 5, "cpu"),
                          (1, 0, 1)),
                         (lambda: R.permutation_rows(tk, 40, "cpu"),
                          (0, 1, 1)),
                         (lambda: R.choice_rows(tk, 1700, 3, "cpu"),
                          (0, 1, 1))):
            calls.update(rows=0, shuffles=0, copies=0)
            fn()
            assert (calls["rows"], calls["shuffles"], calls["copies"]) \
                == want
    assert not any(LAUNCHES.values())


# -- XLA CPU's f32 exp, expm1 and log (mamba2's init) -------------------------

def _xla_inputs():
    """2**20 values over exp's whole range, 2**18 near zero (expm1's tanh
    branch and its 4e-4 cut), 2**18 of mamba2's dt draws exp(u) (u on
    [log 1e-3, log 1e-1)), and the edges: zeros, infinities, NaN, the
    clamps, the 0.5 switch and subnormal results."""
    rng = np.random.default_rng(0)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-30, -1e-30,
                      88.7, 88.8, -87.3, -87.9, -103.0, 40.0, -20.0, 20.0,
                      0.5, -0.5, np.nextafter(np.float32(0.5), 1),
                      8e-4, 7.9e-4, 2**-20], np.float32)
    return np.concatenate([
        rng.uniform(-100, 100, 2**20).astype(np.float32),
        rng.uniform(-1e-3, 1e-3, 2**18).astype(np.float32),
        np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                           2**18)).astype(np.float32), edges])


@pytest.mark.parametrize("name", ["exp", "expm1", "log"])
def test_xla_exp_expm1_and_log_bitwise(name):
    """``random.xla_exp`` (Cephes ``expf``, subnormal results flushed to
    zero), ``xla_expm1`` (``exp(x) - 1`` above |x| = 0.5, else
    ``tanh(x / 2) * (exp(x) + 1)`` with XLA's rational tanh) and
    ``xla_log`` equal ``jnp.exp``, ``jnp.expm1`` and ``jnp.log`` on the
    CPU bit for bit, each fused multiply-add emulated (``random.fma``);
    NaN where JAX gives NaN (log of a negative too)."""
    x = _xla_inputs()
    jfn, tfn = {"exp": (jnp.exp, R.xla_exp), "expm1": (jnp.expm1,
                                                        R.xla_expm1),
                "log": (jnp.log, R.xla_log)}[name]
    want = np.asarray(jfn(x))
    with R._serial(torch.device("cpu")):
        got = tfn(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


# -- the families' parameter specs and layout (a slow, JAX-heavy check) -------

from repro.configs import get_config as _jfull  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config as _tfull  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.layers import is_spec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-moe-3b-a800m",
                                  "dbrx-132b", "minicpm-2b"])
def test_family_param_specs_and_layout_equal_jax(arch, full):
    """``param_specs()`` equal JAX's PartitionSpecs leaf for leaf, and the
    abstract tree has JAX's leaf paths and shapes in JAX's flatten order
    (the wire's per-leaf layout), full and smoke."""
    jcfg = _jfull(arch) if full else jget_smoke_config(arch)
    tcfg = _tfull(arch) if full else get_smoke_config(arch)
    jspecs = jax.tree.leaves(
        JModel(jcfg).param_specs(),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert [tuple(s) for s in jspecs] == T.leaves(
        build_model(tcfg).param_specs(), is_leaf=is_spec)
    jabs = jax.tree_util.tree_flatten_with_path(JModel(jcfg).init_abstract())[0]
    tabs = T.flatten_with_path(build_model(tcfg).init_abstract())
    assert [("/".join(str(k.key) for k in p), tuple(a.shape))
            for p, a in jabs] == [("/".join(p), tuple(a.shape))
                                  for p, a in tabs]


# -- the model axis through the driver, against JAX's on fake host devices ---
#
# qwen2 smoke on --mesh 1x4 (half a KV head a rank: its attention on
# weights gathered on use) and mamba2 smoke on --mesh 1x2 (the SSD block
# gathered on use, the embedding and tied head vocab-parallel), on M gloo
# ranks, against JAX's driver on M fake host devices: the fingerprint and
# the bits exact, every step's loss within test_torch_model.py's LOSS_ATOL.

from test_torch_model import (LOSS_ATOL, _driver_lines,  # noqa: E402
                              _jax_driver, _mesh_driver_rank, _spawn_ranks)

#: case -> (driver flags, model axis M, the port's bits lines)
MESH_DRIVER_CASES = {
    "qwen2_1x4": (["--arch", "qwen2-0.5b", "--smoke", "--mesh", "1x4",
                   "--downlink", "qsgd:16"], 4,
                  [5_776_384, 11_553_216, 17_329_600]),
    "mamba2_1x2": (["--arch", "mamba2-130m", "--smoke", "--mesh", "1x2"], 2,
                   [1_371_136]),
}


@pytest.mark.parametrize("case", sorted(MESH_DRIVER_CASES))
def test_driver_model_axis_matches_jax(case, tmp_path):
    """JAX's driver prints losses 6.9480 / 6.9908 (qwen2) and 6.9689 /
    6.9497 (mamba2) with these flags."""
    flags, m, bits = MESH_DRIVER_CASES[case]
    argv = flags + ["--steps", "2", "--global-batch", "4", "--seq", "32",
                    "--compressor", "block_topk:256,16", "--agg",
                    "sparse_allgather", "--log-every", "1"]
    ranks = _spawn_ranks(tmp_path, m, _mesh_driver_rank,
                         argv + ["--device", "cpu"])
    assert ranks[1:] == [""] * (m - 1)
    assert f" mesh={flags[4]} ranks={m} backend=gloo " in ranks[0]
    assert f"[train] model axis: {m} ranks a worker" in ranks[0]
    pf, pb, pl = _driver_lines(ranks[0])
    jf, jb, jl = _driver_lines(_jax_driver(argv, m))
    assert pf == jf and len(pf) == 1
    # the JAX driver prints the total rounded (:g), the port exactly
    assert pb == bits
    assert jb == bits[:2] + [int(float(f"{b:g}")) for b in bits[2:]]
    assert len(pl) == len(jl) == 2
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_ATOL)
