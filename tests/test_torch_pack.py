"""The port's fused block-top-k pack and rand-k update against the JAX
Pallas kernels.

The same numpy inputs go through ``repro.distributed.wire.fused_pack`` with
the Pallas kernel in interpret mode and through the port's ``fused_pack``,
both through the CUDA-kernel wrapper (``auto``, which runs its plain
version on CPU tensors) and through the oracle.  Likewise the rand-k
update: ``repro.kernels.ops.randk_update(..., interpret=True)`` against the
port's ``ops.randk_update``, whose CPU side is ``ref.randk_update_ref``.
The port has one pack kernel, whose payload leaves by bulk stores as the
streaming Pallas body's does: it is also held against
``pack_update_pallas(stream=True)`` in interpret mode.  Tolerance: none --
vals, idx and h_out are compared bit for bit.

The last section holds the dense block-top-k and the fused dense worker
update (``ops.block_topk`` / ``ops.efbv_update``) against JAX's wrappers in
interpret mode; its own notes head it.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _prop import given, settings, st

from repro.distributed import wire as jwire
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.distributed import wire as twire
from repro_torch.kernels import LAUNCHES, ops, pack, ref, reset_launches

LAM = 0.37

# tests/test_kernels.py's sweep: padding, multi-dim, block 1024, kb == block
SWEEP = [
    ((4096,), 512, 16),
    ((1000,), 256, 8),
    ((64, 300), 128, 4),
    ((8192,), 1024, 64),
    ((128,), 128, 128),
    ((5, 7, 11), 128, 2),
]


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


def _jax_pack(g, h, shape, block, kb, stream=False):
    lw = jwire.LeafWire(shape=shape, size=int(np.prod(shape)), block=block,
                        kb=kb)
    (v, i), hn = jwire.fused_pack(lw, jnp.asarray(g), jnp.asarray(h), LAM,
                                  kernel="interpret", stream=stream)
    return np.asarray(v), np.asarray(i), np.asarray(hn)


def _torch_pack(g, h, shape, block, kb, kernel):
    lw = twire.LeafWire(shape=shape, size=int(np.prod(shape)), block=block,
                        kb=kb)
    (v, i), hn = twire.fused_pack(lw, torch.from_numpy(g), torch.from_numpy(h),
                                  LAM, kernel=kernel)
    return v.numpy(), i.numpy(), hn.numpy()


def _assert_same(want, got):
    for w, t in zip(want, got):
        assert w.shape == t.shape and w.dtype == t.dtype
        np.testing.assert_array_equal(_bits(w), _bits(t))


@pytest.mark.parametrize("kernel", ["auto", "oracle"])
@pytest.mark.parametrize("shape,block,kb", SWEEP)
def test_fused_pack_bitwise_vs_pallas_interpret(shape, block, kb, kernel):
    rng = np.random.default_rng(sum(shape) + block + kb)
    g = rng.standard_normal(shape).astype(np.float32)
    h = rng.standard_normal(shape).astype(np.float32)
    _assert_same(_jax_pack(g, h, shape, block, kb),
                 _torch_pack(g, h, shape, block, kb, kernel))


@pytest.mark.parametrize("kernel", ["auto", "oracle"])
def test_fused_pack_ties_bitwise(kernel):
    """Tie-heavy rows (integers in [-3, 3]) and all-zero delta rows: the
    payload order is jax.lax.top_k's, ties to the lowest column."""
    rng = np.random.default_rng(7)
    shape, block, kb = (16 * 256,), 256, 16
    g = rng.integers(-3, 4, shape).astype(np.float32)
    h = rng.integers(-3, 4, shape).astype(np.float32)
    g[:512] = h[:512]
    _assert_same(_jax_pack(g, h, shape, block, kb),
                 _torch_pack(g, h, shape, block, kb, kernel))


def test_kernel_path_turns_selected_negative_zero_positive():
    """The Pallas kernel extracts a value as a masked row sum, so a selected
    delta of -0.0 travels as +0.0; the kernel path (and its plain version)
    keeps that, while the oracle gathers -0.0 as JAX's oracle does."""
    shape, block, kb = (256,), 256, 16
    g = np.zeros(shape, np.float32)
    g[3] = -0.0
    g[10:20] = 1.0
    h = np.zeros(shape, np.float32)
    want = _jax_pack(g, h, shape, block, kb)
    _assert_same(want, _torch_pack(g, h, shape, block, kb, "auto"))
    assert _bits(want[0])[0, 13] == 0  # +0.0 for the selected -0.0 at col 3
    oracle = _torch_pack(g, h, shape, block, kb, "oracle")
    assert _bits(oracle[0])[0, 13] == 0x80000000


def test_nan_rows_bitwise_vs_pallas_interpret():
    """A row whose delta holds a NaN (a diverged gradient) makes the Pallas
    kernel's row max NaN in every round, so it selects nothing and sends
    (0.0, 0) in every slot; h_out is h + lam * 0.  Rows: all NaN, one NaN,
    a NaN in h, and a clean row after them."""
    rng = np.random.default_rng(11)
    shape, block, kb = (4 * 256,), 256, 16
    g = rng.standard_normal(shape).astype(np.float32)
    h = rng.standard_normal(shape).astype(np.float32)
    g[:256] = np.nan
    g[256 + 77] = np.nan
    h[512 + 200] = np.nan
    want = _jax_pack(g, h, shape, block, kb)
    _assert_same(want, _torch_pack(g, h, shape, block, kb, "auto"))
    assert not want[0][:3].any() and not want[1][:3].any()
    assert np.all(want[0][3] != 0)


def test_wrapper_counts_only_kernel_launches():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    reset_launches()
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((4, 256)).astype(np.float32))
    vals, idx, h_out = pack.pack_update(x, torch.zeros_like(x), LAM, 16)
    assert LAUNCHES["pack_update"] == 0
    want = ref.pack_update_ref(x, torch.zeros_like(x), LAM, 16)
    for a, b in zip((vals, idx, h_out), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["shape", "dtype", "kb"])
def test_wrapper_checks_inputs(bad):
    g = torch.zeros(4, 256)
    h = torch.zeros(4, 256)
    kb = 16
    if bad == "shape":
        h = torch.zeros(4, 128)
    elif bad == "dtype":
        g = g.double()
    else:
        kb = 257
    with pytest.raises((ValueError, TypeError)):
        pack.pack_update(g, h, LAM, kb)


def test_ops_pads_only_to_whole_rows():
    g = torch.from_numpy(
        np.random.default_rng(2).standard_normal(1000).astype(np.float32))
    (vals, idx), h_new = ops.efbv_pack_update(g, torch.zeros(1000), LAM,
                                              block=256, kb=8)
    assert vals.shape == (4, 8) and idx.shape == (4, 8)
    assert h_new.shape == (1000,)


def test_cuda_mode_needs_a_cuda_tensor():
    """``cuda`` never runs the plain version; ``auto`` routes a block that
    is not a multiple of 128 to the plain layout spec (the oracle) by its
    shape, as JAX's ``fused_pack`` does, on any device."""
    lw = twire.LeafWire(shape=(300,), size=300, block=100, kb=4)
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal(300).astype(np.float32))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        twire.fused_pack(lw, x, torch.zeros(300), LAM, kernel="cuda")
    (v, i), h_new = twire.fused_pack(lw, x, torch.zeros(300), LAM,
                                     kernel="auto")
    (wv, wi), wh = twire.fused_pack(lw, x, torch.zeros(300), LAM,
                                    kernel="oracle")
    for a, b in zip((v, i, h_new), (wv, wi, wh)):
        assert torch.equal(a, b)


# -- the route by shape of ``auto`` (JAX's wire.py fused_pack) --------------

@pytest.mark.parametrize("block", [100, 200, 128, 384, 4224])
def test_auto_routes_by_block_shape(block, monkeypatch):
    """``auto`` takes the kernel wrapper exactly when block % 128 == 0 (4224
    too: the kernels take blocks above 4096, as JAX's do); any
    other block takes the oracle before any launch (the wrapper is never
    called) and matches JAX's ``fused_pack`` in its default mode on this
    host (the jnp oracle) bit for bit, -0.0 and NaN rows included."""
    n = 3 * block + 7
    rng = np.random.default_rng(block)
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.standard_normal(n).astype(np.float32)
    g[5], h[5] = -0.0, 0.0
    g[block + 3] = np.nan
    calls = []
    real = pack.pack_update

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(pack, "pack_update", counted)
    reset_launches()
    got = _torch_pack(g, h, (n,), block, 4, "auto")
    assert bool(calls) == (block % 128 == 0)
    assert sum(LAUNCHES.values()) == 0
    if block % 128:
        lw = jwire.LeafWire(shape=(n,), size=n, block=block, kb=4)
        (v, i), hn = jwire.fused_pack(lw, jnp.asarray(g), jnp.asarray(h),
                                      LAM, kernel="oracle")
        _assert_same((np.asarray(v), np.asarray(i), np.asarray(hn)), got)
    else:
        _assert_same(_jax_pack(g, h, (n,), block, 4), got)


@pytest.mark.parametrize("block", [100, 4224])
def test_cuda_mode_refuses_blocks_no_kernel_takes(block):
    """An explicit ``cuda`` never takes the oracle: on a CPU tensor it
    raises for the device.  The kernels take every block % 128 == 0, as
    the TPU kernels do (4224 runs on the card, ``chip_smoke.py``), and no
    other; the dense wrappers check that rule on every device."""
    lw = twire.LeafWire(shape=(block,), size=block, block=block, kb=4)
    x = torch.zeros(block)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        twire.fused_pack(lw, x, x, LAM, kernel="cuda")
    if block % 128:
        with pytest.raises(ValueError, match="block % 128 == 0"):
            ops.block_topk(x, block=block, kb=4)
    else:
        assert torch.equal(ops.block_topk(x, block=block, kb=4), x)


# -- JAX's streaming pack (stream=True) ------------------------------------

#: SWEEP plus kb 3 on 8m + 1 rows: the last CTA of the CUDA kernel holds one
#: row, a 12-byte payload slab
STREAM_SWEEP = SWEEP + [((17 * 128,), 128, 3)]


@pytest.mark.parametrize("shape,block,kb", STREAM_SWEEP)
def test_stream_pack_bitwise_vs_pallas_interpret(shape, block, kb):
    """The port's pack against both Pallas bodies of pack_update_pallas."""
    rng = np.random.default_rng(sum(shape) + block + kb)
    g = rng.standard_normal(shape).astype(np.float32)
    h = rng.standard_normal(shape).astype(np.float32)
    want = _jax_pack(g, h, shape, block, kb, stream=True)
    _assert_same(want, _torch_pack(g, h, shape, block, kb, "auto"))
    _assert_same(want, _jax_pack(g, h, shape, block, kb))


@pytest.mark.parametrize("case", ["ties", "negzero", "nan_rows"])
def test_stream_pack_edge_values_bitwise(case):
    """The ties, -0.0 and NaN-row cases above, against the streaming Pallas
    body."""
    rng = np.random.default_rng(7)
    if case == "ties":
        shape, block, kb = (16 * 256,), 256, 16
        g = rng.integers(-3, 4, shape).astype(np.float32)
        h = rng.integers(-3, 4, shape).astype(np.float32)
        g[:512] = h[:512]
    elif case == "negzero":
        shape, block, kb = (256,), 256, 16
        g = np.zeros(shape, np.float32)
        g[3] = -0.0
        g[10:20] = 1.0
        h = np.zeros(shape, np.float32)
    else:
        shape, block, kb = (4 * 256,), 256, 16
        g = rng.standard_normal(shape).astype(np.float32)
        h = rng.standard_normal(shape).astype(np.float32)
        g[:256] = np.nan
        g[256 + 77] = np.nan
        h[512 + 200] = np.nan
    want = _jax_pack(g, h, shape, block, kb, stream=True)
    _assert_same(want, _torch_pack(g, h, shape, block, kb, "auto"))
    if case == "negzero":
        assert _bits(want[0])[0, 13] == 0
    if case == "nan_rows":
        assert not want[0][:3].any() and not want[1][:3].any()


def test_stream_wrapper_counts_only_kernel_launches():
    """On the kernel's partial-CTA shape (8m + 1 rows, kb 3) a CPU tensor
    takes the plain version: (nb, kb) payload rows, no padding, no
    launch."""
    reset_launches()
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((9, 128)).astype(np.float32))
    got = pack.pack_update(x, torch.zeros_like(x), LAM, 3)
    assert sum(LAUNCHES.values()) == 0
    assert got[0].shape == got[1].shape == (9, 3)
    want = ref.pack_update_ref(x, torch.zeros_like(x), LAM, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("where", ["meta", "mixed"])
def test_wrapper_refuses_other_devices(where):
    """Only CPU (the plain version) and CUDA (the kernel) tensors run."""
    g = torch.zeros(4, 256, device="meta")
    h = torch.zeros(4, 256, device="meta" if where == "meta" else "cpu")
    with pytest.raises(ValueError, match="cpu or cuda|on meta"):
        pack.pack_update(g, h, LAM, 16)


# -- rand-k update ----------------------------------------------------------

def _randk_inputs(n, k, case, seed=0):
    """g, h (n,) f32 and k unique int32 positions; ``case`` plants -0.0,
    NaN or inf at selected and unselected positions."""
    rng = np.random.default_rng(seed + n + k)
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.standard_normal(n).astype(np.float32)
    idx = rng.permutation(n)[:k].astype(np.int32)
    sel = np.zeros(n, bool)
    sel[idx] = True
    if case == "negzero":     # -0.0 in h and g, selected and not
        h[::3] = -0.0
        g[::6] = -0.0
        g[1::5], h[1::5] = 0.0, 0.0
    elif case in ("nan", "inf"):
        bad = np.float32(np.nan if case == "nan" else np.inf)
        g[np.flatnonzero(sel)[::2]] = bad
        g[np.flatnonzero(~sel)[::2]] = bad
        h[np.flatnonzero(~sel)[1::7]] = -bad
    return g, h, idx


def _randk_both(g, h, idx, lam, torch_views=None):
    scale = float(np.float32(g.size / idx.size))
    jg, jh, ji = jnp.asarray(g), jnp.asarray(h), jnp.asarray(idx)
    want_h = jops.randk_update(jg, jh, ji, lam, scale, interpret=True)
    # JAX gathers the values outside its kernel (wire.RandKSparse)
    want_v = (jg.reshape(-1)[ji] - jh.reshape(-1)[ji]) * scale
    tg, th = torch_views or (torch.from_numpy(g), torch.from_numpy(h))
    got_v, got_h = ops.randk_update(tg, th, torch.from_numpy(idx), lam, scale)
    return (np.asarray(want_v), np.asarray(want_h)), \
        (got_v.numpy(), got_h.numpy())


@pytest.mark.parametrize("n,k", [(3001, 1), (3001, 1500), (3001, 3001),
                                 (70_001, 5000), ((8, 300), 96)],
                         ids=["k1", "k_half", "k_all", "ragged70001", "2d"])
def test_randk_update_bitwise_vs_pallas_interpret(n, k):
    shape = n if isinstance(n, tuple) else (n,)
    g, h, idx = _randk_inputs(int(np.prod(shape)), k, "rand")
    want, got = _randk_both(g.reshape(shape), h.reshape(shape), idx, LAM)
    _assert_same(want, got)


@pytest.mark.parametrize("case", ["negzero", "nan", "inf"])
@pytest.mark.parametrize("lam", [LAM, 0.0, 1.0])
def test_randk_update_edge_values_bitwise(case, lam):
    """-0.0 in h at unselected positions becomes +0.0 (h + lam * 0.0); a
    NaN or inf in g shows only where it is selected."""
    g, h, idx = _randk_inputs(4099, 700, case)
    want, got = _randk_both(g, h, idx, lam)
    _assert_same(want, got)
    if case == "negzero":
        unselected = np.setdiff1d(np.arange(g.size), idx)
        assert np.all(_bits(got[1])[unselected[h[unselected] == 0]] == 0)


def test_randk_update_unaligned_views_bitwise():
    """Views one value off their buffer's start (the kernel's one value at
    a time path on the card)."""
    n, k = 4099, 300
    g, h, idx = _randk_inputs(n, k, "rand", seed=3)
    buf = np.concatenate([[1.0], g, [2.0], h]).astype(np.float32)
    tb = torch.from_numpy(buf)
    views = (tb[1:n + 1], tb[n + 2:])
    want, got = _randk_both(g, h, idx, LAM, torch_views=views)
    _assert_same(want, got)


def test_randk_update_out_of_range_raises():
    g = torch.zeros(100)
    for bad in (100, -1):
        with pytest.raises(IndexError):
            pack.randk_update(g, torch.zeros(100),
                              torch.tensor([3, bad], dtype=torch.int32), 2.0,
                              LAM)


def test_randk_wrapper_counts_only_kernel_launches():
    reset_launches()
    g, h, idx = _randk_inputs(1000, 10, "rand")
    vals, h_out = pack.randk_update(torch.from_numpy(g), torch.from_numpy(h),
                                    torch.from_numpy(idx), 100.0, LAM)
    assert LAUNCHES["randk_update"] == 0
    want = ref.randk_update_ref(torch.from_numpy(g), torch.from_numpy(h),
                                torch.from_numpy(idx), 100.0, LAM)
    assert torch.equal(vals, want[0]) and torch.equal(h_out, want[1])


@pytest.mark.parametrize("bad", ["shape", "dtype", "idx_dtype", "idx_2d"])
def test_randk_wrapper_checks_inputs(bad):
    g, h = torch.zeros(64), torch.zeros(64)
    idx = torch.arange(4, dtype=torch.int32)
    if bad == "shape":
        h = torch.zeros(63)
    elif bad == "dtype":
        g = g.double()
    elif bad == "idx_dtype":
        idx = idx.long()
    else:
        idx = idx.reshape(2, 2)
    with pytest.raises((ValueError, TypeError)):
        pack.randk_update(g, h, idx, 16.0, LAM)


# -- the one-pass rand-k design (csrc/randk_update.cu) ----------------------
#
# A numpy model of the kernel's steps, held bit for bit against the Pallas
# kernel in interpret mode and against the plain version, at the chip
# cases' shapes scaled down to tiles of 1024 values (the kernel's smallest;
# it runs 8192: ``small_randk_tiles``), on each of its plans: the
# positions bucketed by tile (counts in shared memory, or per-tile
# cursors), and one launch whose CTAs read all of idx.

RANDK_MODEL_LOG2 = 10


def small_randk_tiles(monkeypatch, scan_limit, smem_bins=1 << 20):
    """The plan at the model's tiles of 1024 values, with the given limits
    of the one-launch path and of the shared-memory counts."""
    monkeypatch.setattr(pack, "RANDK_TILE_LOG2", RANDK_MODEL_LOG2)
    monkeypatch.setattr(pack, "RANDK_SCAN_LIMIT", scan_limit)
    monkeypatch.setattr(pack, "RANDK_SMEM_BINS", smem_bins)


def model_randk(g, h, idx, scale, lam, seed=0):
    """(vals, h_out) of the rand-k kernel's steps: the plan
    (``pack.randk_plan``); when bucketed, the counting sort of the (p, j)
    pairs by tile -- a histogram whose CTAs (contiguous chunks of idx)
    give each position its rank among its CTA's positions of its tile and
    each CTA its offset in each tile's bucket (both in the order of the
    atomics, here a random one), the exclusive scan of the counts, and the
    scatter to start + offset + rank (with no histogram CTAs, one cursor
    per tile, bumped in a random order); then per tile: h into a buffer,
    each pair patched there (v = (g[p] - h[p]) * scale into vals[j], the
    buffer value h[p] + lam * v, a bit set), and h_out = the buffer where
    the bit is set, h + lam * 0.0 elsewhere."""
    size, k = g.size, idx.size
    tiles, bucketed, words, ctas = pack.randk_plan(size, k)
    tile_log2 = pack.RANDK_TILE_LOG2
    if k and (idx.min() < 0 or idx.max() >= size):
        raise IndexError("rand-k position out of range")
    rng = np.random.default_rng(seed)
    tile = 1 << tile_log2
    of_tile = idx.astype(np.int64) >> tile_log2
    if bucketed:
        counts = np.bincount(of_tile, minlength=tiles)
        starts = np.cumsum(counts) - counts                 # the scan
        if ctas:
            assert words == -(-(2 * k + tiles) // 4) * 4 + k + ctas * tiles
            chunk = -(-(-(-k // ctas)) // 16) * 16
            cta = np.arange(k) // chunk
            rank = np.empty(k, np.int64)
            off = np.zeros((ctas, tiles), np.int64)
            for t in range(tiles):
                mine = np.flatnonzero(of_tile == t)
                local = np.bincount(cta[mine], minlength=ctas)
                order = rng.permutation(ctas)               # flush atomics
                off[order, t] = np.cumsum(local[order]) - local[order]
                for c in range(ctas):
                    ours = mine[cta[mine] == c]
                    rank[ours] = rng.permutation(ours.size)
            slots = starts[of_tile] + off[cta, of_tile] + rank
        else:
            assert words == 2 * k + 2 * tiles
            cursor = starts.copy()
            slots = np.empty(k, np.int64)
            for j in rng.permutation(k):
                slots[j] = cursor[of_tile[j]]
                cursor[of_tile[j]] += 1
        assert np.array_equal(np.sort(slots), np.arange(k))
        pairs = np.empty((k, 2), np.int64)
        pairs[slots] = np.stack([idx, np.arange(k)], axis=1)
        ends = np.append(starts[1:], k)
        buckets = [pairs[starts[t]:ends[t]] for t in range(tiles)]
        assert all(np.all(b[:, 0] >> tile_log2 == t)
                   for t, b in enumerate(buckets))
    else:
        assert words == 0
        buckets = [np.stack([idx[of_tile == t], np.flatnonzero(of_tile == t)],
                            axis=1) for t in range(tiles)]
    f32 = np.float32
    vals = np.empty(k, f32)
    h_out = np.empty_like(h)
    zero = f32(lam) * f32(0.0)
    with np.errstate(invalid="ignore", over="ignore"):
        for t in range(tiles):
            buf = h[t * tile:(t + 1) * tile].copy()
            bits = np.zeros(buf.size, bool)
            for p, j in buckets[t]:
                local = p - t * tile
                hp = buf[local]
                v = (g[p] - hp) * f32(scale)
                vals[j] = v
                buf[local] = hp + f32(lam) * v
                bits[local] = True
            h_out[t * tile:(t + 1) * tile] = np.where(bits, buf, buf + zero)
    return vals, h_out


def randk_model_case(case):
    """(g, h, idx) of one of the chip's tile cases, at tiles of 1024."""
    tile = 1 << RANDK_MODEL_LOG2
    rng = np.random.default_rng(len(case))
    if case == "one_tile_holds_all":
        n = 8 * tile + 77
        idx = 3 * tile + rng.permutation(tile)
    elif case == "tile_edges":
        n = 12 * tile + 77
        edges = np.arange(1, 13) * tile
        edges = np.concatenate([edges - 1, edges, edges + 1, [0, n - 2]])
        edges = edges[edges < n]
        rest = np.setdiff1d(np.arange(n), edges)
        idx = np.concatenate([edges, rng.choice(rest, 600, replace=False),
                              rest[-5:]])
        idx = rng.permutation(np.unique(idx))
    elif case == "last_partial_tile":
        n = 5 * tile + 77
        idx = rng.permutation(np.arange(5 * tile, n))
    elif case.startswith("size"):                 # size<n>_k<k>
        n, k = (int(x) for x in case[4:].split("_k"))
        idx = rng.permutation(n)[:k]
    elif case == "k_eq_size":
        n = 3 * tile + 5
        idx = rng.permutation(n)
    else:                                         # k1: the last value
        n = 20_000
        idx = np.array([n - 1])
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.standard_normal(n).astype(np.float32)
    return g, h, idx.astype(np.int32)


RANDK_MODEL_CASES = ["one_tile_holds_all", "tile_edges", "last_partial_tile",
                     "size1024_k512", "size1024_k1024", "size1025_k1025",
                     "k_eq_size", "k1"]


@pytest.mark.parametrize("case", RANDK_MODEL_CASES)
def test_model_randk_bitwise_vs_pallas_interpret(case, monkeypatch):
    """The model's three plans (bucketed with the counts in shared memory,
    bucketed with per-tile cursors, one launch) against the Pallas kernel
    in interpret mode (h') and JAX's gather (vals), and against the port's
    plain version."""
    g, h, idx = randk_model_case(case)
    want, got = _randk_both(g, h, idx, LAM)
    _assert_same(want, got)
    scale = float(np.float32(g.size / idx.size))
    plans = set()
    for scan_limit, smem_bins in ((0, 1 << 20), (0, 0), (1 << 40, 0)):
        small_randk_tiles(monkeypatch, scan_limit, smem_bins)
        _assert_same(want, model_randk(g, h, idx, scale, LAM,
                                       seed=len(plans)))
        plans.add(pack.randk_plan(g.size, idx.size)[1:4:2])
    assert len(plans) == 3


@pytest.mark.parametrize("case", ["negzero", "nan", "inf"])
def test_model_randk_edge_values_bitwise(case, monkeypatch):
    """-0.0, NaN and inf at selected and unselected positions through the
    model's bitmap (an unselected value takes h + lam * 0.0), bucketed
    (counts in shared memory), across 5 tiles, at lam 0.37 and 0.0."""
    g, h, idx = _randk_inputs(5 * 1024 + 3, 900, case)
    scale = float(np.float32(g.size / idx.size))
    small_randk_tiles(monkeypatch, 0)
    for lam in (LAM, 0.0):
        want = ref.randk_update_ref(torch.from_numpy(g), torch.from_numpy(h),
                                    torch.from_numpy(idx), scale, lam)
        model = model_randk(g, h, idx, scale, lam)
        _assert_same([w.numpy() for w in want], model)


def test_randk_plan_at_full_width():
    """The plan of the rand-k path's 14 full-width qwen2-0.5b leaves at k =
    1048576 (clamped to the leaf): the 6 small leaves in one launch, the 8
    others bucketed; the embed leaf at k = 1 in one launch."""
    sizes = {136_134_656: 1, 896: 1, 3072: 2, 21_504: 3,
             2_752_512: 2, 19_267_584: 2, 104_595_456: 3}
    plans = []
    for size, n in sizes.items():
        k = min(1_048_576, size)
        tiles, bucketed, words, ctas = pack.randk_plan(size, k)
        assert tiles == -(-size // 8192)
        assert (words > 3 * k) == bucketed and (ctas > 0) == bucketed
        assert ctas == (min(132, k // (4 * tiles)) if bucketed else 0)
        plans += [bucketed] * n
    assert plans.count(True) == 8 and plans.count(False) == 6
    assert not pack.randk_plan(136_134_656, 1)[1]


# ---------------------------------------------------------------------------
# The dense block-top-k and fused dense worker update (block_topk.cu)
#
# The port's dense block-top-k and fused dense worker update
# (``repro_torch.kernels.ops.block_topk`` / ``efbv_update``, the CPU side of
# ``csrc/block_topk.cu``) against JAX's wrappers with the Pallas kernels in
# interpret mode.
#
# Inputs come from numpy seeds.  Tolerance: none, every bit of d, h' and out
# compared, signs of zeros included -- except the bits of a bf16 NaN: XLA
# keeps the sign of the x86 default NaN (0xFFC0 for inf * 0) where torch's
# bf16 rounding writes 0x7FC0, so bf16 NaNs are compared as NaNs (on the card
# the kernel and its plain version agree on those bits too; f32 NaNs are
# compared bit for bit here).
#
# What the reference does, measured here (jax 0.9.0, XLA on the CPU):
#
# * fault g: a selected magnitude may be +inf; a row holding a NaN keeps
#   nothing;
# * fault i: where the masked product is f32 at kb = 1 (block_topk of f32,
#   and efbv_update's f32 delta), XLA folds the mask into a select that
#   writes +0.0 for every unselected value; at kb >= 2, and for bf16
#   block_topk at every kb, it multiplies by 0 (-0.0 and NaN kept, inf * 0
#   = NaN);
# * h' = h + lam * d is one fused multiply-add, except for f32 at kb = 1,
#   where it is two roundings (``test_h_update_rounding_site``);
# * fault h: the wrapper rounds h to g's type before the kernel.
# ---------------------------------------------------------------------------


DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def assert_bits(want, got):
    want, got = np.asarray(want), to_numpy(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    uint = np.uint16 if want.dtype.itemsize == 2 else np.uint32
    wb, gb = want.view(uint), got.view(uint)
    if want.dtype == ml_dtypes.bfloat16:
        wn = np.isnan(want.astype(np.float32))
        np.testing.assert_array_equal(wn, np.isnan(got.astype(np.float32)))
        wb, gb = wb[~wn], gb[~wn]
    np.testing.assert_array_equal(wb, gb)


def check_topk(x, block, kb):
    want = jops.block_topk(jnp.asarray(x), block=block, kb=kb,
                           interpret=True)
    got = ops.block_topk(to_torch(x), block=block, kb=kb)
    assert_bits(want, got)
    return got


def check_update(g, h, block, kb, lam=LAM):
    dw, hw = jops.efbv_update(jnp.asarray(g), jnp.asarray(h), lam,
                              block=block, kb=kb, interpret=True)
    dg, hg = ops.efbv_update(to_torch(g), to_torch(h), lam, block=block,
                              kb=kb)
    assert_bits(dw, dg)
    assert_bits(hw, hg)
    return dg, hg


def normal(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,block,kb", SWEEP)
def test_block_topk_sweep(shape, block, kb, dtype):
    check_topk(normal(block + kb, shape, DTYPES[dtype]), block, kb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,block,kb", SWEEP)
def test_efbv_update_sweep(shape, block, kb, dtype):
    check_update(normal(kb, shape, DTYPES[dtype]),
                 normal(kb + 1, shape, DTYPES[dtype]), block, kb)


@given(d=st.integers(1, 3000), kb=st.integers(1, 8),
       seed=st.integers(0, 2**31 - 1))
@settings(max_examples=12, deadline=None)
def test_random_sizes(d, kb, seed):
    x = normal(seed, (d,))
    check_topk(x, 128, kb)
    check_update(x, normal(seed + 1, (d,)), 128, kb)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ties(dtype):
    """Integers in [-3, 3]: many equal magnitudes, ties to the lowest
    column; every 7th row of g - h all zero, and -0.0 among the zeros."""
    rng = np.random.default_rng(3)
    g = rng.integers(-3, 4, (64, 256)).astype(np.float32)
    h = rng.integers(-3, 4, (64, 256)).astype(np.float32)
    g[::7] = h[::7]
    g[(g == 0) & (rng.random(g.shape) < 0.5)] = -0.0
    g, h = g.astype(DTYPES[dtype]), h.astype(DTYPES[dtype])
    for kb in (1, 2, 16):
        check_topk(g, 256, kb)
        check_update(g, h, 256, kb)


def special_rows(dtype):
    """(4, 128): fault g's row [1, 5, -7, 2, inf, 3, -4, 6, 0...] with
    small negatives after it and a -inf; a row with one NaN; a row of NaN;
    a row of normals."""
    x = np.zeros((4, 128), np.float32)
    x[0, :8] = [1, 5, -7, 2, np.inf, 3, -4, 6]
    x[0, 8:20] = -np.arange(1, 13) * 0.01
    x[0, 30] = -np.inf
    x[1] = normal(1, 128)
    x[1, 5] = np.nan
    x[2] = np.nan
    x[3] = normal(2, 128)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kb", [1, 2, 3])
def test_inf_and_nan_rows(kb, dtype):
    """Fault g: +-inf selected (|.| = +inf); a NaN row keeps nothing."""
    x = special_rows(DTYPES[dtype])
    out = to_numpy(check_topk(x, 128, kb)).astype(np.float32)
    assert out[0, 4] == np.inf
    if kb >= 2:
        assert out[0, 30] == -np.inf
    assert not np.any(out[1:3][~np.isnan(out[1:3])])
    h = normal(4, (4, 128), DTYPES[dtype])
    check_update(x, h, 128, kb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kb", [1, 3])
def test_more_infs_than_kb(kb, dtype):
    """Ten infs of both signs in a row and kb < 10: the lowest columns
    win; an unselected inf is inf * 0 = NaN, or +0.0 where fault i
    selects."""
    x = normal(5, (2, 256))
    x[0, 10:30:2] = np.inf
    x[0, 11:31:2] = -np.inf
    x = x.astype(DTYPES[dtype])
    out = to_numpy(check_topk(x, 256, kb)).astype(np.float32)
    kept = np.flatnonzero(np.isinf(out[0]))
    assert list(kept) == list(range(10, 10 + kb))
    assert np.isnan(out[0, 10 + kb]) == (kb > 1 or dtype == "bf16")
    check_update(x, np.zeros_like(x), 256, kb)


def test_kb1_and_kb2_same_input():
    """Fault i on one input: f32 kb = 1 writes no -0.0, kb = 2 keeps the
    sign of every unselected negative; so does efbv_update's d."""
    x = normal(6, (8 * 128,))
    neg = lambda a: int(np.sum(np.signbit(a) & (a == 0)))
    one = to_numpy(check_topk(x, 128, 1))
    two = to_numpy(check_topk(x, 128, 2))
    assert neg(one) == 0
    assert neg(two) == int(np.sum(x < 0)) - int(np.sum(two < 0))
    d1, _ = check_update(x, np.zeros_like(x), 128, 1)
    d2, _ = check_update(x, np.zeros_like(x), 128, 2)
    assert neg(d1.numpy()) == 0 and neg(d2.numpy()) > 0


@pytest.mark.parametrize("block", [128, 256])
def test_kb_equals_block(block):
    x = normal(7, (3 * block + 5,))
    np.testing.assert_array_equal(to_numpy(check_topk(x, block, block)), x)
    check_update(x, normal(8, x.shape), block, block)


@pytest.mark.parametrize("g_dtype,h_dtype", [("bf16", "f32"),
                                             ("f32", "bf16")])
def test_mixed_dtypes(g_dtype, h_dtype):
    """Fault h: h is rounded to g's type before the kernel, and h' is
    converted back to h's type after it."""
    g = normal(9, (4096,), DTYPES[g_dtype])
    h = normal(10, (4096,), DTYPES[h_dtype])
    for kb in (1, 16):
        d, h_new = check_update(g, h, 256, kb)
        assert d.dtype == to_torch(g).dtype
        assert h_new.dtype == to_torch(h).dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_h_update_rounding_site(dtype):
    """Where XLA contracts h + lam * d: the reference's h' is the fused
    multiply-add at kb = 16 (and differs from two roundings on some of
    these values), and two roundings for f32 at kb = 1."""
    g = normal(11, (1 << 16,), DTYPES[dtype])
    h = normal(12, (1 << 16,), DTYPES[dtype])
    for kb in (1, 16):
        d, h_new = check_update(g, h, 256, kb)
        hf, df = to_torch(h).float(), d.float()
        fused = torch.add(hf, df, alpha=LAM).to(h_new.dtype)
        two = (hf + LAM * df).to(h_new.dtype)
        if kb == 1 and dtype == "f32":
            assert torch.equal(h_new, two)
        else:
            assert torch.equal(h_new, fused)
            if dtype == "f32":
                assert not torch.equal(h_new, two)


def test_wrapper_checks():
    x = torch.zeros(4, 256)
    with pytest.raises(ValueError, match="block % 128"):
        pack.block_topk(torch.zeros(4, 100), 4)
    for kb in (0, 257):
        with pytest.raises(ValueError, match="kb"):
            pack.block_topk(x, kb)
    with pytest.raises(TypeError, match="f32 or bf16"):
        pack.block_topk(x.half(), 4)
    with pytest.raises(TypeError, match="one type"):
        pack.efbv_update(x, x.bfloat16(), LAM, 4)
    with pytest.raises(ValueError, match="equal"):
        pack.efbv_update(x, torch.zeros(4, 128), LAM, 4)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        pack.block_topk(torch.zeros(4, 256, device="meta"), 4)


def test_plain_version_is_the_cpu_path():
    """On a CPU tensor the wrapper is its plain version and counts no
    launch."""
    from repro_torch.kernels import LAUNCHES

    x = torch.from_numpy(normal(13, (16, 256)))
    before = dict(LAUNCHES)
    assert torch.equal(pack.block_topk(x, 16), ref.block_topk_ref(x, 16))
    d, h = pack.efbv_update(x, x.flip(0), LAM, 16)
    dr, hr = ref.efbv_update_ref(x, x.flip(0), LAM, 16)
    assert torch.equal(d, dr) and torch.equal(h, hr)
    assert LAUNCHES == before


# the full-width qwen2-0.5b leaves hold 494,032,768 f32 values
@pytest.mark.parametrize("kernel,elem,payload,want,by", [
    ("block_topk", 4, 0, 1.1798, "bytes"),
    ("efbv_update", 4, 0, 2.3596, "bytes"),
    ("pack_update", 4, 8 * (494_032_768 // 256) * 16, 1.8434, "bytes"),
    ("block_topk", 2, 0, 0.5899, "bytes"),
])
def test_dense_bound_ms_at_full_width(kernel, elem, payload, want, by):
    """The least times the kernel table states for one pass over the 14
    full-width leaves: the bytes each input is read and each output
    written at 3.35 TB/s, or the elementwise instructions and one compare
    per value in each of the threshold search's 31 steps at most at the
    issue rate, whichever is longer: the bytes, in f32 and in bf16."""
    ms, got_by = ops.dense_bound_ms(kernel, 494_032_768, elem,
                                    payload=payload)
    assert (round(ms, 4), got_by) == (want, by)


# ---------------------------------------------------------------------------
# The threshold-search selection of ``csrc/block_select.cuh``
#
# The CUDA kernels (pack_update.cu, block_topk.cu) select by a threshold
# search, not by the Pallas kernels' kb rounds of max extraction.  The
# numpy model below follows the kernels step for step (keys, bisection over
# the key's 31 bits with the early exit, the tie split by a prefix count in
# column order, the payload's rank order) and is held bit for bit against
# the Pallas kernels in interpret mode: the pack's payload and h', the
# selected set (the pack's columns), and the dense kernels' out, d and h'.
# ---------------------------------------------------------------------------

def model_search(keys, kb):
    """The threshold search on (rows, block) uint32 keys: (t, gt, exact,
    steps, nan) per row.  T, the kb-th largest key, by bisection from bit
    30 down, each step counting the keys >= t | 1 << b, stopping as soon
    as exactly kb are >= the candidate (exact); gt = count(keys > t) where
    the search runs to bit 0.  A row holding a NaN, and kb == block, take
    no step."""
    rows, block = keys.shape
    nan = (keys > 0x7F800000).any(axis=1)
    t = np.zeros(rows, np.uint32)
    gt = np.zeros(rows, np.int64)
    steps = np.zeros(rows, np.int64)
    exact = np.zeros(rows, bool)
    done = nan | (kb >= block)
    for b in range(30, -1, -1):
        live = ~done
        if not live.any():
            break
        cand = t | np.uint32(1 << b)
        c = (keys >= cand[:, None]).sum(axis=1)
        steps += live
        up = live & (c >= kb)
        t[up] = cand[up]
        hit = up & (c == kb)
        exact |= hit
        done |= hit
        down = live & (c < kb)
        gt[down] = c[down]
    return t, gt, exact, steps, nan


def model_select(mag, kb):
    """(rows, block) f32 magnitudes -> (keep (rows, block) bool, steps
    (rows,) int): the kernels' selection.  Key: the f32 bits of |x| without
    the sign; T by ``model_search``; then every key > T and the kb -
    count(> T) lowest columns among the keys == T.  A row holding a NaN
    keeps nothing; kb == block keeps everything without a step."""
    keys = np.ascontiguousarray(mag, np.float32).view(np.uint32) & 0x7FFFFFFF
    block = keys.shape[1]
    t, gt, exact, steps, nan = model_search(keys, kb)
    eq = keys == t[:, None]
    before = np.cumsum(eq, axis=1) - eq          # equal keys in lower columns
    tie = eq & (before < (kb - gt)[:, None])
    keep = np.where(exact[:, None], keys >= t[:, None],
                    (keys > t[:, None]) | tie)
    keep[kb >= block] = True
    keep[nan] = False
    return keep, steps


def model_cut(mag, kb):
    """The selection of rows above 4096 (``block_select::select_cut``): the
    same search, the set as three scalars per row, (T as f32, exact, cut):
    keep |x| > T, and |x| == T at a column <= cut, every such column when
    exact.  cut is the column of the (kb - gt)-th key equal to T in column
    order.  A NaN row has T = NaN (nothing compares to it); kb >= block
    has T = 0, exact.  Returns (keep, (T, exact, cut))."""
    mag = np.ascontiguousarray(mag, np.float32)
    keys = mag.view(np.uint32) & 0x7FFFFFFF
    block = keys.shape[1]
    t, gt, exact, _, nan = model_search(keys, kb)
    cum = np.cumsum(keys == t[:, None], axis=1)
    cut = np.where(exact, -1, np.argmax(cum >= (kb - gt)[:, None], axis=1))
    tf = t.view(np.float32).copy()
    if kb >= block:
        tf[:], exact[:] = 0.0, True
    tf[nan], exact[nan] = np.nan, False
    cols = np.arange(block)
    with np.errstate(invalid="ignore"):
        keep = (mag > tf[:, None]) | ((mag == tf[:, None])
                                      & (exact[:, None]
                                         | (cols <= cut[:, None])))
    return keep, (tf, exact, cut)


def model_pack(g2d, h2d, kb, lam=LAM):
    """The pack kernel: (vals, idx, h_out) of (rows, block) f32 g and h.
    The winners in jax.lax.top_k's order (key descending, then column
    ascending), a selected -0.0 sent as +0.0 (v + 0.0), (0.0, 0) in every
    slot of a NaN row; h_out = h + lam * d as a multiply then an add, and
    at kb = 1 as one FMA (ROADMAP fault l; torch's ``add(alpha=)``, one
    rounding on the CPU)."""
    with np.errstate(invalid="ignore"):
        delta = g2d - h2d
    keep, steps = model_select(np.abs(delta), kb)
    keys = delta.view(np.uint32) & 0x7FFFFFFF
    cols = np.broadcast_to(np.arange(delta.shape[1]), delta.shape)
    primary = np.where(keep, -keys.astype(np.int64), 1)
    order = np.lexsort((cols, primary), axis=1)[:, :kb]
    vals = np.take_along_axis(delta, order, 1) + np.float32(0.0)
    idx = order.astype(np.int32)
    none = ~keep.any(axis=1)
    vals[none], idx[none] = 0.0, 0
    d = np.where(keep, delta, np.float32(0.0))
    if kb == 1:
        h_out = torch.add(torch.from_numpy(h2d), torch.from_numpy(d),
                          alpha=lam).numpy()
    else:
        with np.errstate(invalid="ignore"):
            h_out = h2d + np.float32(lam) * d
    return (vals, idx, h_out), keep, steps


def model_dense(x, kb):
    """The dense block_topk kernel: x * keep (fault i: f32 at kb = 1
    selects)."""
    keep, steps = model_select(np.abs(x.astype(np.float32)), kb)
    if kb == 1 and x.dtype == np.float32:
        return np.where(keep, x, np.float32(0.0)), steps
    with np.errstate(invalid="ignore"):  # an unselected inf: inf * 0
        return x * keep.astype(x.dtype), steps


def model_update(g, h, kb, lam=LAM):
    """The dense efbv_update kernel: d = T(delta * keep), h' = T(h + lam
    d) as one FMA (two roundings for f32 at kb = 1, fault k); the FMA is
    torch's ``add(alpha=)``, one rounding on the CPU."""
    with np.errstate(invalid="ignore"):
        delta = g.astype(np.float32) - h.astype(np.float32)
    keep, steps = model_select(np.abs(delta), kb)
    if kb == 1:
        d = np.where(keep, delta, np.float32(0.0)).astype(g.dtype)
    else:
        with np.errstate(invalid="ignore"):
            d = (delta * keep.astype(np.float32)).astype(g.dtype)
    hf = torch.from_numpy(h.astype(np.float32))
    df = torch.from_numpy(d.astype(np.float32))
    if kb == 1 and h.dtype == np.float32:
        h_out = (hf + lam * df).numpy()
    else:
        h_out = torch.add(hf, df, alpha=lam).numpy().astype(h.dtype)
    return (d, h_out), steps


def model_rows(kind, rows, block, kb, seed):
    """g, h (rows, block) f32 of one kind of row: gaussian, tie-heavy
    integers, all-equal, NaN rows, +-inf, -0.0."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((rows, block)).astype(np.float32)
    h = rng.standard_normal((rows, block)).astype(np.float32)
    if kind == "ties":
        g = rng.integers(-3, 4, (rows, block)).astype(np.float32)
        h = rng.integers(-3, 4, (rows, block)).astype(np.float32)
        g[::3] = h[::3]                               # all-zero delta rows
    elif kind == "equal":
        g[:] = 1.5
        h[:] = 0.25
        g[1::2] = -1.25                               # |delta| all 1.5
    elif kind == "nan":
        g[0] = np.nan
        g[2, block // 3] = np.nan
        h[4, 7] = np.nan
    elif kind == "inf":
        g[0, 10:30:2] = np.inf
        g[0, 11:31:2] = -np.inf
        g[1, :] = np.inf                              # every column +inf
        g[2, 3] = -np.inf
        h[3, 5] = np.inf
    elif kind == "negzero":
        g[:] = np.where(rng.random((rows, block)) < 0.5, -0.0, 0.0)
        h[:] = 0.0
        g[:, 1::17] = 0.5
    return g, h


#: (block, kb, rows): SWEEP's shapes as rows, and the blocks the CUDA
#: kernels take above what they took before (384, 1152, 4096: kb <= 16 at
#: 4096, 8-16 rows, to keep the Pallas interpret time small)
MODEL_SHAPES = [
    (512, 16, 8), (256, 8, 8), (128, 4, 16), (1024, 64, 8), (128, 128, 8),
    (128, 2, 16), (384, 16, 16), (384, 3, 8), (1152, 16, 8), (1152, 64, 8),
    (4096, 16, 8), (4096, 1, 8),
]
MODEL_KINDS = ["normal", "ties", "equal", "nan", "inf", "negzero"]


@pytest.mark.parametrize("kind", MODEL_KINDS)
@pytest.mark.parametrize("block,kb,rows", MODEL_SHAPES)
def test_model_pack_bitwise_vs_pallas_interpret(block, kb, rows, kind):
    """The model's payload, selected set and h' against the Pallas pack
    kernel in interpret mode; the port's pack (its plain version here) on
    the same rows."""
    g, h = model_rows(kind, rows, block, kb, block + kb + rows)
    (vals, idx, h_out), keep, steps = model_pack(g, h, kb)
    shape = (rows * block,)
    want = _jax_pack(g.reshape(-1), h.reshape(-1), shape, block, kb)
    _assert_same(want, (vals, idx, h_out.reshape(-1)))
    clean = ~np.isnan(g - h).any(axis=1)
    picked = np.zeros_like(keep)
    np.put_along_axis(picked, want[1].astype(np.int64), True, 1)
    np.testing.assert_array_equal(keep[clean], picked[clean])
    _assert_same(want, _torch_pack(g.reshape(-1), h.reshape(-1), shape,
                                   block, kb, "auto"))
    assert np.all(steps <= 31)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", MODEL_KINDS)
@pytest.mark.parametrize("block,kb,rows", MODEL_SHAPES)
def test_model_dense_bitwise_vs_pallas_interpret(block, kb, rows, kind,
                                                 dtype):
    """The model's dense block_topk and efbv_update (out, d, h') against
    the Pallas kernels in interpret mode, f32 and bf16; the port's
    wrappers (their plain versions here) on the same rows."""
    g, h = model_rows(kind, rows, block, kb, block + kb + rows + 1)
    g, h = g.astype(DTYPES[dtype]), h.astype(DTYPES[dtype])
    out, _ = model_dense(g, kb)
    (d, h_out), _ = model_update(g, h, kb)
    # the wrappers take the rows flat: given exactly one (8, block) tile,
    # XLA rounds the f32 kb = 1 h' differently (ROADMAP fault m, pinned by
    # test_reference_contracts_one_unreshaped_tile)
    g, h = g.reshape(-1), h.reshape(-1)
    want = jops.block_topk(jnp.asarray(g), block=block, kb=kb,
                           interpret=True)
    assert_bits(want, to_torch(out.reshape(-1)))
    check_topk(g, block, kb)
    dw, hw = jops.efbv_update(jnp.asarray(g), jnp.asarray(h), LAM,
                              block=block, kb=kb, interpret=True)
    assert_bits(dw, to_torch(d.reshape(-1)))
    assert_bits(hw, to_torch(h_out.reshape(-1)))
    check_update(g, h, block, kb)


# -- blocks above 4096: the row read again from memory at each step --------

#: (block, kb) of the big-row path, and of a block in registers beside them
BIG_CUT_SHAPES = [(b, kb) for b in (384, 4224, 8192)
                  for kb in (1, 3, 64, b // 2, b)]


@pytest.mark.parametrize("kind", MODEL_KINDS)
@pytest.mark.parametrize("block,kb", BIG_CUT_SHAPES)
def test_model_cut_keeps_the_selected_set(block, kb, kind):
    """The big-row cut (T, exact, cut) keeps exactly the set of the
    register path's selection, ties by column, NaN rows, +-inf and -0.0
    included, at 8 rows."""
    g, h = model_rows(kind, 8, block, kb, block + kb)
    with np.errstate(invalid="ignore"):
        mag = np.abs(g - h)
    keep, (tf, exact, cut) = model_cut(mag, kb)
    want, _ = model_select(mag, kb)
    np.testing.assert_array_equal(keep, want)
    clean = ~np.isnan(mag).any(axis=1)
    assert np.all(keep[clean].sum(axis=1) == min(kb, block))
    assert not keep[~clean].any()


def model_pack_big(g2d, h2d, kb, lam=LAM, seed=0):
    """The big-row pack: the cut's winners compacted in any order (the
    shared atomics'; here a random one) into kb (value, column) slots, each
    ranked by the winners ahead of it (a larger |v|, or an equal |v| at a
    lower column) and written at its rank (v + 0.0); (0.0, 0) in the slots
    past the winners; h_out as ``model_pack``."""
    with np.errstate(invalid="ignore"):
        delta = g2d - h2d
    keep, _ = model_cut(np.abs(delta), kb)
    rng = np.random.default_rng(seed)
    rows = delta.shape[0]
    vals = np.zeros((rows, kb), np.float32)
    idx = np.zeros((rows, kb), np.int32)
    for r in range(rows):
        cols = rng.permutation(np.flatnonzero(keep[r]))
        mags = np.abs(delta[r, cols])
        rank = np.empty(cols.size, np.int64)
        rank[np.lexsort((cols, -mags.astype(np.float64)))] = \
            np.arange(cols.size)
        vals[r, rank] = delta[r, cols] + np.float32(0.0)
        idx[r, rank] = cols
    d = np.where(keep, delta, np.float32(0.0))
    if kb == 1:
        h_out = torch.add(torch.from_numpy(h2d), torch.from_numpy(d),
                          alpha=lam).numpy()
    else:
        with np.errstate(invalid="ignore"):
            h_out = h2d + np.float32(lam) * d
    return vals, idx, h_out


#: (block, kb, kind) held against the Pallas kernels in interpret mode (8
#: rows; kb <= 64, as interpret mode runs kb rounds)
BIG_PALLAS_CASES = [(4224, 1, "inf"), (4224, 3, "ties"), (4224, 64, "nan"),
                    (8192, 1, "negzero"), (8192, 3, "equal"),
                    (8192, 64, "normal")]


@pytest.mark.parametrize("block,kb,kind", BIG_PALLAS_CASES)
def test_model_big_pack_bitwise_vs_pallas_interpret(block, kb, kind):
    """The big-row pack model's payload and h' against the Pallas pack
    kernel in interpret mode, and against ``model_pack``; the port's pack
    (its plain version here) on the same rows."""
    g, h = model_rows(kind, 8, block, kb, block + kb + 3)
    got = model_pack_big(g, h, kb)
    _assert_same(model_pack(g, h, kb)[0], got)
    shape = (8 * block,)
    want = _jax_pack(g.reshape(-1), h.reshape(-1), shape, block, kb)
    _assert_same(want, (got[0], got[1], got[2].reshape(-1)))
    _assert_same(want, _torch_pack(g.reshape(-1), h.reshape(-1), shape,
                                   block, kb, "auto"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block,kb,kind", [(4224, 1, "nan"),
                                           (4224, 64, "inf"),
                                           (8192, 3, "ties"),
                                           (8192, 64, "negzero")])
def test_model_big_dense_bitwise_vs_pallas_interpret(block, kb, kind, dtype):
    """The dense kernels' arithmetic on the big-row cut (out, d, h')
    against the Pallas kernels in interpret mode, f32 and bf16."""
    g, h = model_rows(kind, 8, block, kb, block + kb + 5)
    g, h = g.astype(DTYPES[dtype]), h.astype(DTYPES[dtype])
    keep, _ = model_cut(np.abs(g.astype(np.float32)), kb)
    assert np.array_equal(keep, model_select(np.abs(g.astype(np.float32)),
                                             kb)[0])
    out, _ = model_dense(g, kb)
    (d, h_out), _ = model_update(g, h, kb)
    g, h = g.reshape(-1), h.reshape(-1)
    assert_bits(jops.block_topk(jnp.asarray(g), block=block, kb=kb,
                                interpret=True), to_torch(out.reshape(-1)))
    dw, hw = jops.efbv_update(jnp.asarray(g), jnp.asarray(h), LAM,
                              block=block, kb=kb, interpret=True)
    assert_bits(dw, to_torch(d.reshape(-1)))
    assert_bits(hw, to_torch(h_out.reshape(-1)))
    check_topk(g, block, kb)
    check_update(g, h, block, kb)


@pytest.mark.parametrize("kind", ["normal", "ties", "equal", "negzero"])
@pytest.mark.parametrize("block,half", [(4224, True), (4224, False),
                                        (8192, True), (8192, False)])
def test_model_big_pack_vs_jnp_oracle(block, half, kind):
    """kb = block / 2 and kb = block, where interpret mode's kb rounds are
    too slow: the big-row pack model's payload against the JAX package's
    jnp oracle (``wire.pack_oracle``: ``jax.lax.top_k``, ties to the lowest
    column; the kernel sends a selected -0.0 as +0.0, so the oracle's
    values are compared + 0.0), and the port's pack on the same rows."""
    kb = block // 2 if half else block
    g, h = model_rows(kind, 8, block, kb, block + kb + 7)
    vals, idx, h_out = model_pack_big(g, h, kb)
    lw = jwire.LeafWire(shape=(8 * block,), size=8 * block, block=block,
                        kb=kb)
    ov, oi = jwire.pack_oracle(lw, jnp.asarray((g - h).reshape(-1)))
    _assert_same((np.asarray(ov) + np.float32(0.0), np.asarray(oi)),
                 (vals, idx))
    tv, ti, th = pack.pack_update(torch.from_numpy(g), torch.from_numpy(h),
                                  LAM, kb)
    _assert_same((vals, idx, h_out), (tv.numpy(), ti.numpy(), th.numpy()))


@pytest.mark.parametrize("kind,kb", [("ties", 2112), ("normal", 4224)])
def test_model_big_dense_vs_jnp_oracle(kind, kb):
    """The dense block-top-k at kb = block / 2 and block (4224) against the
    JAX package's jnp oracle (``ref.block_topk_ref``; no +-inf: fault g),
    f32: out bitwise, and efbv_update's d (its h' is the wrapper's FMA,
    fault k)."""
    block = 4224
    g, h = model_rows(kind, 8, block, kb, kb)
    out, _ = model_dense(g, kb)
    assert_bits(jref.block_topk_ref(jnp.asarray(g.reshape(-1)), block, kb),
                to_torch(out.reshape(-1)))
    (d, _), _ = model_update(g, h, kb)
    dw, _ = jref.efbv_update_ref(jnp.asarray(g), jnp.asarray(h), LAM, block,
                                 kb)
    assert_bits(dw, to_torch(d))


@pytest.mark.parametrize("block", [128, 1024])
def test_reference_contracts_one_unreshaped_tile(block):
    """ROADMAP fault m (repaired): given exactly one (8, block) tile of
    f32 at kb = 1, ``ops.efbv_update`` in interpret mode rounds h' = h +
    lam d once (an FMA), while the same values given flat, or any other
    shape, round twice (fault k).  The port's wrapper decides from the
    unreshaped shape as JAX's does: bitwise with both."""
    rng = np.random.default_rng(block)
    g = rng.standard_normal((8, block)).astype(np.float32)
    h = rng.standard_normal((8, block)).astype(np.float32)
    tile = [np.asarray(a) for a in jops.efbv_update(
        jnp.asarray(g), jnp.asarray(h), LAM, block=block, kb=1,
        interpret=True)]
    flat = [np.asarray(a).reshape(8, block) for a in jops.efbv_update(
        jnp.asarray(g.reshape(-1)), jnp.asarray(h.reshape(-1)), LAM,
        block=block, kb=1, interpret=True)]
    port = [t.numpy() for t in ops.efbv_update(
        torch.from_numpy(g), torch.from_numpy(h), LAM, block=block, kb=1)]
    port_flat = [t.numpy().reshape(8, block) for t in ops.efbv_update(
        torch.from_numpy(g.reshape(-1)), torch.from_numpy(h.reshape(-1)),
        LAM, block=block, kb=1)]
    _assert_same(flat, port_flat)
    np.testing.assert_array_equal(_bits(tile[0]), _bits(port[0]))
    fma = torch.add(torch.from_numpy(h), torch.tensor(tile[0]),
                    alpha=LAM).numpy()
    np.testing.assert_array_equal(_bits(tile[1]), _bits(fma))
    assert np.any(_bits(tile[1]) != _bits(flat[1]))
    np.testing.assert_array_equal(_bits(tile[1]), _bits(port[1]))


def test_model_search_steps():
    """On gaussian rows the search stops early with exactly kb keys at or
    above the candidate; tie-heavy rows run to bit 0 and split the ties by
    column; kb == block and NaN rows take no step."""
    g, h = model_rows("normal", 64, 256, 16, 1)
    keep, steps = model_select(np.abs(g - h), 16)
    assert np.all(keep.sum(axis=1) == 16)
    assert np.all(steps < 31) and 8 <= steps.mean() <= 20
    g, h = model_rows("ties", 16, 256, 16, 2)
    keep, steps = model_select(np.abs(g - h), 16)
    assert np.all(keep.sum(axis=1) == 16) and np.any(steps == 31)
    _, steps = model_select(np.abs(g - h), 256)
    assert not steps.any()
    g[0, 0] = np.nan
    keep, steps = model_select(np.abs(g - h), 16)
    assert steps[0] == 0 and not keep[0].any()


# ---------------------------------------------------------------------------
# The reference round's kernels' launch plans and rewrites (worker_sum.cu,
# threefry.cu): what the CPU can hold of them.  The kernels themselves run
# only on the card (chip_smoke.py holds them bitwise against their plain
# versions there).


#: the reference backend's worker sums: the committed spec's (16, 64), the
#: paper's (200 and 1000 workers over 2 k' in {64, 68, 112}), two windowed
#: levels (2000, 112)
REFERENCE_SUMS = [(16, 64)] + [(n, c) for n in (200, 1000)
                                for c in (64, 68, 112)] + [(2000, 112)]


@pytest.mark.parametrize("n,cols", REFERENCE_SUMS)
def test_worker_sum_plan_at_the_reference_shapes(n, cols):
    """Beyond 32 workers the reference's windowed reduce takes the narrow
    layout (the windows of a tile of 4 columns in parallel, several CTAs:
    28 at (1000, 112)); 16 workers sum in order, a thread per column; the
    fleets' orders are never windowed."""
    plan = ops.worker_sum_plan(n, cols, "reduce")
    if n > 32:
        assert plan.layout == "narrow" and plan.tile == ops.SUM_TILE
        assert plan.grid == -(-cols // ops.SUM_TILE) >= 16
        assert plan.threads == plan.tile * min(plan.levels[1], 64)
    else:
        assert plan.layout == "column" and plan.levels == (n,)
    for order in ("unrolled", "pair"):
        other = ops.worker_sum_plan(n, cols, order)
        assert other.layout == "column" and other.levels == (n,)
        assert other.smem == 0


@pytest.mark.parametrize("n", [16, 1000])
def test_worker_sum_plan_wide(n):
    """Over 2**20 columns a thread takes 4 (16-byte loads), in order at 16
    workers, the windows streamed at 1000; one column a thread when the
    columns are not a multiple of 4 or a pointer is not 16-byte aligned."""
    plan = ops.worker_sum_plan(n, 2**20)
    assert plan.layout == "wide" and plan.tile == 4 and plan.smem == 0
    assert plan.grid == 2**20 // 4 // ops.SUM_THREADS
    assert plan.levels == ((16,) if n == 16 else (1000, 32))
    assert ops.worker_sum_plan(n, 2**20 + 1).layout == "column"
    assert ops.worker_sum_plan(n, 2**20, aligned=False).layout == "column"
    assert ops.worker_sum_plan(n, ops.SUM_WIDE_COLS - 4).layout == (
        "column" if n == 16 else "narrow")


def test_worker_sum_plan_levels_are_xlas_windows():
    """At every n up to 5000 and at 32**3 + 1 and the switch +-1, each
    level of the plan has as many items as ``ref.reduce_windows`` cuts the
    level below into, the last at most 32; the narrow layout's shared
    memory holds a tile of each level above the rows."""
    for n in list(range(1, 5001)) + [32**3 + 1, ops.SUM_NARROW_ROWS,
                                     ops.SUM_NARROW_ROWS + 1]:
        plan = ops.worker_sum_plan.__wrapped__(n, 113, "reduce")
        assert plan.levels[0] == n and plan.levels[-1] <= 32
        for below, above in zip(plan.levels, plan.levels[1:]):
            assert below > 32
            assert above == len(ref.reduce_windows(below))
        if plan.layout == "narrow":
            assert plan.smem == 4 * ops.SUM_TILE * sum(plan.levels[1:])


def test_worker_sum_plan_switch_fits_shared_memory():
    """Every windowed n up to the switch (SUM_NARROW_ROWS, 95,232 rows)
    takes the narrow layout within 48 KB of shared memory (a CTA's without
    asking; the card's most is 227 KB); the next n streams its windows."""
    assert ops.SUM_NARROW_ROWS == 95_232
    for n in range(33, ops.SUM_NARROW_ROWS + 1):
        levels = ops._sum_levels(n, "reduce")
        assert 4 * ops.SUM_TILE * sum(levels[1:]) <= ops.SUM_SMEM <= 232_448
    assert ops.worker_sum_plan(ops.SUM_NARROW_ROWS, 1).layout == "narrow"
    assert ops.worker_sum_plan(ops.SUM_NARROW_ROWS + 1, 1).layout == "column"


def model_worker_sum_narrow(d, weights, plan):
    """The narrow layout's arithmetic as ``worker_sum.cu`` indexes it, in
    torch over all columns at once: each (window, column) of the rows from
    +0.0 with its weights, the partials of each level windowed again in
    the same order, the last level in order from +0.0."""
    def window(items, w, lo, win):
        s = win * 32 - lo
        acc = torch.zeros_like(items[0])
        for i in range(max(0, s), min(items.shape[0], s + 32)):
            acc = acc + items[i] if w is None else torch.add(
                acc, items[i], alpha=float(w[i] if isinstance(
                    w, torch.Tensor) else w))
        return acc

    items, w = d, weights
    for count in plan.levels[1:]:
        m = items.shape[0]
        lo = ((32 - m % 32) % 32) // 2
        assert count == (m + lo + 31) // 32
        items = torch.stack([window(items, w, lo, win)
                             for win in range(count)])
        w = None
    return window(items, None, 0, 0)


@pytest.mark.parametrize("n", [33, 200, 1000, 1025, 2000])
@pytest.mark.parametrize("kind", [None, "rows", "scale"])
def test_model_worker_sum_narrow_bitwise(n, kind):
    """The narrow layout's order of adds (``model_worker_sum_narrow``)
    equals the plain version's, bitwise, with -0.0 and inf in the data and
    a NaN under a zero mask."""
    rng = np.random.default_rng(n)
    d = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32))
    d[0, :3] = torch.tensor([-0.0, float("inf"), -1.5])
    w = {None: None, "scale": 10 / 3,
         "rows": torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
         }[kind]
    if kind == "rows":
        w[n - 1] = 0.0
        d[n - 1, 1] = float("nan")
    plan = ops.worker_sum_plan(n, 7)
    assert plan.layout == "narrow"
    model = model_worker_sum_narrow(d, w, plan)
    want = ref.worker_sum_ref(d, w)
    np.testing.assert_array_equal(_bits(model.numpy()), _bits(want.numpy()))



@pytest.mark.parametrize("index", [0, 1])
def test_launch_switches_device_only_off_the_current_one(index, monkeypatch):
    """``build.launch``, through which every wrapper launches: the entry
    point gets the raw current stream of the tensor's card, and runs under
    ``torch.cuda.device`` only when that card is not the host thread's
    current one (card 0 here), since a launch goes to the current one."""
    from repro_torch.kernels import build

    entered, current = [], [0]

    class Switch:
        def __init__(self, i):
            self.i = i

        def __enter__(self):
            entered.append(self.i)
            current[0], self.prev = self.i, current[0]

        def __exit__(self, *exc):
            current[0] = self.prev

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "device", Switch)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 1000 + i, raising=False)
    calls = []

    def entry(*args):
        calls.append((args, current[0]))
        return 0

    assert build.launch(entry, torch.device("cuda", index), 7, 8) == 0
    assert calls == [((7, 8, 1000 + index), index)]
    assert entered == ([1] if index else [])
    assert current == [0]


# -- the row shuffle (``threefry.shuffle_rows``): its kernel's sort, modelled ---

def model_bitonic_order(words: np.ndarray) -> np.ndarray:
    """The row-shuffle kernel's sort of (n, m) uint32 words, in numpy: the
    composite keys ``word << 32 | column``, padded with UINT64_MAX to the
    next power of two p, through the kernel's bitonic network (pair i of a
    stage of size ``size`` and stride s: a = (i & ~(s - 1)) << 1 | (i & (s
    - 1)) and a + s, ascending where a & size == 0); returns each row's
    columns in sorted order (the keys' low words)."""
    n, m = words.shape
    p = 1
    while p < m:
        p <<= 1
    slot = np.full((n, p), np.iinfo(np.uint64).max, np.uint64)
    slot[:, :m] = (words.astype(np.uint64) << np.uint64(32)) \
        | np.arange(m, dtype=np.uint64)
    i = np.arange(p // 2)
    size = 2
    while size <= p:
        stride = size >> 1
        while stride:
            a = ((i & ~(stride - 1)) << 1) | (i & (stride - 1))
            ka, kb = slot[:, a], slot[:, a + stride]
            swap = (ka > kb) == ((a & size) == 0)
            slot[:, a] = np.where(swap, kb, ka)
            slot[:, a + stride] = np.where(swap, ka, kb)
            stride >>= 1
        size <<= 1
    return (slot[:, :m] & np.uint64(0xFFFFFFFF)).astype(np.int64)


def model_shuffle_rows(keys: np.ndarray, n: int, m: int, k: int):
    """The row-shuffle kernel in numpy: x = arange(m) a row; each round the
    row's words under that round's key (``keys[r * n + i]``, counter (0,
    c)), the modelled sort, x permuted by the sorted columns; the first k
    columns."""
    from repro_torch import random as R

    rounds = keys.shape[0] // n if n else 0
    x = np.broadcast_to(np.arange(m), (n, m))
    for r in range(rounds):
        y0, y1 = R.threefry2x32(keys[r * n:(r + 1) * n, None, :],
                                np.zeros(m, np.uint32),
                                np.arange(m, dtype=np.uint32))
        x = np.take_along_axis(x, model_bitonic_order(y0 ^ y1), axis=1)
    return x[:, :k]


@pytest.mark.parametrize("n,m,distinct", [(16, 56, 3), (8, 150, 2),
                                          (4, 4096, 64), (3, 1, 1),
                                          (5, 2, 1), (5, 3, 2),
                                          (2, 16384, 7)])
def test_model_shuffle_sort_keeps_ties_like_lax_sort(n, m, distinct):
    """The kernel's sort (``model_bitonic_order``: composite keys, the
    bitonic network over the padded power of two) with forced ties (the
    data of ``test_stable_order_keeps_ties_in_order_like_lax_sort``, up to
    the fused route's limit) orders each row as JAX's
    ``lax.sort_key_val`` under vmap: equal words keep their column
    order."""
    import jax

    from repro_torch.kernels import threefry

    assert m <= threefry.SHUFFLE_MAX_M
    rng = np.random.default_rng(distinct)
    u = (rng.integers(0, distinct, (n, m)) * (2**32 // distinct)).astype(
        np.uint32)
    cols = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32), (n, m))
    _, want = jax.vmap(jax.lax.sort_key_val)(jnp.asarray(u), cols)
    np.testing.assert_array_equal(model_bitonic_order(u), np.asarray(want))


@pytest.mark.parametrize("n,m,k", [(16, 56, 1), (16, 34, 17), (16, 32, 32),
                                   (4, 1626, 9), (3, 1, 1), (5, 2, 2),
                                   (5, 3, 1)])
def test_model_shuffle_rows_equals_plain(n, m, k):
    """The kernel modelled whole (``model_shuffle_rows``: the draw, the
    sort, the permute, the cut, one and two rounds) equals the plain
    version ``ref.shuffle_rows_ref`` on the same subkeys, bitwise."""
    from repro_torch import random as R

    sub, rows = R._shuffle_keys(R.split(R.key(m), n), m, "cpu")
    assert rows == n and sub.shape == (R.shuffle_rounds(m) * n, 2)
    want = ref.shuffle_rows_ref(sub, n, m, k)
    assert want.shape == (n, k) and want.dtype == torch.int32
    np.testing.assert_array_equal(
        model_shuffle_rows(sub.numpy().view(np.uint32), n, m, k),
        want.numpy())


@pytest.mark.parametrize("m", [16383, 16384, 16385, 20000])
def test_shuffle_plan_switches_at_the_shared_memory_limit(m, monkeypatch):
    """``threefry.shuffle_plan``: the fused kernel up to SHUFFLE_MAX_M =
    16384 values a row (8 B of key a padded slot and 4 B of x a value,
    196,608 B of the 227 KB a block holds), the row draw and torch's sort
    above.  The limit is the widest row whose shared memory fits an H100
    block, the one check the C launcher makes.  The wrapper follows the
    plan on the card: with the card's route forced here, a row of m <=
    16384 goes to the kernel's library and one above to a row draw a
    round, equal to the plain version."""
    from repro_torch import random as R
    from repro_torch.kernels import build, threefry

    def fits(width):
        return 8 * (1 << (width - 1).bit_length()) + 4 * width <= 232_448

    assert threefry.SHUFFLE_MAX_M == 16384
    assert fits(threefry.SHUFFLE_MAX_M) and not fits(threefry.SHUFFLE_MAX_M
                                                      + 1)
    fused = m <= 16384
    assert threefry.shuffle_plan(m) == ("fused" if fused else "sorts")
    sub, n = R._shuffle_keys(R.split(R.key(m), 2), m, "cpu")
    draws = []

    def draw(keys, width, as_float):
        draws.append(width)
        return ref.threefry_rows_ref(keys, width, as_float)

    def load(name):
        raise LookupError(f"kernel library {name}")

    monkeypatch.setattr(threefry, "plain_route", lambda device: False)
    monkeypatch.setattr(threefry, "check_device", lambda *a: None)
    monkeypatch.setattr(threefry, "threefry_rows", draw)
    monkeypatch.setattr(build, "load", load)
    if fused:
        with pytest.raises(LookupError, match="threefry"):
            threefry.shuffle_rows(sub, n, m, 3)
        assert draws == []
    else:
        got = threefry.shuffle_rows(sub, n, m, 3)
        assert draws == [m] * R.shuffle_rounds(m)
        monkeypatch.undo()
        assert torch.equal(got, ref.shuffle_rows_ref(sub, n, m, 3))


def test_shuffle_rows_checks_its_arguments_and_allocates_on_meta():
    """The row-shuffle wrapper refuses keys that are not (rounds * n, 2)
    int32 and a cut wider than the row; on ``meta`` inside the dry run it
    allocates its (n, k) int32 output (either route) and counts no
    launch."""
    from repro_torch import kernels
    from repro_torch.kernels import threefry

    keys = torch.zeros((6, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        threefry.shuffle_rows(keys.long(), 3, 8, 2)
    with pytest.raises(ValueError, match="keys for 4 rows"):
        threefry.shuffle_rows(keys, 4, 8, 2)
    with pytest.raises(ValueError, match="cut to 9"):
        threefry.shuffle_rows(keys, 3, 8, 9)
    reset_launches()
    with kernels.dry_run():
        for m in (56, threefry.SHUFFLE_MAX_M + 1):
            out = threefry.shuffle_rows(keys.to("meta"), 3, m, 5)
            assert out.device.type == "meta" and out.dtype == torch.int32
            assert out.shape == (3, 5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        threefry.shuffle_rows(keys.to("meta"), 3, 56, 5)
    assert not any(LAUNCHES.values())
