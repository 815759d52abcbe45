"""The port's compressors, wire accounting and leaf paths against
``repro``.  Inputs from numpy seeds; tolerance: none (bitwise, exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import compressors as jcomp
from repro.distributed import wire as jwire
from repro.models import build_model as jbuild_model
from repro_torch import random as R
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import compressors as tcomp
from repro_torch.distributed import wire as twire
from repro_torch.models.model import build_model

SMOKE_BITS = 5_776_384
FULL_BITS = 1_976_131_584
FULL_PARAMS = 494_032_768
SMOKE_RANDK_BITS = 2_244_608      # randk:4096
FULL_RANDK_BITS = 541_450_240     # randk:1048576


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
def test_unported_compressors_refused(spec):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tcomp.make_compressor(spec)


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
