"""Compressor micro-benchmarks of the port (the counterpart of the JAX
package's ``benchmarks/compressor_bench.py``, whose rows it prints under the
same names, as ``name,us_per_call,derived`` lines).

    PYTHONPATH=src python -m repro_torch.launch.compressor_bench \
        [--device cpu] [--full] [--seed N]

Rows:

* ``compressor/<name>``: the seven compressors of the JAX bench's ``run``
  at d = 2**16, median microseconds per call (host clock around a call
  that ends in a device synchronise);
* ``compressor/block_topk_kernel``: the dense block-top-k wrapper (the CUDA
  kernel on the card, its plain version on the CPU), the counterpart of
  ``block_topk_pallas_interpret``;
* ``wire/unfused_compress_pack`` and ``wire/fused_pack``: the packed wire
  pipeline, unfused (delta, dense block-top-k, pack, h update) against the
  fused pack kernel;
* ``wire/codec_<name>``: every codec's measured payload bytes against its
  exact bit count and the dense f32 payload, with the JAX bench's asserts;
* ``wire/fused_pack_bytes``: in place of the JAX bench's TPU-HLO proof, the
  device bytes that one call allocates on the embed leaf of qwen2-0.5b
  (151,936 x 896 values, block 256, kb 16), read from
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated``: the fused
  pack holds h' and the payload, no dense d; ``efbv_update`` holds d and
  h'.  On the CPU it says "not measured".

``--full`` adds, on the card, the dense kernels and the pack at the 14
full-width qwen2-0.5b leaves (494,032,768 f32 values, random from
``--seed``) for block/kb 256/16, 1024/16, 1024/64 and 4096/64: one
untimed pass of each kernel over the 14 leaves with its launch counts
(``full/launches_b<block>_k<kb>``), then each pass timed with CUDA events
(``full/<kernel>_b<block>_k<kb>``) beside its least time on an H100 SXM
(``ops.dense_bound_ms``: the bytes it must move at 3.35 TB/s, or its
operations at the card's instruction issue rate).

Runs on ``cuda`` unless ``--device cpu`` is given, and raises on a host
without a GPU.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, List

import torch

from repro_torch import random, resolve_device
from repro_torch.core.compressors import (QSGD, BlockTopK, CompKK, Identity,
                                          MixKK, Natural, RandK, SignNorm,
                                          TopK)
from repro_torch.distributed import wire
from repro_torch.kernels import LAUNCHES, ops, ref

D = 1 << 16
KEY = random.key(0)
#: the embed leaf of qwen2-0.5b, the largest: (vocab, d_model)
EMBED_SIZE = 151_936 * 896
#: block/kb of the --full passes: the SMOKE path's, the JAX bench's, the
#: ops wrappers' defaults, and the JAX perf_iter and dry run's default
#: compressor (block_topk:4096,64)
FULL_CONFIGS = ((256, 16), (1024, 16), (1024, 64), (4096, 64))
LAM = 0.9
#: the caching allocator's rounding of one allocation is below 2 MiB (a
#: free block is split when more than 1 MiB would be left)
ALLOC_SLACK = 2 << 20


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit_us(fn: Callable, dev: torch.device, iters: int = 20,
              warmup: int = 3) -> float:
    """Median microseconds per call of ``fn()``, each call ended by a device
    synchronise (the JAX bench's ``block_until_ready``)."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def compressor_rows(dev: torch.device, fast: bool = True) -> List[Dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(D, generator=gen, device=dev)
    cases = [
        ("topk_1pc", lambda: TopK(D // 100)(KEY, x)),
        ("randk_1pc", lambda: RandK(D // 100)(KEY, x)),
        ("comp_k_kp", lambda: CompKK(D // 100, D // 2)(KEY, x)),
        ("block_topk_core", lambda: BlockTopK(1024, 16)(KEY, x)),
        ("natural", lambda: Natural()(KEY, x)),
        ("qsgd_s16", lambda: QSGD(16)(KEY, x)),
        ("block_topk_ref",
         lambda: ref.block_topk_ref(ops.to_rows(x, 1024), 16)),
    ]
    iters = 5 if fast else 30
    rows = [{"name": f"compressor/{name}",
             "us_per_call": f"{timeit_us(fn, dev, iters):.1f}",
             "derived": f"d={D}"} for name, fn in cases]
    us = timeit_us(lambda: ops.block_topk(x, block=1024, kb=16), dev, iters)
    rows.append({"name": "compressor/block_topk_kernel",
                 "us_per_call": f"{us:.1f}",
                 "derived": f"device={dev.type}"})
    return rows


def packed_vs_dense(dev: torch.device, fast: bool = True) -> List[Dict]:
    """us/call of the fused compress-and-pack against the unfused pipeline
    (delta, the dense block-top-k kernel, the pack's re-read, the h
    update), on the JAX bench's leaf: d = 2**16, block 1024, kb 16."""
    block, kb = 1024, 16
    lw = wire.LeafWire(shape=(D,), size=D, block=block, kb=kb)
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn(D, generator=gen, device=dev)
    h = torch.randn(D, generator=gen, device=dev)

    def unfused():
        delta = g - h                                       # pass 1
        dns = ops.block_topk(delta, block=block, kb=kb)     # dense d: 2
        vals, idx = wire.pack_oracle(lw, delta)             # re-read: 3
        return (vals, idx), h + LAM * dns                   # h update: 4

    iters = 5 if fast else 30
    us_u = timeit_us(unfused, dev, iters)
    us_f = timeit_us(lambda: wire.fused_pack(lw, g, h, LAM), dev, iters)
    bits = wire.WireFormat((lw,)).bits_per_round()
    return [{"name": "wire/unfused_compress_pack",
             "us_per_call": f"{us_u:.1f}",
             "derived": f"d={D} dense_d_materialized=True"},
            {"name": "wire/fused_pack", "us_per_call": f"{us_f:.1f}",
             "derived": f"d={D} payload_bits={bits}"}]


def codec_payload_rows(dev: torch.device, d: int = D) -> List[Dict]:
    """Every codec's measured payload bytes against its exact bit count
    and the dense f32 payload (the JAX bench's ``codec_payload_rows``, with
    its asserts: 8 * bytes == bits, QSGD and natural at most 1/3 of
    dense)."""
    x = torch.randn(d, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    dense_bytes = 4 * d
    cases = [
        ("identity", Identity()),
        ("topk_1pc", TopK(d // 100)),
        ("randk_1pc", RandK(d // 100)),
        ("comp_k_kp", CompKK(d // 100, d // 10)),
        ("mix_k_kp", MixKK(d // 200, d // 200)),
        ("block_topk", BlockTopK(1024, 16)),
        ("sign", SignNorm()),
        ("natural", Natural()),
        ("qsgd_s16", QSGD(16)),
    ]
    rows = []
    for name, comp in cases:
        codec = wire.codec_of(comp, (d,), d)
        measured = wire.payload_bytes(codec.encode(KEY, x))
        assert 8 * measured == codec.payload_bits, (name, measured)
        ratio = measured / dense_bytes
        if name in ("qsgd_s16", "natural"):
            assert ratio <= 1 / 3, (name, ratio)
        rows.append({
            "name": f"wire/codec_{name}", "us_per_call": "",
            "derived": f"kind={codec.kind} payload_bytes={measured} "
                       f"bits_per_round={codec.payload_bits} "
                       f"vs_dense_fp32={ratio:.4f}x"})
    return rows


def allocated_by(fn: Callable, dev: torch.device):
    """(fn(), bytes its results hold, bytes allocated at its peak), both
    above what was allocated when it started."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return (out, torch.cuda.memory_allocated(dev) - base,
            torch.cuda.max_memory_allocated(dev) - base)


def fused_pack_bytes_row(dev: torch.device, seed: int = 0) -> Dict:
    """The device bytes one call allocates on the embed leaf: the fused
    pack holds h' and the (values, indices) payload and no dense d;
    ``efbv_update`` holds d and h'; ``block_topk`` its dense output."""
    name = "wire/fused_pack_bytes"
    if dev.type != "cuda":
        return {"name": name, "us_per_call": "",
                "derived": f"not measured on {dev.type} (device bytes)"}
    block, kb, n = 256, 16, EMBED_SIZE
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.randn(n, generator=gen, device=dev)
    lw = wire.LeafWire(shape=(n,), size=n, block=block, kb=kb)
    dense, payload = 4 * n, 8 * lw.nb * kb
    out, f_alloc, f_peak = allocated_by(
        lambda: wire.fused_pack(lw, g, h, LAM), dev)
    del out
    out, u_alloc, u_peak = allocated_by(
        lambda: ops.efbv_update(g, h, LAM, block=block, kb=kb), dev)
    del out
    out, t_alloc, t_peak = allocated_by(
        lambda: ops.block_topk(g, block=block, kb=kb), dev)
    del out
    row = {"name": name, "us_per_call": "",
           "derived": f"size={n} block={block} kb={kb} "
                      f"fused_alloc={f_alloc} fused_peak={f_peak} "
                      f"h_plus_payload={dense + payload} "
                      f"efbv_update_alloc={u_alloc} efbv_update_peak={u_peak} "
                      f"d_plus_h={2 * dense} block_topk_alloc={t_alloc} "
                      f"block_topk_peak={t_peak} dense_d={dense}"}
    # each call holds its outputs and nothing else, to within the
    # allocator's rounding of each of them: the fused pack no dense d
    for got, want, outputs in ((f_peak, dense + payload, 3),
                               (u_peak, 2 * dense, 2), (t_peak, dense, 1)):
        assert want <= got < want + outputs * ALLOC_SLACK, row
    return row


# ---------------------------------------------------------------------------
# --full: the 14 full-width leaves, with bounds
# ---------------------------------------------------------------------------

def full_leaf_sizes() -> List[int]:
    """Sizes of the 14 full-width qwen2-0.5b leaves, in flatten order."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    abstract = build_model(get_config("qwen2-0.5b")).init_abstract()
    return [leaf.numel() for leaf in T.leaves(abstract)]


def pass_ms(fn: Callable, reps: int = 10) -> float:
    """Median ms of one ``fn()`` (a pass over the leaves) between CUDA
    events, after one warm-up pass."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def full_rows(dev: torch.device, seed: int = 0) -> List[Dict]:
    if dev.type != "cuda":
        raise RuntimeError("--full measures the card: run it on cuda")
    sizes = full_leaf_sizes()
    gen = torch.Generator(device=dev).manual_seed(seed)
    gs = [torch.randn(n, generator=gen, device=dev) for n in sizes]
    hs = [torch.randn(n, generator=gen, device=dev) for n in sizes]
    values = sum(sizes)
    rows = []
    for block, kb in FULL_CONFIGS:
        lws = [wire.LeafWire(shape=(n,), size=n, block=block, kb=kb)
               for n in sizes]
        passes = {
            "block_topk": lambda: [ops.block_topk(g, block=block, kb=kb)
                                   for g in gs],
            "efbv_update": lambda: [ops.efbv_update(g, h, LAM, block=block,
                                                    kb=kb)
                                    for g, h in zip(gs, hs)],
            "pack_update": lambda: [wire.fused_pack(lw, g, h, LAM)
                                    for lw, g, h in zip(lws, gs, hs)],
        }
        before = dict(LAUNCHES)
        for fn in passes.values():
            fn()
        torch.cuda.synchronize(dev)
        counts = {k: LAUNCHES[k] - before[k] for k in passes}
        tag = f"b{block}_k{kb}"
        rows.append({"name": f"full/launches_{tag}", "us_per_call": "",
                     "derived": " ".join(f"{k}={v}"
                                         for k, v in counts.items())})
        payload = sum(8 * lw.nb * kb for lw in lws)
        for name, fn in passes.items():
            ms = pass_ms(fn)
            b_ms, by = ops.dense_bound_ms(
                name, values, payload=payload * (name == "pack_update"))
            rows.append({
                "name": f"full/{name}_{tag}", "us_per_call": f"{ms * 1e3:.1f}",
                "derived": f"values={values} leaves={len(sizes)} "
                           f"ms={ms:.4f} bound_ms={b_ms:.4f} ({by}) "
                           f"x_bound={ms / b_ms:.2f}"})
        torch.cuda.empty_cache()
    return rows


def run(dev: torch.device, fast: bool = True, full: bool = False,
        seed: int = 0) -> List[Dict]:
    rows = compressor_rows(dev, fast)
    rows += packed_vs_dense(dev, fast)
    rows += codec_payload_rows(dev)
    rows.append(fused_pack_bytes_row(dev, seed))
    if full:
        rows += full_rows(dev, seed)
    return rows


def emit(rows: List[Dict]) -> None:
    for r in rows:
        print(f"{r['name']},{r.get('us_per_call', '')},{r.get('derived', '')}")


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="also time the kernels at the 14 full-width "
                         "qwen2-0.5b leaves (on the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = run(dev, full=args.full, seed=args.seed)
    emit(rows)
    return rows


if __name__ == "__main__":
    main()
