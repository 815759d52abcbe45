#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final ``{"ok": true, ...}``
line is printed only when every phase passed):

1. build   -- compile every CUDA source of the port with nvcc (sm_90a), one
              nvcc per source, all started together.
2. kernels -- each kernel against its plain PyTorch version on the card,
              bitwise, at the main paths' shapes and edge cases; times each
              (CUDA events, median of 20) beside its plain version and its
              memory/compute bound.  The pack kernel also with a partial
              last CTA (kb 3 on 8m + 1 rows) and kb = 1024 (128 KiB of
              shared memory); its SASS must hold the TMA bulk store.  The
              rand-k kernel (one pass over h in tiles, the positions
              bucketed by tile) at the old edge cases and at its tiles'
              edges (every position in one tile, tile edges, a partial last
              tile, one tile and one plus one value, k = size, the embed
              leaf at k = 1, more tiles than shared memory counts), with
              its device time per leaf and per kernel; a position out of
              range must make the launch fail, in one launch and bucketed
              (checked in a child process: the trap poisons its CUDA
              context).  The shuffle behind rand-k's positions
              (``random.permutation``), GPU against CPU bitwise, and timed
              at the embed leaf's size.  The three block-top-k kernels
              (``pack_update.cu``; ``block_topk.cu``'s dense block-top-k and
              fused dense update, f32 and bf16) bitwise at every block
              from 128 to 4096 (ragged rows, kb 1 / 2 / 3 / 16 / 64 /
              block) and at blocks 4224 / 8192 / 16384 / 65536 (kb 1 / 3 /
              64 / block/2 / block), a leaf below its block, ties, NaN
              rows, +-inf and mixed types, and ``efbv_update`` on exactly
              one unreshaped (8, block) f32 tile at kb = 1, where the
              wrapper asks for one rounding of h' (ROADMAP fault m);
              ``wire.fused_pack`` routes a
              block % 128 != 0 to the plain path under ``auto`` and runs
              the kernel at 4224; at the 14 full-width leaves at block/kb
              256/16, 1024/16, 1024/64, 4096/64 and 8192/64, timed at
              256/16, 4096/64 and 8192/64; the selection's SASS per value
              and step, and the search's mean steps on those leaves.  The
              reference backend's two kernels (``kernels_rows``): the row
              draw (``threefry_rows``, n keys at once) and the ordered
              worker sum (``worker_sum.cu``, with and without the mask and
              the fused master update), bitwise against their plain
              versions at n in {16, 1000} and d in {64, 112, 300, 2**20},
              timed beside them; the stable sorts of the batched
              compressors with forced ties, card == CPU == numpy.
3. reference -- JAX's initial weights (``Model.init(random.key(0))``,
              XLA's f32 erf_inv emulated) of the smoke config drawn on the
              card bitwise equal to the CPU's, and a 2**22-value normal
              draw.  A small input (the qwen2 smoke config, f32
              activations): three 2-worker EF-BV steps on the GPU (kernel
              path) against
              the same steps on the CPU (plain path) from the same params
              and keys, for each path below, and block-top-k also at
              384/16 and 4096/64.  Then two gloo ranks on cuda:0
              (``torchrun``, this script's ``--dist-child reference``)
              against the one-process loop on the card, losses and final
              params bitwise on both ranks: block-top-k, QSGD both ways,
              rand-k, pipelined, dense_psum at n = 2, ``bernoulli:0.5`` and
              n = 4 on two ranks (``DIST_REF``); and ``ring_allgather``
              (staged through pinned host buffers: gloo's send of a CUDA
              tensor aborts the process) equal to ``all_gather``.
3a. zoo -- the rest of the trainer's wire at smoke size (``ZOO_CASES``),
              2 steps of ``build(spec)``'s trainer on the card and on the
              CPU from the same init, batches and keys: the eight uplinks
              that no main path runs (top-k, scaled rand-k, comp, mix,
              sign, natural, frac top-k, frac comp) over the sparse
              all-gather, a top-k and a block-top-k downlink, a mixed fleet
              (``topk:64;randk:64``, dense_psum) and block-top-k on a bf16
              and an f16 wire: each case's exact bits, the losses within
              the CPU tests' 1e-5 relative and the params within AdamW's
              bound of the CPU's.
3b. reference backend -- through the spec (``repro_torch.core.build``),
              the workers batched: (a) the committed
              ``examples/specs/reference_logreg_efbv.json`` (500 rounds,
              n = 16, d = 64, comp-(2, 32), auto-tuned) on the card and on
              the CPU, each drawing its own problem (ms per round, f(x) -
              f* at rounds 0, 100 and 500, within 1e-5 of each other); (b)
              the same spec with the exact gradient x - B_i, x, h and h_avg
              bitwise card against CPU; (c) a round at paper Figure 2's
              scale (logreg, d = 112, n = 1000 workers of 8 rows each,
              comp-(1, 56)), EF-BV and EF21, 100 rounds each on the card
              and on the CPU (the card's data), within 1e-5 relative, and
              one short run profiled (launches, copies, device and host
              time a round); (d) the paper's experiments from
              ``paper_torch/`` at their fast setting on the card: Table 3's
              five rows (each ``matches_paper=True``), Figure 2 (mushrooms
              and phishing, n = 1000, 1500 rounds of EF-BV and EF21) and
              Figure 3 (mushrooms, n = 200, 1200 rounds), every trajectory
              finite and descending, with the seconds each took.  Only
              rounds are timed in (a)-(c): each problem is drawn, f* solved
              and the stepsize tuned before the timer.  Its launches (the
              problems' threefry draws, one row draw per shuffle round and
              one worker sum a round, none of it growing with n) are a
              main path's, ``reference``.
4. main paths -- ``repro_torch.launch.train.main`` at the full width and
              depth of qwen2-0.5b, 2 workers, 3 steps, sparse all-gather
              wire, once per path:
              * block-top-k (256, 16) up, dense broadcast down;
              * QSGD(16) up and down (bidirectional);
              * rand-k (k = 1048576) up, dense broadcast down;
              * pipelined (``--pipeline depth:1``): block-top-k (256, 16)
                up, QSGD(16) down;
              * federated: block-top-k (256, 16) up, ``--participation
                fixed:1``: ``|S|=1/2`` at every step and the federated wire
                line with ``E|S_t|=1 of 2``;
              * leaf_codecs: block-top-k (256, 16) with ``--leaf-codecs
                '*embed*=qsgd:16;*norm*=identity'`` (the per-leaf wire:
                the embedding QSGD, the final norm dense, 12 leaves
                block-sparse): 2,520,694,816 bits a worker, 72
                ``pack_update`` and 6 ``qsgd_pack_update`` launches;
              * smoke_flags: ROADMAP's SMOKE flags (block-top-k (256,
                16) up, QSGD(16) down, sequential), the mesh path's
                reference (not profiled);
              * spec: the pipelined path's flags written as a spec file
                (``spec_from_args``, ``build/spec/pipelined.json``) and run
                with ``--spec``: the printed fingerprint equal to the
                file's and the pipelined run's, and every step's loss and
                params checksum equal to the pipelined path's (not profiled
                again).
              Every run draws JAX's weights, 169 threefry launches.
              Checks a finite loss at every step, the exact printed wire
              bits, and that every kernel of the path launched the expected
              number of times (launch counts are reset just before each path
              and read just after); on the pipelined path, that step 0
              applies the zero priming payload (|g| = 0).  Each step's loss
              (hex) and a checksum of the params are recorded.
   Then, one process per worker: two gloo ranks sharing cuda:0 under
              ``torchrun`` (this script's ``--dist-child``), each rank's
              output in ``build/dist/<path>/rank<r>.log``:
              * dist_block_topk: the block-top-k path's flags, sparse
                all-gather of one byte buffer per round;
              * dist_pipelined: the pipelined path's flags, the all-gather
                started asynchronously and waited on before the next
                round's combine.
              Rank 0 must print the exact bits and (pipelined) |g| = 0 at
              step 0; on every rank, every step's loss and params checksum
              must equal the one-process path's, and its launches must be
              as stated (42 ``pack_update`` per rank; pipelined also 42
              ``threefry_uniform``).  A rank that fails, or a launch not
              done in DIST_TIMEOUT_S (then killed with all its ranks),
              fails the run.
   Then the mesh: the smoke_flags path's flags on ``--mesh 2x2`` (2
              workers x 2-way tensor parallelism), four gloo ranks sharing
              cuda:0: rank 0's exact bits, finite losses within 1e-3
              relative of smoke_flags's on every rank, 42 ``pack_update``
              and 42 + 169 ``threefry_uniform`` a rank, the two ranks of
              each model index bitwise equal in their shards of params, w,
              h_avg, m and v after every step, and the first worker's
              shards, reassembled, within the stated bound of smoke_flags's
              final params (``mesh_params_check``); per rank the step ms,
              the host ms, calls and bytes sent of the model-axis
              collectives and of the worker exchange, and the peak.  Then
              the four committed 2x2 specs (``examples/specs/``
              pipelined_blocktopk, qsgd_bidirectional, federated_blocktopk,
              tree_mixed_codecs)
              at smoke size on four ranks (``--dist-child mesh_specs``):
              each prints the file's fingerprint, its exact bits and four
              finite losses, with its launches per rank as MESH_SPECS
              says; and whether gloo's all-reduce takes a bf16 CUDA
              tensor.
   Then the compressor bench (``repro_torch.launch.compressor_bench``
              ``main(["--full"])``): every compressor and codec row at
              d = 2**16, the fused pack's device bytes on the embed leaf,
              and the dense kernels and the pack at the 14 full-width
              leaves (block/kb 256/16, 1024/16, 1024/64, 4096/64), whose
              untimed pass must launch each kernel exactly 14 times.
5. profile -- each path, one step on the host clock and one under
              torch.profiler: device time by kernel, busy share; the peak
              device memory of a step and of each of its phases; for the
              QSGD path also its uplink encode, downlink broadcast and norm
              pass, each alone; for rand-k one worker's uplink encode, the
              embed leaf's encode and its shuffle, and the shuffles' share
              of the step; for the pipelined path the in-flight buffer's
              resident bytes.  The dist paths' profile lines come from
              their main run, per rank: step ms, host ms in the exchange
              (around the all-gather, or the ``wait()`` when pipelined),
              bytes gathered per rank per round, and peak device memory.
              Two processes on one card time-slice its contexts and gloo
              moves the payload through host memory: these are not times
              of NCCL across cards.

The last lines are a JSON object per kernel (times, bound, launches), the
card's name and power limit, and the result line.  Needs one CUDA GPU and
the CUDA toolkit; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
# That rate is 132 SMs x 128 f32 lanes x 2 (an FMA counts two) x 1.98 GHz.
# Each SM issues one warp instruction per clock from each of its four
# schedulers (128 thread instructions), and retires 64 results per clock of
# 32-bit integer add, shift, logic and compare (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0).
H100_ISSUE_PER_S = H100_F32_OPS_PER_S / 2   # thread instructions, f32 ops
H100_INT32_PER_S = H100_F32_OPS_PER_S / 4   # on the integer pipe
# SASS opcodes that run on the integer pipe (64 results per clock per SM)
INT_PIPE = {"IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "IMNMX", "PRMT"}
FULL_BITS = 1_976_131_584        # qwen2-0.5b, block_topk:256,16, per worker
QSGD_BITS = 3_952_262_592        # qwen2-0.5b, qsgd:16, per worker and down
QSGD_TOTAL_BITS = 11_856_787_776  # 2 uplink payloads + 1 broadcast
# qwen2-0.5b, block_topk:256,16 with '*embed*=qsgd:16;*norm*=identity', per
# worker: the embed leaf QSGD, final_norm dense, the other 12 block-sparse
LEAF_CODECS_BITS = 2_520_694_816
LEAF_RULES = "*embed*=qsgd:16;*norm*=identity"
RANDK_BITS = 541_450_240         # qwen2-0.5b, randk:1048576, per worker
# pipelined: block-top-k up (FULL_BITS per worker), QSGD(16) down
PIPELINED_TOTAL_BITS = 7_904_525_760
RANDK_K = 1_048_576
FULL_LEAVES, WORKERS, STEPS = 14, 2, 3
# rand-k: the sort rounds of one worker's 14 shuffles (checked against the
# tree in phase 2)
SHUFFLE_ROUNDS = 35
EMBED_SIZE = 151_936 * 896
REPS = 20
# f32 operations per QSGD value (sub, abs, div, mul, floor, sub, compare,
# 2 compares, add, mul, convert, compare, 3 mul, mul, add)
QSGD_OPS = 19


def timed_ms(fn, reps=REPS):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings,
    after two warm-up calls."""
    for _ in range(2):
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


def pack_bound_ms(size, block, kb):
    """Least time for one pack call: read g and h, write h_out and the
    payload (bytes); or kb selection compares per value (operations)."""
    from repro_torch.kernels import ops

    return ops.dense_bound_ms("pack_update", size,
                              payload=8 * -(-size // block) * kb)


def f32(x):
    """x rounded to the nearest f32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def same_bits(a, b):
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_diff(a, b):
    """max |a - b| over the values that differ and are not both NaN (0.0
    if none): equal infinities count 0, not inf - inf = NaN."""
    a, b = a.double(), b.double()
    d = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


SOURCES = ("pack_update", "qsgd_pack_update", "randk_update", "threefry",
           "block_topk", "worker_sum")


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.compile_sources(SOURCES)
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"[build] {name}.cu:\n{log.strip()}")
    print(f"[build] seconds={secs:.2f} built={sorted(logs)}")
    for name in SOURCES:
        build.load(name)


def pack_case(name, g, h, block, kb, lam=0.37, timing=True, quiet=False):
    """Kernel vs plain version on (g, h) flat f32 CUDA tensors; returns
    (kernel ms, plain ms, bound ms, max |diff|).  ``quiet``: no line of
    its own (the block sweep prints one per block)."""
    from repro_torch.kernels import ops, pack, ref

    def rows(x):
        return ops.to_rows(x, block)

    g2, h2 = rows(g), rows(h)
    kv, ki, kh = pack.pack_update(g2, h2, lam, kb)
    pv, pi, ph = ref.pack_update_ref(g2, h2, lam, kb)
    torch.cuda.synchronize()
    err = max(max_abs_diff(kv, pv), max_abs_diff(kh, ph))
    ok = same_bits(kv, pv) and same_bits(ki, pi) and same_bits(kh, ph)
    if not ok:
        raise AssertionError(f"[kernels] {name}: kernel != plain version "
                             f"(max |diff| {err})")
    bound, by = pack_bound_ms(g.numel(), block, kb)
    k_ms = p_ms = float("nan")
    if timing:
        k_ms = timed_ms(lambda: pack.pack_update(g2, h2, lam, kb))
        p_ms = timed_ms(lambda: ref.pack_update_ref(g2, h2, lam, kb))
    if not quiet:
        print(f"[kernels] {name}: size={g.numel()} block={block} kb={kb} "
              f"bitwise=ok kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
    return k_ms, p_ms, bound, err


def full_leaves():
    """(path, size) of every full-width qwen2-0.5b leaf, in flatten order."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    abstract = build_model(get_config("qwen2-0.5b")).init_abstract()
    return [("/".join(path), leaf.numel())
            for path, leaf in T.flatten_with_path(abstract)]


def phase_kernels():
    pack_row = kernels_pack()
    torch.cuda.empty_cache()
    qsgd_row = kernels_qsgd()
    torch.cuda.empty_cache()
    randk_row = kernels_randk()
    torch.cuda.empty_cache()
    threefry_row = kernels_threefry()
    torch.cuda.empty_cache()
    kernels_permutation()
    torch.cuda.empty_cache()
    dense_rows = kernels_dense()
    torch.cuda.empty_cache()
    rows_rows = kernels_rows()
    torch.cuda.empty_cache()
    return {"pack_update": pack_row, "qsgd_pack_update": qsgd_row,
            "randk_update": randk_row, "threefry_uniform": threefry_row,
            **dense_rows, **rows_rows}


def bulk_store_sass():
    """The bulk-copy opcodes in the SASS of the pack kernel
    (``cuobjdump -sass``), one instance per block size: the TMA bulk store
    of the payload must be there."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass",
                           str(build.lib_path("pack_update"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    funcs = [f for f in text.split("Function : ")[1:]
             if "pack_update_rows" in f.split(None, 1)[0]]
    bulk = {}
    for func in funcs:
        for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", func):
            tokens = ins.split()
            op = tokens[1] if tokens[0].startswith("@") else tokens[0]
            if op.startswith(("UBLKCP", "FENCE", "DEPBAR")):
                bulk[op] = bulk.get(op, 0) + 1
    print(f"[kernels] pack_update SASS over its {len(funcs)} block sizes: "
          f"{bulk}")
    if not any(o.startswith("UBLKCP") for o in bulk):
        raise AssertionError("[kernels] no bulk-copy (UBLKCP) instruction "
                             "in the pack kernel's SASS")
    return bulk


#: every block the block-top-k kernels hold in registers, and the kb of the
#: sweep
SWEEP_BLOCKS = tuple(range(128, 4097, 128))
SWEEP_KB = (1, 2, 3, 16, 64)
#: blocks above 4096 (the row read again at each search step: from shared
#: memory up to 16384, from device memory at 65536, where the pack's kb /
#: 2 and kb slots go to device memory too), at kb 1 / 3 / 64 / block / 2 /
#: block; the full-width pass timed at BIG_LEAF_CONFIG
BIG_BLOCKS = (4224, 8192, 16384, 65536)
BIG_LEAF_CONFIG = (8192, 64)


def big_kbs(block):
    return (1, 3, 64, block // 2, block)


def big_rows(block):
    """Values of a big-block sweep case: 17 rows, the last ragged."""
    return block * 17 - 37
#: the 14 full-width leaves' block/kb held bitwise; 256/16 and 4096/64 timed
LEAF_CONFIGS = ((256, 16), (1024, 16), (1024, 64), (4096, 64))
TIMED_CONFIGS = ((256, 16), (4096, 64))


def sweep_rows(block):
    """Values of a sweep case: 8 m + 1 rows (a partial last CTA of the
    warp-per-row kernels) with a ragged last row."""
    return block * (8 * 6 + 1) - 37


def kernels_pack():
    """Edge cases bitwise (ties and NaN rows at 8192 too); every block
    128..4096 at kb 1/2/3/16/64/block, and BIG_BLOCKS at big_kbs; a leaf
    below its block (one padded row); the route by shape of
    ``wire.fused_pack`` (a block % 128 != 0 takes the plain path under
    ``auto``, before any launch, ``cuda`` raises; block 4224 launches the
    kernel); the 14 full-width leaf shapes at every block/kb of
    LEAF_CONFIGS bitwise; one worker's full round at 256/16 (the row of the
    kernels JSON line) and 4096/64, timed; and at BIG_LEAF_CONFIG, bitwise
    and timed."""
    from repro_torch.distributed import wire
    from repro_torch.kernels import LAUNCHES, ops, pack, reset_launches

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(n):
        return torch.randn(n, generator=gen, device="cuda")

    bulk_store_sass()
    max_err = 0.0
    # edge cases
    n = 896
    max_err = max(max_err, pack_case("ragged_896", randn(n), randn(n),
                                     256, 16)[3])
    n = 4096 * 1024
    max_err = max(max_err, pack_case("block1024_kb64", randn(n), randn(n),
                                     1024, 64)[3])
    n = 128 * 1000
    max_err = max(max_err, pack_case("kb_eq_block128", randn(n), randn(n),
                                     128, 128)[3])
    n = 512 * 2000
    max_err = max(max_err, pack_case("block512_kb16", randn(n), randn(n),
                                     512, 16)[3])
    # the last CTA holding one row (8m + 1 rows): a 12-byte slab row at
    # kb 3; and kb = block = 1024, 64 KiB of shared memory per CTA
    n = 128 * (8 * 1000 + 1)
    max_err = max(max_err, pack_case("kb3_rows8m+1", randn(n), randn(n),
                                     128, 3)[3])
    n = 1024 * (8 * 64 + 3)
    max_err = max(max_err, pack_case("kb_eq_block1024", randn(n), randn(n),
                                     1024, 1024, 0.37, False)[3])
    # ties: integers in [-3, 3]; every 7th row of delta all zero; some -0.0
    for block in (256, 1152, 4096, 8192):
        n = block * 1024
        gi = torch.randint(-3, 4, (n,), generator=gen, device="cuda").float()
        hi = torch.randint(-3, 4, (n,), generator=gen, device="cuda").float()
        rows = gi.view(-1, block)
        rows[::7] = hi.view(-1, block)[::7]
        zero_h = hi == 0
        gi[zero_h & (torch.arange(n, device="cuda") % 5 == 0)] = -0.0
        for kb in (1, 16, 64):
            max_err = max(max_err, pack_case(f"ties_int_b{block}_kb{kb}", gi,
                                             hi, block, kb, timing=False)[3])
    # NaN in a row's delta (a diverged gradient): that row selects nothing
    # and sends (0.0, 0) in every slot, as the Pallas kernel does.  Row 0 is
    # all NaN, row 3 has one NaN, and every 5th row from row 10 one more;
    # +-inf are selected like any other magnitude (more infs than kb in
    # row 4, a row of +inf in row 6)
    for block in (256, 2048, 8192):
        n = block * 64
        gn, hn = randn(n), randn(n)
        gn[:block] = float("nan")
        gn[3 * block + 100] = float("nan")
        gn[10 * block + 7::5 * block + 1] = float("nan")
        gn[4 * block + 10:4 * block + 60:2] = float("inf")
        gn[4 * block + 11:4 * block + 61:2] = -float("inf")
        gn[6 * block:7 * block] = float("inf")
        for kb in (3, 16):
            max_err = max(max_err, pack_case(f"nan_inf_rows_b{block}_kb{kb}",
                                             gn, hn, block, kb,
                                             timing=False)[3])

    # every block the kernel takes, kb 1/2/3/16/64/block, on ragged rows
    for block in SWEEP_BLOCKS:
        n = sweep_rows(block)
        g, h = randn(n), randn(n)
        for kb in SWEEP_KB + (block,):
            max_err = max(max_err, pack_case(
                f"sweep_b{block}_kb{kb}", g, h, block, kb, timing=False,
                quiet=True)[3])
        print(f"[kernels] pack_update sweep block={block}: kb "
              f"{SWEEP_KB + (block,)} bitwise=ok ({n} values)")
    for block in BIG_BLOCKS:
        n = big_rows(block)
        g, h = randn(n), randn(n)
        for kb in big_kbs(block):
            max_err = max(max_err, pack_case(
                f"sweep_b{block}_kb{kb}", g, h, block, kb, timing=False,
                quiet=True)[3])
        print(f"[kernels] pack_update sweep block={block}: kb "
              f"{big_kbs(block)} bitwise=ok ({n} values)")
    # a leaf below its block: one padded row
    for kb in (1, 64, 8192):
        max_err = max(max_err, pack_case(f"one_padded_row_kb{kb}",
                                         randn(5000), randn(5000), 8192,
                                         kb)[3])

    # the route by shape: block 100 under auto takes the plain layout path
    # (no launch), bitwise against the plain path on the CPU; an explicit
    # cuda raises; block 4224 under auto launches the kernel once, bitwise
    # against the plain path on the CPU
    for block in (100, 4224):
        lw = wire.LeafWire(shape=(3 * block + 7,), size=3 * block + 7,
                           block=block, kb=4)
        g, h = randn(lw.size), randn(lw.size)
        reset_launches()
        (v, i), hn = wire.fused_pack(lw, g, h, 0.37)
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        (wv, wi), wh = wire.fused_pack(lw, g.cpu(), h.cpu(), 0.37,
                                       kernel="auto" if block % 128 == 0
                                       else "oracle")
        want = {**dict.fromkeys(launched, 0),
                "pack_update": int(block % 128 == 0)}
        if launched != want or not all(
                same_bits(a.cpu(), b) for a, b in ((v, wv), (i, wi),
                                                   (hn, wh))):
            raise AssertionError(f"[kernels] block={block} under auto: "
                                 f"launches {launched}, or != the plain "
                                 "path")
        print(f"[kernels] block={block} under auto: "
              + ("one pack_update launch" if block % 128 == 0
                 else "plain layout path, no launch")
              + ", bitwise == the CPU plain path")
    lw = wire.LeafWire(shape=(100,), size=100, block=100, kb=4)
    try:
        wire.fused_pack(lw, randn(100), randn(100), 0.37, kernel="cuda")
    except ValueError as e:
        print(f"[kernels] block=100 kernel=cuda raises on the card: {e}")
    else:
        raise AssertionError("[kernels] block=100 kernel=cuda ran on the "
                             "card")

    # the 14 full-width leaves at every block/kb, bitwise; timed at 256/16
    # (one worker's round: the kernels JSON line) and 4096/64
    leaves = full_leaves()
    rounds = {}
    for block, kb in LEAF_CONFIGS:
        timing = (block, kb) in TIMED_CONFIGS
        k_tot = p_tot = b_tot = 0.0
        for path, size in leaves:
            k_ms, p_ms, b_ms, err = pack_case(
                f"qwen2:{path}", randn(size), randn(size), block, kb, 0.37,
                timing, quiet=not timing)
            k_tot, p_tot, b_tot = k_tot + k_ms, p_tot + p_ms, b_tot + b_ms
            max_err = max(max_err, err)
            torch.cuda.empty_cache()
        by = pack_bound_ms(leaves[0][1], block, kb)[1]
        rounds[block, kb] = (k_tot, p_tot, b_tot, by)
        print(f"[kernels] pack_update qwen2-0.5b round (14 leaves, one "
              f"worker, block {block}, kb {kb}): bitwise=ok"
              + (f" kernel_ms={k_tot:.4f} plain_ms={p_tot:.4f} "
                 f"bound_ms={b_tot:.4f}" if timing else ""))
    block, kb = BIG_LEAF_CONFIG
    k_tot = b_tot = 0.0
    for path, size in leaves:
        g, h = randn(size), randn(size)
        max_err = max(max_err, pack_case(f"qwen2:{path}", g, h, block, kb,
                                         0.37, False, quiet=True)[3])
        g2, h2 = ops.to_rows(g, block), ops.to_rows(h, block)
        k_tot += timed_ms(lambda: pack.pack_update(g2, h2, 0.37, kb), reps=5)
        del g2, h2
        b_tot += pack_bound_ms(size, block, kb)[0]
        del g, h
        torch.cuda.empty_cache()
    print(f"[kernels] pack_update qwen2-0.5b round (14 leaves, one worker, "
          f"block {block}, kb {kb}): bitwise=ok kernel_ms={k_tot:.4f} "
          f"bound_ms={b_tot:.4f}")
    k_tot, p_tot, b_tot, by = rounds[256, 16]
    return {"ms": k_tot, "plain_ms": p_tot, "bound_ms": b_tot,
            "bound_by": by, "max_abs_err": max_err, "library_ms": None}


def qsgd_bound_ms(size, s):
    """Least time for one QSGD call: read g, h, u and the norm, write the
    levels and h_out (bytes); or QSGD_OPS f32 operations per value."""
    nbytes = size * (3 * 4 + (1 if s <= 127 else 2) + 4) + 4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = QSGD_OPS * size / H100_ISSUE_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def qsgd_case(name, g, h, u, s, lam=0.37, timing=True):
    """Kernel vs plain version on flat f32 CUDA tensors, both given the
    norm torch computes on the card; returns (kernel ms, plain ms, bound ms,
    max |diff|)."""
    from repro_torch.kernels import pack, ref

    norm = torch.linalg.vector_norm(g - h).reshape(1)
    kl, kh = pack.qsgd_pack_update(g, h, u, norm, lam, s)
    pl, ph = ref.qsgd_pack_update_ref(g, h, u, norm, lam, s)
    torch.cuda.synchronize()
    err = max(max_abs_diff(kl, pl), max_abs_diff(kh, ph))
    if not (same_bits(kl, pl) and same_bits(kh, ph)):
        raise AssertionError(f"[kernels] qsgd {name}: kernel != plain "
                             f"version (max |diff| {err})")
    bound, by = qsgd_bound_ms(g.numel(), s)
    k_ms = p_ms = float("nan")
    if timing:
        k_ms = timed_ms(lambda: pack.qsgd_pack_update(g, h, u, norm, lam, s))
        p_ms = timed_ms(lambda: ref.qsgd_pack_update_ref(g, h, u, norm, lam,
                                                         s))
    nz = int((kl != 0).sum())
    print(f"[kernels] qsgd {name}: size={g.numel()} s={s} bitwise=ok "
          f"nonzero_levels={nz} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"bound_ms={bound:.4f} ({by})")
    return k_ms, p_ms, bound, err


def kernels_qsgd():
    """QSGD quantize-and-pack: edge cases bitwise, then one worker's round
    at the full-width leaf shapes (s = 16), timed."""
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def randn(n):
        return torch.randn(n, generator=gen, device="cuda")

    def rand(n):
        return torch.rand(n, generator=gen, device="cuda")

    max_err = 0.0
    n = 70_001  # ragged: a 16-byte tail of one value
    for s in (16, 7, 400):
        max_err = max(max_err, qsgd_case(f"ragged_s{s}", randn(n), randn(n),
                                         rand(n), s, timing=False)[3])
    h = randn(n)
    max_err = max(max_err, qsgd_case("norm0", h.clone(), h, rand(n), 16,
                                     timing=False)[3])
    g, h = randn(n), randn(n)
    g[::3], h[::3] = -0.0, 0.0
    g[1::5], h[1::5] = -0.0, -0.0
    h[2::7] = -0.0
    max_err = max(max_err, qsgd_case("negzero", g, h, rand(n), 16,
                                     timing=False)[3])
    for s in (16, 400):
        g = randn(n)
        g[n // 2] = float("nan")
        max_err = max(max_err, qsgd_case(f"nan_one_s{s}", g, randn(n),
                                         rand(n), s, timing=False)[3])
        max_err = max(max_err, qsgd_case(
            f"nan_all_s{s}", torch.full((n,), float("nan"), device="cuda"),
            randn(n), rand(n), s, timing=False)[3])
    # views 4 bytes off a 16-byte boundary take the one-value-at-a-time path
    buf = randn(3 * (n + 1))
    max_err = max(max_err, qsgd_case(
        "unaligned", buf[1:n + 1], buf[n + 2:2 * n + 2],
        rand(n), 16, timing=False)[3])

    k_tot = p_tot = b_tot = n_tot = 0.0
    for path, size in full_leaves():
        g, h = randn(size), randn(size)
        k_ms, p_ms, b_ms, err = qsgd_case("qwen2:" + path, g, h, rand(size),
                                          16)
        k_tot, p_tot, b_tot = k_tot + k_ms, p_tot + p_ms, b_tot + b_ms
        # the codec's norm pass before the kernel: writes delta = g - h
        # and reads it back (16 B per value)
        n_tot += timed_ms(lambda: torch.linalg.vector_norm(g - h))
        by = qsgd_bound_ms(size, 16)[1]
        max_err = max(max_err, err)
        del g, h
        torch.cuda.empty_cache()
    n_bytes = 16 * sum(size for _, size in full_leaves())
    print(f"[kernels] qsgd qwen2-0.5b round (14 leaves, one worker, s=16): "
          f"kernel_ms={k_tot:.4f} plain_ms={p_tot:.4f} bound_ms={b_tot:.4f}")
    print(f"[kernels] qsgd norm pass (vector_norm(g - h), 14 leaves, one "
          f"worker): ms={n_tot:.4f} bytes={n_bytes} "
          f"bound_ms={n_bytes / H100_BYTES_PER_S * 1e3:.4f}")
    return {"ms": k_tot, "plain_ms": p_tot, "bound_ms": b_tot,
            "bound_by": by, "max_abs_err": max_err, "library_ms": None}


def randk_bound_ms(size, k):
    """Least time for one rand-k update: read h and write h_out (8 B per
    value), read idx and g at the k positions and write the k values (12 B
    per selected value).  Its 4 f32 operations per selected value and one
    per value are far below that."""
    return (8 * size + 12 * k) / H100_BYTES_PER_S * 1e3, "bytes"


def randk_case(name, g, h, k=None, lam=0.37, idx=None, timing=False):
    """Kernel vs plain version on flat f32 CUDA tensors at k positions
    drawn by ``random.choice`` on the card (or the given ``idx``); returns
    (kernel ms, plain ms, library ms, bound ms, max |diff|)."""
    from repro_torch import random
    from repro_torch.kernels import pack, ref

    size = g.numel()
    if idx is None:
        idx = random.choice(random.fold_in(random.key(7), size), size, k,
                            "cuda")
    k = idx.numel()
    scale = f32(size / k)
    kv, kh = pack.randk_update(g, h, idx, scale, lam)
    pv, ph = ref.randk_update_ref(g, h, idx, scale, lam)
    torch.cuda.synchronize()
    err = max(max_abs_diff(kv, pv), max_abs_diff(kh, ph))
    if not (same_bits(kv, pv) and same_bits(kh, ph)):
        raise AssertionError(f"[kernels] randk {name}: kernel != plain "
                             f"version (max |diff| {err})")
    bound, by = randk_bound_ms(size, k)
    k_ms = p_ms = l_ms = float("nan")
    if timing:
        k_ms = timed_ms(lambda: pack.randk_update(g, h, idx, scale, lam))
        p_ms = timed_ms(lambda: ref.randk_update_ref(g, h, idx, scale, lam))
        idx64 = idx.long()
        l_ms = timed_ms(lambda: torch.index_add(h, 0, idx64, kv, alpha=lam))
    tiles, bucketed = pack.randk_plan(size, k)[:2]
    print(f"[kernels] randk {name}: size={size} k={k} lam={lam} tiles={tiles} "
          f"{'bucketed' if bucketed else 'one launch'} bitwise=ok "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"index_add_ms={l_ms:.4f} bound_ms={bound:.4f} ({by})")
    return k_ms, p_ms, l_ms, bound, err


def randk_device_ms(calls):
    """Device time of the rand-k kernels (torch.profiler), apart from the
    wrapper's host time that the CUDA events around a lone call also see:
    each leaf's call traced alone (a line per leaf), and the round's sum by
    kernel (a line per kernel of the design, the bucketing's memset
    included)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import pack

    by_kernel = {}
    for name, g, h, idx, scale in calls:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pack.randk_update(g, h, idx, scale, 0.37)
            torch.cuda.synchronize()
        try:
            rows = [(e.key, e.count, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and ("randk_" in e.key or "emset" in e.key)]
        except Exception as e:  # reading the trace, not the port
            print(f"[kernels] randk device time: not measured: {e!r}")
            return
        for key, count, ms in rows:
            n, t = by_kernel.get(key, (0, 0.0))
            by_kernel[key] = (n + count, t + ms)
        print(f"[kernels] randk device time {name}: "
              f"{sum(r[2] for r in rows):.4f} ms in "
              f"{sum(r[1] for r in rows)} kernels: "
              + " ".join(f"{re.search(r'randk_[a-z_]+|Memset', k).group(0)}"
                         f"={ms:.4f}" for k, _, ms in rows))
    for key, (count, ms) in by_kernel.items():
        print(f"[kernels] randk round device time: {key[:70]} x{count} "
              f"{ms:.4f} ms")
    print(f"[kernels] randk round device time: "
          f"{sum(t for _, t in by_kernel.values()):.4f} ms in "
          f"{sum(n for n, _ in by_kernel.values())} kernels")


def randk_trap_child():
    """Child process: a rand-k position outside [0, size) must make the
    launch fail.  Exits 3 (skipping teardown in the poisoned context) when
    it did, 0 when it did not."""
    import os
    from repro_torch.kernels import pack

    bad = int(sys.argv[2])
    size = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
    g = torch.zeros(size, device="cuda")
    # at the leaf's size, enough positions to be bucketed
    k = 3 if size == 1000 else size // 8
    idx = torch.arange(3, 3 + k, dtype=torch.int32, device="cuda")
    idx[k // 2] = bad
    try:
        pack.randk_update(g, torch.zeros_like(g), idx, size / k, 0.37)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"[trap] position {bad} size {size}: launch failed: "
              f"{e}".splitlines()[0], flush=True)
        os._exit(3)
    print(f"[trap] position {bad} size {size}: no error", flush=True)
    return 0


def randk_tile_cases(randn, gen):
    """The cases of the one-pass design: (name, g, h, idx) with the
    positions around its tiles of T values (``pack.RANDK_TILE_LOG2``):
    every position in one tile (the worst bucket); every tile edge, the
    leaf's ends and the last, partial tile, both bucketed and in one
    launch; a leaf of exactly one tile and of one tile plus one value; k =
    size on a leaf of several tiles, in one launch and bucketed; the embed
    leaf's size at k = 1; a leaf of more tiles than the histogram counts in
    shared memory (470M values), bucketed with per-tile cursors."""
    from repro_torch.kernels import pack

    tile = 1 << pack.RANDK_TILE_LOG2

    def perm(n):
        return torch.randperm(n, generator=gen, device="cuda")

    def shuffled(pos):
        return pos[perm(pos.numel())].to(torch.int32)

    n = (1 << 22) + 77
    yield "one_tile_holds_all", randn(n), randn(n), shuffled(100 * tile
                                                              + perm(tile))
    n = 40 * tile + 77
    edges = torch.arange(1, 41, device="cuda") * tile
    edges = torch.cat([edges - 1, edges, edges + 1,
                       torch.tensor([0, n - 2], device="cuda")])
    edges = edges[edges < n]
    free = torch.ones(n, dtype=torch.bool, device="cuda")
    free[edges] = False
    rest = free.nonzero().reshape(-1)
    for extra in (30_000, 2_000):
        more = rest[perm(rest.numel())[:extra]]
        yield f"tile_edges_k{extra}", randn(n), randn(n), shuffled(
            torch.cat([edges, more, rest[-5:]]).unique())
    for n in (tile, tile + 1):
        for k in (n // 2, n):
            yield f"size{n}_k{k}", randn(n), randn(n), shuffled(perm(n)[:k])
    for n in (3 * tile + 5, (1 << 20) + 3):
        yield f"k_eq_size{n}", randn(n), randn(n), shuffled(perm(n))
    yield "embed_k1", randn(EMBED_SIZE), randn(EMBED_SIZE), \
        torch.tensor([EMBED_SIZE - 1], dtype=torch.int32, device="cuda")
    # more tiles than a CTA's shared memory counts: per-tile cursors
    n = (pack.RANDK_SMEM_BINS + 1) * tile + 5
    yield "global_cursors", randn(n), randn(n), shuffled(perm(n)[:RANDK_K])


def kernels_randk():
    """rand-k update: edge cases bitwise (and the one-pass design's tile
    cases, ``randk_tile_cases``), an out-of-range position in a child
    process, in one launch and bucketed; then one worker's round at the 14
    full-width leaves (k = 1048576, clamped to the leaf; the embed leaf of
    136,134,656 values among them), timed beside the plain version and
    ``torch.index_add`` (the update given the values; not bit-equal: it adds
    lam * v as an FMA and keeps an unselected -0.0), with the device time of
    each leaf and kernel (``randk_device_ms``)."""
    from repro_torch import random

    gen = torch.Generator(device="cuda").manual_seed(5678)

    def randn(n):
        return torch.randn(n, generator=gen, device="cuda")

    max_err = 0.0
    n = 70_001  # ragged: a 16-byte tail of one value
    for k in (1, n // 2, n):
        max_err = max(max_err, randk_case(f"ragged_k{k}", randn(n), randn(n),
                                          k)[4])
    for lam in (0.37, 0.0, 1.0):
        g, h = randn(n), randn(n)
        idx = random.choice(random.key(int(100 * lam)), n, 20_000, "cuda")
        sel = torch.zeros(n, dtype=torch.bool, device="cuda")
        sel[idx.long()] = True
        on, off = sel.nonzero().reshape(-1), (~sel).nonzero().reshape(-1)
        h[off[::3]] = -0.0          # unselected -0.0 becomes +0.0
        g[off[1::3]], h[off[1::3]] = -0.0, 0.0
        g[on[::5]], h[on[::5]] = -0.0, 0.0
        g[on[1::7]] = float("nan")
        g[on[2::7]] = float("inf")
        g[off[2::7]] = float("nan")
        g[off[3::7]] = -float("inf")
        max_err = max(max_err, randk_case(f"specials_lam{lam}", g, h,
                                          lam=lam, idx=idx)[4])
    # views 4 bytes off a 16-byte boundary take the one-value path
    buf = randn(2 * n + 2)
    max_err = max(max_err, randk_case("unaligned", buf[1:n + 1],
                                      buf[n + 2:], 5000)[4])
    buf = randn(2 * (1 << 20) + 2)
    max_err = max(max_err, randk_case("unaligned_bucketed",
                                      buf[1:(1 << 20) + 1],
                                      buf[(1 << 20) + 2:], 200_000)[4])
    for name, g, h, idx in randk_tile_cases(randn, gen):
        max_err = max(max_err, randk_case(name, g, h, idx=idx)[4])
        del g, h, idx
        torch.cuda.empty_cache()
    # one launch (1000 values) and bucketed (2**22 values)
    for bad, size in ((1000, 1000), (-1, 1000), (1 << 22, 1 << 22),
                      (-5, 1 << 22)):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--randk-trap-child", str(bad), str(size)],
                           capture_output=True, text=True, timeout=300)
        print(r.stdout.strip())
        if r.returncode != 3 or "launch failed" not in r.stdout:
            raise AssertionError(f"[kernels] randk position {bad} of {size}: "
                                 f"launch did not fail (exit "
                                 f"{r.returncode}): {r.stderr[-2000:]}")
    leaves = full_leaves()
    rounds = sum(random.shuffle_rounds(s) for _, s in leaves)
    if len(leaves) != FULL_LEAVES or rounds != SHUFFLE_ROUNDS:
        raise AssertionError(f"[kernels] randk: {len(leaves)} leaves and "
                             f"{rounds} shuffle rounds per worker")
    tot = [0.0] * 4
    calls = []
    for path, size in leaves:
        g, h = randn(size), randn(size)
        idx = random.choice(random.fold_in(random.key(7), size), size,
                            min(RANDK_K, size), "cuda")
        out = randk_case("qwen2:" + path, g, h, idx=idx, timing=True)
        tot = [a + b for a, b in zip(tot, out[:4])]
        max_err = max(max_err, out[4])
        calls.append(("qwen2:" + path, g, h, idx, f32(size / idx.numel())))
    values = sum(size for _, size in leaves)
    print(f"[kernels] randk qwen2-0.5b round ({len(leaves)} leaves, "
          f"{values} values, one worker): kernel_ms={tot[0]:.4f} "
          f"plain_ms={tot[1]:.4f} index_add_ms={tot[2]:.4f} "
          f"bound_ms={tot[3]:.4f}")
    randk_device_ms(calls)
    return {"ms": tot[0], "plain_ms": tot[1], "bound_ms": tot[3],
            "bound_by": "bytes", "max_abs_err": max_err,
            "library_ms": tot[2]}


def kernels_permutation():
    """The shuffle of ``random.permutation`` (threefry draws, then stable
    sorts of them as uint32): GPU against the CPU, bitwise, at 2**20 and
    2**22; timed (CUDA events) with its peak memory at the embed leaf's
    size, and for one worker's 14 leaves (returned, in ms)."""
    from repro_torch import random

    key = random.fold_in(random.key(0), 11)
    for n in (2**20, 2**22):
        gpu = random.permutation(key, n, "cuda")
        cpu = random.permutation(key, n, "cpu")
        if not torch.equal(gpu.cpu(), cpu):
            raise AssertionError(f"[permutation] n={n}: GPU != CPU")
        print(f"[permutation] n={n} rounds={random.shuffle_rounds(n)} "
              "GPU == CPU bitwise")
    _, mem = peak_above(lambda: random.permutation(key, EMBED_SIZE, "cuda"))
    ms = timed_ms(lambda: random.permutation(key, EMBED_SIZE, "cuda"),
                  reps=5)
    print(f"[permutation] n={EMBED_SIZE} (embed) rounds="
          f"{random.shuffle_rounds(EMBED_SIZE)} ms={ms:.4f} "
          f"peak_above_gib={mem:.3f}")
    sizes = [s for _, s in full_leaves()]
    ms = timed_ms(lambda: [random.choice(key, s, min(RANDK_K, s), "cuda")
                           for s in sizes], reps=5)
    print(f"[permutation] one worker's 14 rand-k choices "
          f"({sum(random.shuffle_rounds(s) * s for s in sizes)} sorted "
          f"pairs): ms={ms:.4f}")
    return ms


#: the reference backend's kernels (phase 2, ``kernels_rows``): worker
#: counts (the committed spec's 16, paper Figure 2's 1000) and row widths
#: (the spec's 64, the paper's 112 and 300, and a wide leaf)
ROW_NS = (16, 1000)
ROW_DS = (64, 112, 300, 2**20)
#: the reference-spec phase's own shapes: comp's shuffle draws over k' =
#: d/2 ((16, 32) for the committed spec, (1000, 56) and (1000, 34) for
#: Figure 2 on mushrooms and phishing, (200, 56) for Figure 3) and the
#: worker sums over d = 2k'; beside them worker sums with XLA's window
#: padding (33 rows: 15 in front) and two windowed levels (2000 rows)
MAIN_NS = (16, 200, 1000)
MAIN_MS = (32, 34, 56)
SUM_EXTRA = ((33, 64), (2000, 112))
#: the shapes of the kernels JSON line: Figure 2's round at n = 1000 on
#: mushrooms, its comp-(1, 56) shuffle draw (one round over k' = 56) and
#: its worker sum of (1000, 112) with the master update fused
ROWS_MAIN = (1000, 56)
SUM_MAIN = (1000, 112)


def worker_sum_bound_ms(n, cols, rows_weights, fuse):
    """Least time of one ordered worker sum of (n, cols) f32: read d (and
    the (n,) weights, and h when fused) once and write the sum (or g and
    h_avg'); or its adds or fmas (and the two fmas when fused) at one f32
    instruction per lane and clock."""
    reads = n * cols + (n if rows_weights else 0) + (cols if fuse else 0)
    writes = cols * (2 if fuse else 1)
    ops = n * cols + (2 * cols if fuse else 0)
    t_bytes = 4 * (reads + writes) / H100_BYTES_PER_S
    t_ops = ops / H100_ISSUE_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def rows_cases(ns, ms):
    return {(n, m) for n in ns for m in ms}


def check_threefry_rows(n, m, as_float, dev, keys=None):
    """``threefry_rows`` at (n, m) against its plain version on the card,
    bitwise, and its first and last rows against the 1-D draw; returns
    the max |kernel - plain|."""
    from repro_torch import random
    from repro_torch.kernels import ref, threefry

    if keys is None:
        keys = random.split(random.fold_in(random.key(3), n), n)
    kt = random.key_tensor(keys, dev)
    k = threefry.threefry_rows(kt, m, as_float)
    p = ref.threefry_rows_ref(kt, m, as_float)
    ok = same_bits(k, p) and all(same_bits(
        k[i], threefry.threefry_fill(keys[i], m, dev, as_float))
        for i in (0, n - 1))
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"[kernels] threefry_rows n={n} m={m} "
                             f"as_float={as_float}: kernel != plain")
    return max_abs_diff(k, p)


def sum_weights(n, kind, gen, dev):
    """The weights of a worker sum of kind None, "rows" (a 0/1 mask with
    its last worker out), "scale" (one f32 constant), "mask*scale", or a
    fleet's (n,) scales (10/3 but on every third worker)."""
    mask = (torch.rand(n, generator=gen) < 0.5).float()
    mask[n - 1] = 0.0
    scale = f32(10 / 3)
    return {None: None, "rows": mask.to(dev), "scale": scale,
            "mask*scale": (mask * scale).to(dev),
            "fleet": torch.where(torch.arange(n) % 3 == 1, 1.0,
                                 scale).to(dev)}[kind]


def check_worker_sum(n, cols, kind, order, fuse, gen, dev):
    """``worker_sum`` of (n, cols) with weights of ``kind`` in ``order``
    (fused with the master update or not) against its plain version on
    the card, bitwise, on data with -0.0, inf and a NaN in the last
    worker's row (its mask is 0: 0 * NaN stays NaN); returns the max
    |kernel - plain|."""
    from repro_torch.kernels import ops, ref

    d = torch.randn(n, cols, generator=gen)
    d[0, :3] = torch.tensor([-0.0, float("inf"), -1.5])[:cols]
    d = d.to(dev)
    if kind in ("rows", "mask*scale"):
        d[n - 1, 1 % cols] = float("nan")
    w = sum_weights(n, kind, gen, dev)
    h = torch.randn(cols, generator=gen).to(dev)
    c_g, c_h = f32(0.37 / n), f32(0.011 / n)
    args = (d, w) + ((h, c_g, c_h) if fuse else (None, 0.0, 0.0))
    k = ops.worker_sum(*args, order=order)
    p = ref.worker_sum_ref(*args, order=order)
    k, p = (k, p) if fuse else ((k,), (p,))
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip(k, p)):
        raise AssertionError(f"[kernels] worker_sum n={n} cols={cols} "
                             f"{kind} {order} fuse={fuse}: kernel != plain")
    return max(max_abs_diff(a, b) for a, b in zip(k, p))


#: the worker sums held bitwise at every shape: (weights, order)
SUM_KINDS = ((None, "reduce"), ("rows", "reduce"), ("scale", "reduce"),
             ("mask*scale", "reduce"), ("fleet", "unrolled"),
             ("fleet", "pair"))


def kernels_rows():
    """The reference backend's two kernels, each bitwise against its plain
    version on the card at n in ROW_NS and d in ROW_DS (and the row draw's
    scalar path at m = 1 and 7) and at the reference-spec phase's own
    shapes (MAIN_NS x MAIN_MS and their d = 2k'; SUM_EXTRA), then timed
    beside the plain version, a PyTorch call and the bound: the row draw
    (``threefry_rows``: words and uniforms, each row also equal to the 1-D
    draw under its key) and the ordered worker sum (``worker_sum``: plain,
    under the mask, with a constant scale c, with f32(m * c), and a fleet's
    per-row scales unrolled and with the first pair contracted, each with
    and without the fused master update, in XLA's reduce order: worker
    order up to 32 rows, windows of 32 beyond; -0.0, inf and a NaN row
    that the mask zeroes, which stays NaN).  The JSON line's error is the
    one at ROWS_MAIN and SUM_MAIN.  Then the stable sorts the batched
    compressors stand on, card against CPU and numpy with forced ties:
    ``random.stable_order`` (the shuffle's sort as uint32) and
    ``ref.topk_rows`` (top-k's tie order), and ``random.permutation_rows``
    card against CPU."""
    import numpy as np

    from repro_torch import random
    from repro_torch.kernels import ops, ref, threefry

    dev = torch.device("cuda")
    per_value = sass_per_value("threefry", "threefry_rows_kernel")
    print(f"[kernels] threefry_rows SASS per value: {per_value[0]:.2f} "
          f"instructions, {per_value[1]:.2f} on the integer pipe")
    err_rows = {}
    draws = sorted(rows_cases(ROW_NS, (1, 7) + ROW_DS)
                   | rows_cases(MAIN_NS, MAIN_MS))
    for n, m in draws:
        err_rows[n, m] = max(check_threefry_rows(n, m, f, dev)
                             for f in (False, True))
        torch.cuda.empty_cache()
    print(f"[kernels] threefry_rows (n, m) in {draws}, words and uniforms: "
          "bitwise == plain, rows == the 1-D draw")
    err_sum = {}
    gen = torch.Generator(device="cpu").manual_seed(5)
    sums = sorted(rows_cases(ROW_NS, ROW_DS)
                  | rows_cases(MAIN_NS, [2 * m for m in MAIN_MS])
                  | set(SUM_EXTRA))
    for n, cols in sums:
        err_sum[n, cols] = max(
            check_worker_sum(n, cols, kind, order, fuse, gen, dev)
            for kind, order in SUM_KINDS for fuse in (False, True))
        torch.cuda.empty_cache()
    print(f"[kernels] worker_sum (n, cols) in {sums} (weights and orders "
          f"{SUM_KINDS}, each with and without the fused update): bitwise "
          "== plain; a NaN row under a zero mask stays NaN")
    nan_d = torch.ones(40, 3, device=dev)
    nan_d[39, 1] = float("nan")
    nan_m = torch.ones(40, device=dev)
    nan_m[39] = 0.0
    if not math.isnan(float(ops.worker_sum(nan_d, nan_m)[1])):
        raise AssertionError("[kernels] worker_sum: 0 * NaN under the mask "
                             "is not NaN")
    timing = {}
    for n in ROW_NS:
        for m in sorted(set(ROW_DS + (ROWS_MAIN[1],))):
            kt = random.key_tensor(random.split(random.key(n), n), dev)
            k_ms = timed_ms(lambda: threefry.threefry_rows(kt, m, False))
            p_ms = timed_ms(lambda: ref.threefry_rows_ref(kt, m, False),
                            reps=5)
            l_ms = timed_ms(lambda: torch.rand(n, m, device=dev))
            b_ms, by = threefry_bound_ms(n * m, per_value)
            print(f"[kernels] threefry_rows n={n} m={m}: kernel_ms="
                  f"{k_ms:.4f} plain_ms={p_ms:.4f} torch_rand_ms={l_ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({by})")
            if (n, m) == ROWS_MAIN:
                timing["threefry_rows"] = {
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": by, "max_abs_err": err_rows[ROWS_MAIN],
                    "library_ms": l_ms}
            torch.cuda.empty_cache()
        for cols in sorted(set(ROW_DS + (SUM_MAIN[1],))):
            d = torch.randn(n, cols, device=dev)
            h = torch.randn(cols, device=dev)
            mask = torch.ones(n, device=dev)
            # a plain sum, a masked one, and the main path's: at n = 1000
            # comp-(1, 56)'s messages y * 56 summed plain with the master
            # update fused (at n = 16 the scale 56 contracted, fault u)
            for wname, w, fuse in (("plain", None, False),
                                   ("mask", mask, False),
                                   ("main", None if n > 32 else 56.0,
                                    True)):
                args = (d, w) + ((h, 0.25, 0.5) if fuse else ())
                k_ms = timed_ms(lambda: ops.worker_sum(*args))
                p_ms = timed_ms(lambda: ref.worker_sum_ref(*args), reps=5)
                l_ms = timed_ms(lambda: torch.sum(d, dim=0))
                b_ms, by = worker_sum_bound_ms(
                    n, cols, isinstance(w, torch.Tensor), fuse)
                print(f"[kernels] worker_sum n={n} cols={cols} {wname} "
                      f"fuse={fuse}: kernel_ms={k_ms:.4f} plain_ms="
                      f"{p_ms:.4f} torch_sum_ms={l_ms:.4f} bound_ms="
                      f"{b_ms:.6f} ({by})")
                if (n, cols) == SUM_MAIN and fuse:
                    timing["worker_sum"] = {
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": by, "max_abs_err": err_sum[SUM_MAIN],
                        "library_ms": l_ms}
            del d
            torch.cuda.empty_cache()
    # the sorts the batched compressors stand on, with forced ties
    for n, m, top in ((1000, 56, 4), (1000, 150, 4), (16, 4096, 64),
                      (16, 2**20, 1000)):
        # top distinct keys spread over the uint32 range, both signs
        keys = (torch.randint(0, top, (n, m), generator=gen)
                * (2**32 // top) - 2**31).to(torch.int32)
        want = np.argsort(keys.numpy().view(np.uint32), axis=1,
                          kind="stable")
        got_gpu = random.stable_order(keys.to(dev)).cpu().numpy()
        got_cpu = random.stable_order(keys).numpy()
        mag = torch.randint(0, top, (n, m), generator=gen).float()
        ties_gpu = ref.topk_rows(mag.to(dev), min(m, 64)).cpu()
        ties_cpu = ref.topk_rows(mag, min(m, 64))
        if not (np.array_equal(got_gpu, want) and np.array_equal(got_cpu,
                                                                 want)
                and torch.equal(ties_gpu, ties_cpu)):
            raise AssertionError(f"[kernels] stable sorts ({n}, {m}) with "
                                 "ties: card, CPU and numpy differ")
        print(f"[kernels] stable sorts ({n}, {m}) with {top}-valued ties: "
              "stable_order card == CPU == numpy stable argsort, topk_rows "
              "card == CPU")
    for n, m in ((1000, 56), (1000, 112), (16, 2**20)):
        keys = random.split(random.key(m), n)
        gpu = random.permutation_rows(keys, m, "cuda").cpu()
        cpu = random.permutation_rows(keys, m, "cpu")
        if not torch.equal(gpu, cpu):
            raise AssertionError(f"[kernels] permutation_rows ({n}, {m}): "
                                 "card != CPU")
        print(f"[kernels] permutation_rows ({n}, {m}) rounds="
              f"{random.shuffle_rounds(m)}: card == CPU bitwise")
    return timing


def store_loop_values(body):
    """Values one pass of a grid-stride store loop handles: 4 per 16-byte
    store it holds."""
    return 4 * sum(o.startswith("STG") and ".128" in o for o in body)


def sass_functions(lib, kernel):
    """The SASS of every function of the built library ``lib`` whose name
    holds ``kernel`` (cuobjdump), each as a list of (address, opcode)
    without NOPs."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(build.lib_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    funcs = []
    for f in text.split("Function : ")[1:]:
        if kernel not in f.split(None, 1)[0]:
            continue
        insts = []
        for addr, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", f):
            tokens = ins.split()
            if tokens[0].startswith("@"):
                tokens = tokens[1:]
            if tokens[0] != "NOP":
                insts.append((int(addr, 16), tokens[0], ins))
        funcs.append(insts)
    if not funcs:
        raise AssertionError(f"[kernels] no SASS for {kernel} in {lib}")
    return funcs


def sass_loops(insts):
    """The loops of one function: the opcodes from a backward branch's
    target to the branch."""
    loops = []
    for addr, op, ins in insts:
        target = re.search(r"0x([0-9a-f]+)", ins)
        if op.split(".")[0] != "BRA" or not target \
                or int(target.group(1), 16) >= addr:
            continue
        start = int(target.group(1), 16)
        loops.append((start, addr,
                      [o for a, o, _ in insts if start <= a <= addr]))
    return loops


def sass_per_value(lib, kernel, loop_values=store_loop_values):
    """(instructions, integer-pipe instructions, opcode counts) per value
    in the loop of ``kernel``, read from the SASS of the built library
    ``lib`` (cuobjdump).  A loop is the span of a backward branch;
    ``loop_values`` says how many values one pass of it handles (0 for a
    loop that is not the one sought).  Where the compiler made several
    such loops, the one with the fewest instructions per value is taken, so
    the bound stays a least time."""
    best = None
    for insts in sass_functions(lib, kernel):
        for _, _, body in sass_loops(insts):
            values = loop_values(body)
            if not values:
                continue
            hist = {}
            for o in body:
                hist[o.split(".")[0]] = hist.get(o.split(".")[0], 0) + 1
            ints = sum(c for o, c in hist.items() if o in INT_PIPE)
            if best is None or len(body) / values < best[0]:
                best = (len(body) / values, ints / values,
                        {o: c / values for o, c in hist.items()})
    if best is None:
        raise AssertionError(f"[kernels] no loop of the sought kind in "
                             f"{kernel}'s SASS")
    return best


def search_sass(lib, kernel):
    """(instructions in one step of the threshold search's loop -- the
    loop that holds the row's reduce-add, REDUX --, instructions of the
    function outside every loop, instructions in one iteration of the
    payload's rank loop -- the other loop that reads shared memory, LDS --
    or 0, the step's opcode counts) per thread, from the SASS of the one
    function of ``kernel``."""
    funcs = sass_functions(lib, kernel)
    if len(funcs) != 1:
        raise AssertionError(f"[kernels] {len(funcs)} functions match "
                             f"{kernel}")
    insts = funcs[0]
    loops = sass_loops(insts)
    steps = [b for _, _, b in loops if any(o.startswith("REDUX") for o in b)]
    if not steps:
        raise AssertionError(f"[kernels] no search loop in {kernel}'s SASS")
    # a rank iteration reads one slot: 4 iterations per LDS.128 if the
    # compiler unrolled and widened the loads
    ranks = [len(b) / sum(4 if ".128" in o else 2 if ".64" in o else 1
                          for o in b if o.startswith("LDS"))
             for _, _, b in loops if b not in steps
             and any(o.startswith("LDS") for o in b)]
    inside = {a for start, end, _ in loops for a, _, _ in insts
              if start <= a <= end}
    outside = sum(a not in inside for a, _, _ in insts)
    step = min(steps, key=len)
    hist = {}
    for o in step:
        hist[o.split(".")[0]] = hist.get(o.split(".")[0], 0) + 1
    return len(step), outside, min(ranks, default=0), hist


def search_steps(x2d, kb):
    """The steps of the kernels' threshold search (``block_select.cuh``)
    on each row of f32 x2d, replayed with torch on x2d's device: the keys
    are the bits of |x|; a step counts the keys >= t | 1 << b from bit 30
    down and stops the row when exactly kb are; a NaN row, or kb = block,
    takes none."""
    keys = x2d.abs().view(torch.int32)
    rows, block = keys.shape
    done = (keys > 0x7F800000).any(dim=1) | (kb >= block)
    t = torch.zeros(rows, dtype=torch.int32, device=x2d.device)
    steps = torch.zeros(rows, dtype=torch.int32, device=x2d.device)
    for b in range(30, -1, -1):
        live = ~done
        cand = t | (1 << b)
        c = (keys >= cand[:, None]).sum(dim=1)
        steps += live.int()
        up = live & (c >= kb)
        t = torch.where(up, cand, t)
        done |= up & (c == kb)
    return steps


def selection_sass(leaves, gen):
    """What the selection costs to issue, at every block/kb of
    LEAF_CONFIGS, for each block-top-k kernel: thread instructions per
    value in one step of the threshold search (SASS), the mean steps the
    search takes on the rows of the 14 full-width leaves (random f32 from
    ``gen``: x for block_topk, g - h for the others; replayed by
    ``search_steps``, outside any timed call), and the total per value:
    steps x step + the instructions outside every loop, counted once
    (they include the tie split, which only rows with a tie at T run),
    and, for the pack, its rank loop (ceil(kb / threads) slots of kb
    iterations a thread).  Not a least time for the work: what this design
    issues, against 33.5e12 thread instructions per second."""
    from repro_torch.kernels import ops

    values = sum(size for _, size in leaves)
    for block, kb in LEAF_CONFIGS:
        steps = {}
        for two in (False, True):
            tot = rows = 0
            for _, size in leaves:
                x = torch.randn(size, generator=gen, device="cuda")
                if two:
                    x = x - torch.randn(size, generator=gen, device="cuda")
                st = search_steps(ops.to_rows(x, block), kb)
                tot, rows = tot + int(st.sum()), rows + st.numel()
                del x, st
                torch.cuda.empty_cache()
            steps[two] = tot / rows
        warp = block <= 1024
        for lib, kernel, two in (("block_topk", "block_topk", False),
                                 ("block_topk", "efbv_update", True),
                                 ("pack_update", "pack_update", True)):
            # the f32 instance of each kernel (the CTA variants' first
            # template argument is the values a thread holds)
            cta_per = next(per for per in (16, 8, 4)
                           if block % (32 * per) == 0)
            sym = (f"{kernel}_rowsILi{block}E" if warp
                   else f"{kernel}_ctaILi{cta_per}E") \
                + "f" * (lib == "block_topk")
            per, threads = (block // 32, 32) if warp \
                else (cta_per, block // cta_per)
            step, outside, rank, hist = search_sass(lib, sym)
            total = (step * steps[two] + outside
                     + rank * -(-kb // threads) * kb) / per
            print(f"[kernels] {kernel} block={block} kb={kb}: selection "
                  f"SASS {step / per:.2f} instructions per value and step "
                  f"({step} a thread), mean steps {steps[two]:.3f} on the "
                  f"14 leaves, {outside / per:.2f} per value outside every "
                  f"loop, rank loop {rank:.2f} an iteration; total "
                  f"{total:.2f} per value, issues in "
                  f"{total * values / H100_ISSUE_PER_S * 1e3:.4f} ms over "
                  f"the 14 leaves; a step's opcodes: "
                  + " ".join(f"{o}={c}" for o, c in
                             sorted(hist.items(), key=lambda x: -x[1])))


def threefry_bound_ms(n, per_value):
    """Least time for one draw of n: write 4 n bytes; or issue the loop's
    instructions (``per_value[0]`` each value) at one warp instruction per
    scheduler and clock, and its integer-pipe instructions
    (``per_value[1]``) at 64 per SM and clock."""
    t_bytes = 4 * n / H100_BYTES_PER_S
    t_ops = max(per_value[0] * n / H100_ISSUE_PER_S,
                per_value[1] * n / H100_INT32_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def kernels_threefry():
    """threefry draws: bitwise against the plain int64 version at 2**20
    (words and uniforms) and at the embed leaf's size; then one worker's
    round of uniform draws at the full-width leaf sizes, timed beside the
    plain version and torch.rand (not bit-equal: another generator)."""
    from repro_torch import random
    from repro_torch.kernels import ref, threefry

    dev = torch.device("cuda")
    key = random.fold_in(random.fold_in(random.key(0), 1), 13)
    per_value = sass_per_value("threefry", "threefry_fill_kernel")
    print(f"[kernels] threefry SASS per value: {per_value[0]:.2f} "
          f"instructions, {per_value[1]:.2f} on the integer pipe; "
          + " ".join(f"{o}={c:.2f}" for o, c in
                     sorted(per_value[2].items(), key=lambda x: -x[1])))
    max_err = 0.0
    for n, as_float in ((1, True), (7, True), (2**20, False), (2**20, True),
                        (EMBED_SIZE, True)):
        k = threefry.threefry_fill(key, n, dev, as_float)
        p = ref.threefry_ref(key, n, dev, as_float)
        torch.cuda.synchronize()
        if not same_bits(k, p):
            raise AssertionError(f"[kernels] threefry n={n} "
                                 f"as_float={as_float}: kernel != plain")
        max_err = max(max_err, max_abs_diff(k, p))
        print(f"[kernels] threefry n={n} as_float={as_float} bitwise=ok")
        del k, p
        torch.cuda.empty_cache()
    k_tot = p_tot = l_tot = b_tot = 0.0
    for path, size in full_leaves():
        k_ms = timed_ms(lambda: threefry.threefry_fill(key, size, dev, True))
        p_ms = timed_ms(lambda: ref.threefry_ref(key, size, dev, True),
                        reps=5)
        l_ms = timed_ms(lambda: torch.rand(size, device=dev))
        b_ms, by = threefry_bound_ms(size, per_value)
        print(f"[kernels] threefry qwen2:{path}: size={size} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"torch_rand_ms={l_ms:.4f} bound_ms={b_ms:.4f} ({by})")
        k_tot, p_tot, l_tot, b_tot = (k_tot + k_ms, p_tot + p_ms,
                                      l_tot + l_ms, b_tot + b_ms)
        torch.cuda.empty_cache()
    print(f"[kernels] threefry qwen2-0.5b round (14 leaves, one worker's "
          f"uniforms): kernel_ms={k_tot:.4f} plain_ms={p_tot:.4f} "
          f"torch_rand_ms={l_tot:.4f} bound_ms={b_tot:.4f}")
    return {"ms": k_tot, "plain_ms": p_tot, "bound_ms": b_tot,
            "bound_by": by, "max_abs_err": max_err, "library_ms": l_tot}


def dense_case(kernel, name, g, h, block, kb, lam=0.37, timing=False,
               quiet=False):
    """``block_topk`` of g, or ``efbv_update`` of (g, h): the kernel
    against its plain version on the card, bitwise, through the ops
    wrappers' padding and casts (h is rounded to g's type first, and h'
    converted back).  Returns (kernel ms, plain ms, bound ms, bound by,
    max |diff|)."""
    from repro_torch.kernels import ops, pack, ref

    gp = ops.to_rows(g, block)
    if kernel == "block_topk":
        def run_kernel():
            return (pack.block_topk(gp, kb),)

        def run_plain():
            return (ref.block_topk_ref(gp, kb),)
    else:
        hp = ops.to_rows(h.to(g.dtype), block)

        def run_kernel():
            d, h_out = pack.efbv_update(gp, hp, lam, kb)
            return d, h_out.to(h.dtype)

        def run_plain():
            d, h_out = ref.efbv_update_ref(gp, hp, lam, kb)
            return d, h_out.to(h.dtype)
    got, want = run_kernel(), run_plain()
    torch.cuda.synchronize()
    err = max(max_abs_diff(a.float(), b.float()) for a, b in zip(got, want))
    if not all(same_bits(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"[kernels] {kernel} {name}: kernel != plain "
                             f"version (max |diff| {err})")
    bound, by = ops.dense_bound_ms(kernel, g.numel(), g.element_size())
    k_ms = p_ms = float("nan")
    if timing:
        k_ms = timed_ms(run_kernel)
        p_ms = timed_ms(run_plain, reps=5)
    if not quiet:
        print(f"[kernels] {kernel} {name}: size={g.numel()} block={block} "
              f"kb={kb} {g.dtype}/{(h if h is not None else g).dtype} "
              f"bitwise=ok kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
    return k_ms, p_ms, bound, by, err


def kernels_dense():
    """The dense block-top-k and the fused dense update: edge cases bitwise
    in f32 and bf16 (ties and specials at 8192 too); every block 128..4096
    at kb 1/2/3/16/64/block and BIG_BLOCKS at big_kbs in f32 and bf16; a
    leaf below its block; a block % 128 != 0 raises; the 14 full-width
    leaf shapes at every block/kb of LEAF_CONFIGS bitwise in f32 (and in
    bf16 at 256/16); one worker's round timed in f32 at 256/16 (the kernels
    JSON line), 4096/64 and BIG_LEAF_CONFIG.  Then the selection's cost
    from the SASS (``selection_sass``)."""
    from repro_torch.kernels import ops, pack

    gen = torch.Generator(device="cuda").manual_seed(2468)

    def randn(n, dtype=torch.float32):
        return torch.randn(n, generator=gen, device="cuda").to(dtype)

    bf16 = torch.bfloat16
    err = 0.0

    def both(name, g, h, block, kb, quiet=False):
        nonlocal err
        for kernel in ("block_topk", "efbv_update"):
            err = max(err, dense_case(kernel, name, g, h, block, kb,
                                      quiet=quiet)[4])

    for dtype in (torch.float32, bf16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for block in SWEEP_BLOCKS:
            n = sweep_rows(block)
            g, h = randn(n, dtype), randn(n, dtype)
            for kb in SWEEP_KB + (block,):
                both(f"sweep_b{block}_kb{kb}_{tag}", g, h, block, kb, True)
            print(f"[kernels] block_topk/efbv_update sweep {tag} "
                  f"block={block}: kb {SWEEP_KB + (block,)} bitwise=ok "
                  f"({n} values)")
        for block in BIG_BLOCKS:
            n = big_rows(block)
            g, h = randn(n, dtype), randn(n, dtype)
            for kb in big_kbs(block):
                both(f"sweep_b{block}_kb{kb}_{tag}", g, h, block, kb, True)
            print(f"[kernels] block_topk/efbv_update sweep {tag} "
                  f"block={block}: kb {big_kbs(block)} bitwise=ok "
                  f"({n} values)")
        for kb in (1, 64, 8192):
            both(f"one_padded_row_kb{kb}_{tag}", randn(5000, dtype),
                 randn(5000, dtype), 8192, kb)
        n = 1024 * 4096
        for kb in (1, 2, 16, 64):
            both(f"block1024_kb{kb}_{tag}", randn(n, dtype), randn(n, dtype),
                 1024, kb)
        n = 256 * 4096 + 3
        both(f"block256_kb1_{tag}", randn(n, dtype), randn(n, dtype), 256, 1)
        for block in (128, 1024, 4096):
            n = block * 513
            both(f"kb_eq_block{block}_{tag}", randn(n, dtype),
                 randn(n, dtype), block, block)
        # ties: integers in [-3, 3]; every 7th row of g - h all zero; -0.0
        for block in (256, 1152, 4096, 8192):
            n = block * 1024
            gi = torch.randint(-3, 4, (n,), generator=gen,
                               device="cuda").float()
            hi = torch.randint(-3, 4, (n,), generator=gen,
                               device="cuda").float()
            gi.view(-1, block)[::7] = hi.view(-1, block)[::7]
            gi[(gi == 0) & (torch.arange(n, device="cuda") % 3 == 0)] = -0.0
            for kb in (1, 16, 64):
                both(f"ties_b{block}_kb{kb}_{tag}", gi.to(dtype),
                     hi.to(dtype), block, kb)
        # specials: a NaN row, a row with one NaN, +-inf (more than kb of
        # them in row 4), -0.0, an inf in h
        for block in (256, 2048, 8192):
            n = block * 64
            gs, hs = randn(n), randn(n)
            gs[:block] = float("nan")
            gs[3 * block + 100] = float("nan")
            gs[4 * block + 10:4 * block + 30:2] = float("inf")
            gs[4 * block + 11:4 * block + 31:2] = -float("inf")
            gs[6 * block + 5] = -0.0
            hs[7 * block + 9] = float("inf")
            for kb in (1, 2, 3, 16):
                both(f"specials_b{block}_kb{kb}_{tag}", gs.to(dtype),
                     hs.to(dtype), block, kb)
    # mixed types (the wrapper rounds h to g's type, JAX's fault h)
    n = 256 * 4096
    for kb in (1, 16):
        err = max(err, dense_case("efbv_update", f"mixed_bf16_f32_kb{kb}",
                                  randn(n, bf16), randn(n), 256, kb)[4])
        err = max(err, dense_case("efbv_update", f"mixed_f32_bf16_kb{kb}",
                                  randn(n), randn(n, bf16), 256, kb)[4])
    # exactly one unreshaped (8, block) f32 tile at kb = 1: the wrapper asks
    # for one rounding of h' (ROADMAP fault m); the kernel equals its plain
    # version there, and the same values given flat round twice
    for block in (128, 1024, 8192):
        g, h = randn(8 * block).view(8, block), randn(8 * block).view(8, block)
        got = ops.efbv_update(g, h, 0.37, block=block, kb=1)
        want = ops.efbv_update(g.cpu(), h.cpu(), 0.37, block=block, kb=1)
        flat = ops.efbv_update(g.reshape(-1), h.reshape(-1), 0.37,
                               block=block, kb=1)[1].view(8, block)
        fma = torch.add(h, got[0], alpha=0.37)
        ok = all(same_bits(a.cpu(), b) for a, b in zip(got, want)) and \
            same_bits(got[1], fma)
        twice = int((got[1] != flat).sum())
        print(f"[kernels] efbv_update one (8, {block}) f32 tile kb=1: kernel "
              f"{'==' if ok else '!='} plain version, h' one fused rounding; "
              f"{twice} of {8 * block} values differ from the flat input's "
              "two roundings")
        if not ok:
            raise AssertionError(f"[kernels] efbv_update one tile {block}: "
                                 "kernel != plain version")
    # a block % 128 != 0 raises on the card
    try:
        ops.block_topk(randn(400), block=100, kb=4)
    except ValueError as e:
        print(f"[kernels] block_topk block=100 raises on the card: {e}")
    else:
        raise AssertionError("[kernels] block_topk block=100 ran")

    # the 14 full-width leaves at every block/kb, f32, bitwise (bf16 too at
    # 256/16); timed in f32 at TIMED_CONFIGS
    leaves = full_leaves()
    rows = {}
    for block, kb in LEAF_CONFIGS:
        timing = (block, kb) in TIMED_CONFIGS
        dtypes = (bf16, torch.float32) if (block, kb) == (256, 16) \
            else (torch.float32,)
        for kernel in ("block_topk", "efbv_update"):
            tot = [0.0, 0.0, 0.0]
            for path, size in leaves:
                for dtype in dtypes:
                    g, h = randn(size, dtype), randn(size, dtype)
                    out = dense_case(kernel, f"qwen2:{path}", g, h, block,
                                     kb, timing=timing and dtype != bf16,
                                     quiet=not timing)
                    err = max(err, out[4])
                    del g, h
                    torch.cuda.empty_cache()
                tot = [a + b for a, b in zip(tot, out[:3])]
                by = out[3]
            print(f"[kernels] {kernel} qwen2-0.5b round (14 leaves, f32, "
                  f"block {block}, kb {kb}): bitwise=ok"
                  + (f" kernel_ms={tot[0]:.4f} plain_ms={tot[1]:.4f} "
                     f"bound_ms={tot[2]:.4f} ({by})" if timing else ""))
            if (block, kb) == (256, 16):
                # no single PyTorch call computes a block-top-k with JAX's
                # tie order
                rows[kernel] = {"ms": tot[0], "plain_ms": tot[1],
                                "bound_ms": tot[2], "bound_by": by,
                                "max_abs_err": err, "library_ms": None}
    block, kb = BIG_LEAF_CONFIG
    for kernel in ("block_topk", "efbv_update"):
        k_tot = b_tot = 0.0
        for path, size in leaves:
            g, h = randn(size), randn(size)
            out = dense_case(kernel, f"qwen2:{path}", g, h, block, kb,
                             quiet=True)
            err = max(err, out[4])
            gp, hp = ops.to_rows(g, block), ops.to_rows(h, block)
            run = (lambda: pack.block_topk(gp, kb)) if kernel == "block_topk" \
                else (lambda: pack.efbv_update(gp, hp, 0.37, kb))
            k_tot += timed_ms(run, reps=5)
            b_tot += out[2]
            del g, h, gp, hp
            torch.cuda.empty_cache()
        print(f"[kernels] {kernel} qwen2-0.5b round (14 leaves, f32, block "
              f"{block}, kb {kb}): bitwise=ok kernel_ms={k_tot:.4f} "
              f"bound_ms={b_tot:.4f}")
    for row in rows.values():
        row["max_abs_err"] = err
    selection_sass(leaves, gen)
    return rows


#: the smoke reference's uplink compressor of each path; QSGD and the
#: pipelined path have a QSGD(16) downlink.  Block-top-k also at 384/16
#: (a warp per row) and 4096/64 (a CTA per row; the JAX perf_iter and dry
#: run's default), both blocks that JAX's trainer runs.
SMOKE_SPECS = {"block_topk": "block_topk:256,16",
               "block_topk_384": "block_topk:384,16",
               "block_topk_4096": "block_topk:4096,64", "qsgd": "qsgd:16",
               "randk": "randk:4096", "pipelined": "block_topk:256,16"}


def run_steps(params, cfg, kind, steps=3, n=2, agg="sparse_allgather",
              participation="full", group=None):
    """``steps`` n-worker EF-BV steps from ``params``: block-top-k
    (256/16, 384/16 or 4096/64) up, QSGD(16) up and down, rand-k (k =
    4096) up, or the pipelined (depth 1) schedule with block-top-k up and
    QSGD(16) down; ``agg`` and ``participation`` as the driver's flags; on
    this rank's workers of ``group`` (None: all n in this process).  Step s
    runs under the key fold_in(key(0), s).  Returns (losses, state)."""
    from repro_torch import random
    from repro_torch.core.compressors import QSGD, make_compressor
    from repro_torch.core.efbv import EFBV, Downlink, Participation, Pipeline
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine
    from repro_torch.train.trainer import init_train_state, make_train_step

    model = build_model(cfg)
    opt = adamw(cosine(3e-4, total_steps=steps, warmup_steps=1),
                weight_decay=0.01)
    qsgd = kind in ("qsgd", "pipelined")
    pipeline = Pipeline(1) if kind == "pipelined" else None
    algo = EFBV.make(make_compressor(SMOKE_SPECS[kind]),
                     d=cfg.d_model * cfg.d_ff, n=n,
                     pipeline=pipeline and pipeline.depth)
    state = init_train_state(params, opt, n_workers=n, bidirectional=qsgd,
                             algo=algo, agg_mode=agg, pipeline=pipeline,
                             group=group)
    step_fn = make_train_step(model.loss, opt, algo, n_workers=n,
                              agg_mode=agg,
                              downlink=Downlink(QSGD(16)) if qsgd else None,
                              pipeline=pipeline,
                              participation=Participation.parse(
                                  participation), group=group)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8,
                       n_workers=n, seed=0)
    key = random.key(0)
    losses = []
    for s in range(steps):
        state, m = step_fn(state, data.batch(s), random.fold_in(key, s))
        losses.append(float(m["loss"]))
    return losses, state


def init_on_card(cfg, params):
    """JAX's initial weights (``Model.init(random.key(0))``, XLA's f32
    erf_inv emulated with f64 fused multiply-adds) drawn on the card equal
    the CPU's bit for bit, and so does a 2**22-value ``random.normal``."""
    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.models.model import build_model

    card = build_model(cfg).init(random.key(0), device="cuda")
    bad = [i for i, (a, b) in enumerate(zip(T.leaves(card), T.leaves(params)))
           if not same_bits(a.cpu(), b)]
    n = 1 << 22
    draw_same = same_bits(random.normal(random.key(3), n, "cuda").cpu(),
                          random.normal(random.key(3), n, "cpu"))
    print(f"[reference] init: smoke params from random.key(0) on the card "
          f"{'bitwise equal to' if not bad else 'NOT equal to'} the CPU's "
          f"({len(T.leaves(card))} leaves); normal of {n} values card == "
          f"cpu: {draw_same}")
    if bad or not draw_same:
        raise AssertionError(f"[reference] init differs on leaves {bad}, "
                             f"normal draw equal={draw_same}")


def phase_reference():
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch import tree as T

    cfg, params = smoke_params()
    init_on_card(cfg, params)
    for kind, spec in SMOKE_SPECS.items():
        name = spec + {"qsgd": " up and down",
                       "pipelined": " up, qsgd:16 down, depth:1"}.get(kind,
                                                                     "")
        cpu = run_steps(params, cfg, kind)[0]
        reset_launches()
        gpu = run_steps(T.tree_map(lambda p: p.cuda(), params), cfg,
                        kind)[0]
        packs = LAUNCHES["pack_update"]
        print(f"[reference] {name}: smoke f32 losses cpu={cpu} gpu={gpu} "
              f"pack_update launches={packs}")
        # every leaf of both workers in each of 3 steps goes through the
        # pack kernel (block % 128 == 0)
        if kind.startswith("block_topk") and packs != 3 * 2 * FULL_LEAVES:
            raise AssertionError(f"[reference] {name}: {packs} pack "
                                 "launches")
        for a, b in zip(cpu, gpu):
            # f32 matmuls sum in another order on the card, and so do the
            # QSGD norms; a block-top-k near-tie or a QSGD level can then
            # round the other way (rand-k's positions are bit-equal), so
            # 1e-3 relative
            if not (math.isfinite(b) and abs(a - b) <= 1e-3 * abs(a)):
                raise AssertionError(f"[reference] {name}: GPU loss {b} vs "
                                     f"CPU {a}")


#: the zoo phase: the rest of the trainer's wire at smoke size, as spec
#: fields over block-top-k up on the sparse all-gather: the eight uplinks
#: that PR 12-21's paths do not run, a top-k and a block-top-k downlink, a
#: mixed fleet (dense_psum) and the bf16 and f16 wires
ZOO_CASES = {
    "topk": {"compressor": "topk:64"},
    "scaled_randk": {"compressor": "scaled_randk:64"},
    "comp": {"compressor": "comp:64,256"},
    "mix": {"compressor": "mix:32,32"},
    "sign": {"compressor": "sign"},
    "natural": {"compressor": "natural"},
    "frac_topk": {"compressor": "frac_topk:50"},
    "frac_comp": {"compressor": "frac_comp:10,200"},
    "down_topk": {"downlink": "topk:64"},
    "down_block_topk": {"downlink": "block_topk:256,16"},
    "fleet": {"compressor": "topk:64;randk:64", "agg": "dense_psum"},
    "wire_bf16": {"wire_dtype": "bfloat16"},
    "wire_f16": {"wire_dtype": "float16"},
}
ZOO_STEPS = 2


def zoo_steps(spec, cfg, params):
    """``ZOO_STEPS`` steps of ``build(spec)``'s trainer from ``params`` (on
    their device), the batches of ``SyntheticLM`` seed 0 and the step keys
    fold_in(key(0), s).  Returns (losses, final params)."""
    from repro_torch import random
    from repro_torch.core import build
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine

    run_ = build(spec)
    opt = adamw(cosine(3e-4, total_steps=ZOO_STEPS, warmup_steps=0),
                weight_decay=0.01)
    state = run_.init_state(params, opt)
    step_fn = run_.train_step(build_model(cfg).loss, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8,
                       n_workers=spec.n, seed=0)
    losses = []
    for s in range(ZOO_STEPS):
        state, m = step_fn(state, data.batch(s), random.fold_in(
            random.key(0), s))
        losses.append(float(m["loss"]))
    return losses, state.params


def phase_zoo():
    """Every ``ZOO_CASES`` entry for ``ZOO_STEPS`` smoke steps on the card
    (kernel path) and on the CPU (plain path) from the same init, batches
    and keys: its exact bits (``Run.round_bits`` on the smoke tree), and
    the card held to the CPU with the CPU tests' loss tolerance against JAX
    (f32 activations, 1e-5 relative).  The params must stay within AdamW's
    bound, 2.02 x the sum of lr_t (as ``mesh_params_check``): f32 matmuls
    sum in another order on the card, and a selection by magnitude can
    then take the other value of a near-tie -- for comp-(k, k') the rank
    order of the top k' that its random draw indexes -- which AdamW turns
    into a move of about lr; the share of params more than 1e-5 apart is
    printed."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.core import ExperimentSpec, build

    from repro_torch.optim.schedules import cosine

    cfg, params = smoke_params()
    sched = cosine(3e-4, total_steps=ZOO_STEPS, warmup_steps=0)
    bound = 2.02 * sum(sched(t) for t in range(ZOO_STEPS))
    base = ExperimentSpec(compressor="block_topk:256,16",
                          agg="sparse_allgather", backend="shard_map",
                          problem="qwen2-0.5b", smoke=True, mesh="2x1", n=2,
                          d=cfg.d_model * cfg.d_ff, steps=ZOO_STEPS)
    t0 = time.perf_counter()
    for name, fields in ZOO_CASES.items():
        spec = dataclasses.replace(base, **fields)
        bits = build(spec).round_bits(params)
        cpu, pc = zoo_steps(spec, cfg, params)
        gpu, pg = zoo_steps(spec, cfg, T.tree_map(lambda p: p.cuda(),
                                                  params))
        loss_err = max(abs(a - b) / abs(a) for a, b in zip(cpu, gpu))
        diff = torch.cat([(b.cpu() - a).abs().reshape(-1)
                          for a, b in zip(T.leaves(pc), T.leaves(pg))])
        share = float((diff > 1e-5).float().mean())
        worst = float(diff.max())
        print(f"[zoo] {name} {fields}: bits up={bits['up']} "
              f"down={bits['down']} total={bits['total']}; losses cpu={cpu} "
              f"gpu={gpu} max rel diff {loss_err:.3e} (limit 1e-5); params "
              f"max |diff| {worst:.3e} (bound {bound:.3e}), share > 1e-5 "
              f"{share:.5f}")
        if not (all(map(math.isfinite, gpu)) and loss_err <= 1e-5
                and worst <= bound):
            raise AssertionError(f"[zoo] {name}: card vs CPU beyond the "
                                 "CPU tests' tolerance")
    print(f"[zoo] {len(ZOO_CASES)} cases in "
          f"{time.perf_counter() - t0:.1f} s")


#: the reference backend's committed spec (phase 3b, case a)
REFERENCE_SPEC = ROOT / "examples" / "specs" / "reference_logreg_efbv.json"
#: paper Figure 2's scale through the spec (case c): logreg at the
#: mushrooms width, n = 1000, comp-(1, d/2), EF-BV and EF21
FIG2 = dict(problem="logreg", d=112, n=1000, compressor="comp:1,56",
            steps=100, seed=0)
#: rows a worker holds in case (c), as the paper's mushrooms data (8124
#: rows) spreads over n = 1000 (the spec's own problem has N = 16 d, one
#: row a worker at this n)
FIG2_ROWS = 8
#: threefry launches of one built-in logreg problem: the column-scale and
#: flip uniforms and the two normal draws
PROBLEM_DRAWS = 4
#: rounds of one profiled reference run at n = 1000 (case c), and the
#: most launches and host-to-device copies it may make a round (measured
#: 44.8 and 1.0 on an H100)
PROFILE_ROUNDS = 5
PROFILE_MAX_LAUNCHES = 64
PROFILE_MAX_COPIES = 2


def reference_case(run, device, prob=None, grad_fn=None, gamma=None):
    """``run.reference()`` on ``device`` with only its rounds timed.  With
    no ``grad_fn`` the problem (the spec's built-in one unless ``prob`` is
    given) is drawn, f* solved and Remark 1's stepsize tuned from its L and
    L_tilde before the timer, as ``reference()`` would tune it, and f(x) -
    f* is recorded; a custom ``grad_fn`` comes with ``gamma``.  Returns
    (ReferenceRun, ms per round between synchronisations, the problem,
    f*)."""
    f_star = record = None
    if grad_fn is None:
        prob = run.problem_instance(device) if prob is None else prob
        f_star = prob.solve()[1]
        gamma = run._tune(L=prob.L(), Ltilde=prob.L_tilde()).gamma
        grad_fn = prob.grads

        def record(x):
            return prob.f(x) - f_star
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run.reference(grad_fn=grad_fn, gamma=gamma, record=record,
                        device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / run.spec.steps
    return res, ms, prob, f_star


def _bits_equal(a, b):
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def round_launches(comp, rounds):
    """Launches of ``rounds`` reference rounds of a comp-(k, k') run on one
    f32 leaf: each round one row draw per shuffle round over k' (for all
    n workers at once) and one ordered worker sum with the master update
    fused; none of it depends on n."""
    from repro_torch import random

    return {"threefry_rows": rounds * random.shuffle_rounds(comp.kp),
            "worker_sum": rounds}


def add_launches(want, more):
    for k, v in more.items():
        want[k] = want.get(k, 0) + v


def gaps_descend(curve):
    """Every value finite, the last below the first."""
    c = [float(v) for v in curve]
    return all(math.isfinite(v) for v in c) and c[-1] < c[0]


def profile_reference_round(frun, fprob, gamma, f_star):
    """One reference run of PROFILE_ROUNDS rounds at n = 1000 under
    torch.profiler: per round the kernels launched, the host-to-device
    copies, the device kernel time and the host time; and the host's
    operators by self CPU time (what the host still does).  Fails unless
    the trace shows launches, and at most PROFILE_MAX_LAUNCHES launches
    and PROFILE_MAX_COPIES host-to-device copies a round (a loop over the
    1000 workers would launch at least 1000)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import build

    run = build(dataclasses.replace(frun.spec, steps=PROFILE_ROUNDS))
    kw = dict(grad_fn=fprob.grads, gamma=gamma, device="cuda",
              record=lambda x: fprob.f(x) - f_star)
    run.reference(**kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run.reference(**kw)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / PROFILE_ROUNDS
    ev = prof.key_averages()
    dev_rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in ev
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    copies = sum(e.count for e in ev if "HtoD" in e.key)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in ev if e.device_type !=
                   torch.autograd.DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in dev_rows)
    print(f"[reference-spec] (c) profile {run.spec.mode}, {PROFILE_ROUNDS} "
          f"rounds at n={run.spec.n}: per round {launches / PROFILE_ROUNDS:.1f}"
          f" kernel launches, {copies / PROFILE_ROUNDS:.1f} host-to-device "
          f"copies, device kernel ms {busy / PROFILE_ROUNDS:.4f}, traced "
          f"wall ms {wall:.3f} (profiler overhead included)")
    for t, count, key in sorted(dev_rows, reverse=True)[:10]:
        print(f"[reference-spec] (c) profile device {t:8.4f} ms x{count:<4d}"
              f" {key[:80]}")
    for t, count, key in host[:15]:
        print(f"[reference-spec] (c) profile host {t:8.3f} ms x{count:<4d} "
              f"{key[:80]}")
    if not (0 < launches <= PROFILE_MAX_LAUNCHES * PROFILE_ROUNDS
            and copies <= PROFILE_MAX_COPIES * PROFILE_ROUNDS):
        raise AssertionError(
            f"[reference-spec] (c) profile: {launches} launches and {copies}"
            f" host-to-device copies in {PROFILE_ROUNDS} rounds, want "
            f"some launches and at most {PROFILE_MAX_LAUNCHES} and "
            f"{PROFILE_MAX_COPIES} a round")


def recording_kernel_shapes():
    """Wrap the row draw's and the worker sum's wrappers so that every call
    on the card notes its shape (and as_float; weights, order, fusion).
    Returns (the notes, a function that restores the wrappers)."""
    from repro_torch.kernels import ops, threefry

    seen = {"threefry_rows": set(), "worker_sum": set()}
    rows, wsum = threefry.threefry_rows, ops.worker_sum

    def rows_noted(keys, m, as_float):
        if keys.is_cuda:
            seen["threefry_rows"].add((keys.shape[0], m, bool(as_float)))
        return rows(keys, m, as_float)

    def sum_noted(d, weights=None, h=None, c_g=0.0, c_h=0.0,
                  order="reduce"):
        if d.is_cuda:
            kind = (None if weights is None
                    else "scale" if not isinstance(weights, torch.Tensor)
                    else "rows" if order == "reduce" else "fleet")
            seen["worker_sum"].add((d.shape[0], d[0].numel(), kind, order,
                                    h is not None))
        return wsum(d, weights, h, c_g, c_h, order)

    def restore():
        threefry.threefry_rows, ops.worker_sum = rows, wsum

    threefry.threefry_rows, ops.worker_sum = rows_noted, sum_noted
    return seen, restore


def check_main_shapes(seen):
    """Each (shape, form) the main path gave the two reference kernels,
    held bitwise against its plain version on the card on fresh data of
    that shape (after the launch counts are read)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(7)
    for n, m, as_float in sorted(seen["threefry_rows"]):
        check_threefry_rows(n, m, as_float, dev)
    for n, cols, kind, order, fuse in sorted(seen["worker_sum"], key=str):
        check_worker_sum(n, cols, kind, order, fuse, gen, dev)
    torch.cuda.empty_cache()
    print(f"[reference-spec] the main path's own shapes, each bitwise == "
          f"plain on the card: threefry_rows (n, m, as_float) "
          f"{sorted(seen['threefry_rows'])}; worker_sum (n, cols, weights, "
          f"order, fused) {sorted(seen['worker_sum'], key=str)}")
    if not (seen["threefry_rows"] and seen["worker_sum"]):
        raise AssertionError("[reference-spec] the main path gave a "
                             f"reference kernel no call: {seen}")


def paper_runs(want):
    """(d) the paper's experiments at their fast setting on the card
    (``paper_torch``): Table 3's five rows, each ``matches_paper=True``;
    Figure 2 (mushrooms and phishing, k = 1, xi = 1, n = 1000, 1500 rounds
    of EF-BV and of EF21) and Figure 3 (mushrooms, nonconvex, n = 200, 1200
    rounds of each): every row printed, every trajectory finite with its
    last value below its first, the seconds each took.  Adds the launches
    they make to ``want``."""
    from paper_torch import common, paper_fig2, paper_fig3, paper_tab3
    from repro_torch import random
    from repro_torch.core import CompKK

    rows = paper_tab3.run()
    for r in rows:
        print(f"[paper] {r['name']},{r['us_per_call']},{r['derived']}")
    if len(rows) != 5 or not all(r["derived"].endswith("matches_paper=True")
                                 for r in rows):
        raise AssertionError("[paper] tab3: a row does not match the paper")
    problem = PROBLEM_DRAWS + random.shuffle_rounds(
        common.DATASETS["mushrooms"]["N"])
    for script, run, steps, names in (
            ("fig2", lambda: paper_fig2.run(fast=True, device="cuda"), 1500,
             ("mushrooms", "phishing")),
            ("fig3", lambda: paper_fig3.run_bench(fast=True, device="cuda"),
             1200, ("mushrooms",))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, curves = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for r in rows:
            print(f"[paper] {r['name']},{r['us_per_call']},{r['derived']}")
        for key, c in curves.items():
            print(f"[paper] {script} {key}: {len(c)} rounds, value after "
                  f"rounds 1/100/{len(c)}: {float(c[0])!r} / "
                  f"{float(c[99])!r} / {float(c[-1])!r}")
            if len(c) != steps or not gaps_descend(c):
                raise AssertionError(f"[paper] {script} {key}: not finite "
                                     "and descending")
        print(f"[paper] {script} fast: {len(curves)} runs of {steps} rounds "
              f"in {secs:.2f} s on the card (problems drawn and f* solved "
              f"included), {secs * 1e3 / (len(curves) * steps):.3f} ms a "
              "round on average")
        for name in names:
            d = common.DATASETS[name]["d"]
            add_launches(want, {"threefry_uniform": problem})
            add_launches(want, round_launches(CompKK(1, d // 2), 2 * steps))
def phase_reference_spec():
    """The reference backend through the spec (``repro_torch.core.build``):
    (a) the committed ``reference_logreg_efbv.json`` verbatim (500 rounds,
    n = 16, d = 64, comp-(2, 32), auto-tuned), on the card and on the CPU,
    each drawing its own problem: ms per round, f(x) - f* at rounds 0, 100
    and 500, the two trajectories within 1e-5 of the CPU's gap at every
    round (the normals behind A come from each device's erfinv, so A
    agrees to ~1e-6; measured 1.35e-6 on an H100); (b) the same spec with
    the exact elementwise gradient x - B_i (B from numpy): x, h and h_avg
    bitwise, card against CPU; (c) a round at paper Figure 2's scale
    (FIG2 with FIG2_ROWS rows a worker), EF-BV and EF21, 100 rounds each
    on the card and on the CPU on the card's data: ms per round, the two
    gap trajectories within 1e-5 relative, both descending; and one short
    run profiled (``profile_reference_round``); (d) the paper's
    experiments at their fast setting (``paper_runs``).  The workers run
    batched, so a round's launches do not grow with n: each round one row
    draw per shuffle round of comp's positions (``threefry_rows``) and one
    ordered worker sum (``worker_sum``); ``threefry_uniform`` draws only
    the problems.  Launch counts are reset just before and read just
    after (the profiled run is not counted); only the card's runs launch.
    Every shape the runs give the two kernels is noted and, after the
    counts are read, held bitwise against the plain version
    (``check_main_shapes``)."""
    from repro_torch.core import ExperimentSpec, build

    text = REFERENCE_SPEC.read_text()
    spec = ExperimentSpec.from_json(text)
    if spec.to_json() != text:
        raise AssertionError("[reference-spec] the committed spec does not "
                             "serialise back byte for byte")
    run = build(spec)
    print(f"[reference-spec] {REFERENCE_SPEC.relative_to(ROOT)}: "
          f"fingerprint={spec.fingerprint()} lam={run.algo.lam!r} "
          f"nu={run.algo.nu!r}")
    collect("[reference-spec]")
    torch.cuda.reset_peak_memory_stats()
    seen, restore = recording_kernel_shapes()
    try:
        want, launches = reference_spec_runs(run, spec)
    finally:
        restore()
    check_main_shapes(seen)
    return launches


def reference_spec_runs(run, spec):
    """(a)-(d) of :func:`phase_reference_spec`, between the launch counts'
    reset and their reading: returns (the launches wanted, those read)."""
    import numpy as np

    from repro_torch import random
    from repro_torch.core import ExperimentSpec, build
    from repro_torch.data.synthetic import LogReg, make_synthetic
    from repro_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    want = {}
    # (a) the spec verbatim, card and CPU
    gaps, runs = {}, {}
    for dev in ("cuda", "cpu"):
        res, ms, prob, f_star = reference_case(run, dev)
        f0 = float(prob.f(torch.zeros(spec.d, device=dev)) - f_star)
        gaps[dev] = [f0] + [float(res.metrics[t - 1]) for t in (100, 500)]
        runs[dev] = res
        print(f"[reference-spec] (a) {dev}: {ms:.3f} ms per round "
              f"(n={spec.n}, batched), f(x) - f* at rounds 0/100/500 = "
              f"{gaps[dev]}, f*={f_star!r}")
    add_launches(want, {"threefry_uniform": PROBLEM_DRAWS})
    add_launches(want, round_launches(run.algo.compressor, spec.steps))
    worst = max(abs(g - c) / abs(c) for g, c in zip(gaps["cuda"],
                                                     gaps["cpu"]))
    gpu_m, cpu_m = runs["cuda"].metrics.cpu(), runs["cpu"].metrics
    worst_all = float(((gpu_m - cpu_m).abs() / cpu_m.abs()).max())
    print(f"[reference-spec] (a) card vs CPU: gap relative difference at "
          f"rounds 0/100/500 at most {worst:.3e}, over all 500 rounds "
          f"{worst_all:.3e}; x max |diff| "
          f"{float((runs['cuda'].x.cpu() - runs['cpu'].x).abs().max()):.3e}")
    if not (worst_all <= 1e-5
            and all(math.isfinite(g) for g in gaps["cuda"])
            and gaps["cuda"][-1] < gaps["cuda"][0]):
        raise AssertionError(f"[reference-spec] (a) card {gaps['cuda']} vs "
                             f"CPU {gaps['cpu']}")
    # (b) the exact elementwise gradient: bitwise, card against CPU
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (spec.n, spec.d)).astype(np.float32))
    gamma = run._tune(L=1.0, Ltilde=1.0).gamma
    out = {}
    for dev in ("cuda", "cpu"):
        Bd = B.to(dev)
        res, ms, _, _ = reference_case(run, dev, grad_fn=lambda x: x - Bd,
                                       gamma=gamma)
        out[dev] = res
        print(f"[reference-spec] (b) {dev}: {ms:.3f} ms per round")
    add_launches(want, round_launches(run.algo.compressor, spec.steps))
    same = {k: _bits_equal(getattr(out["cuda"], k) if k == "x" else
                           getattr(out["cuda"].state, k),
                           getattr(out["cpu"], k) if k == "x" else
                           getattr(out["cpu"].state, k))
            for k in ("x", "h", "h_avg")}
    print(f"[reference-spec] (b) x - B_i, gamma={gamma!r}: card vs CPU "
          f"bitwise {same}")
    if not all(same.values()):
        raise AssertionError(f"[reference-spec] (b) not bitwise: {same}")
    # (c) a round at paper Figure 2's scale, card and CPU on the card's data
    A, b = make_synthetic(random.key(FIG2["seed"]), N=FIG2_ROWS * FIG2["n"],
                          d=FIG2["d"], device="cuda")
    probs = {"cuda": LogReg.split(A, b, n=FIG2["n"], mu_reg=0.1)}
    probs["cpu"] = LogReg(probs["cuda"].A.cpu(), probs["cuda"].b.cpu(), 0.1)
    add_launches(want, {"threefry_uniform": PROBLEM_DRAWS})
    before = dict(LAUNCHES)
    for mode in ("efbv", "ef21"):
        frun = build(ExperimentSpec(mode=mode, **FIG2))
        curves = {}
        for dev in ("cuda", "cpu"):
            res, ms, _, f_star = reference_case(frun, dev, prob=probs[dev])
            f0 = float(probs[dev].f(torch.zeros(FIG2["d"], device=dev))
                       - f_star)
            curves[dev] = res.metrics.cpu()
            print(f"[reference-spec] (c) fig2 scale {mode} {dev}: "
                  f"n={FIG2['n']} d={FIG2['d']} {FIG2_ROWS} rows a worker "
                  f"{FIG2['compressor']} lam={frun.algo.lam!r} "
                  f"nu={frun.algo.nu!r}: {ms:.3f} ms per round (batched); "
                  f"f(x) - f* {f0!r} at round 0, "
                  f"{float(curves[dev][-1])!r} after {FIG2['steps']}")
            if not gaps_descend([f0] + curves[dev].tolist()):
                raise AssertionError(f"[reference-spec] (c) {mode} {dev}: "
                                     "gaps not finite and descending")
            if dev == "cuda":
                gamma_c = frun._tune(L=probs[dev].L(),
                                     Ltilde=probs[dev].L_tilde()).gamma
                f_star_c = f_star
        rel = float(((curves["cuda"] - curves["cpu"]).abs()
                     / curves["cpu"].abs()).max())
        print(f"[reference-spec] (c) {mode} card vs CPU over "
              f"{FIG2['steps']} rounds: gap relative difference at most "
              f"{rel:.3e}")
        if not rel <= 1e-5:
            raise AssertionError(f"[reference-spec] (c) {mode}: card vs CPU "
                                 f"{rel}")
        add_launches(want, round_launches(frun.algo.compressor,
                                          FIG2["steps"]))
        if mode == "efbv":
            saved = dict(LAUNCHES)
            profile_reference_round(frun, probs["cuda"], gamma_c, f_star_c)
            torch.cuda.synchronize()
            LAUNCHES.update(saved)
    torch.cuda.synchronize()
    print(f"[reference-spec] (c) launches of the two n = {FIG2['n']} runs "
          f"of {FIG2['steps']} rounds: "
          f"{ {k: LAUNCHES[k] - before[k] for k in LAUNCHES} } (a loop "
          f"over the workers would launch threefry_uniform n x rounds = "
          f"{2 * FIG2['n'] * FIG2['steps']})")
    # (d) the paper at its fast setting
    paper_runs(want)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"[reference-spec] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{launches}")
    want = {**dict.fromkeys(launches, 0), **want}
    if launches != want:
        raise AssertionError(f"[reference-spec] launches {launches}, want "
                             f"{want}")
    return want, launches


#: the reference phase's multi-process cases: name -> (smoke kind, agg,
#: participation, workers), each on two gloo ranks sharing cuda:0
DIST_REF = {
    "block_topk": ("block_topk", "sparse_allgather", "full", 2),
    "qsgd": ("qsgd", "sparse_allgather", "full", 2),
    "randk": ("randk", "sparse_allgather", "full", 2),
    "pipelined": ("pipelined", "sparse_allgather", "full", 2),
    "dense_psum": ("block_topk", "dense_psum", "full", 2),
    "bernoulli": ("block_topk", "sparse_allgather", "bernoulli:0.5", 2),
    "n4": ("block_topk", "sparse_allgather", "full", 4),
}
#: seconds one torchrun launch of two ranks may take before it is killed
DIST_TIMEOUT_S = 400


def smoke_params():
    import dataclasses
    from repro_torch import random
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              activation_dtype="float32")
    return cfg, build_model(cfg).init(random.key(0), device="cpu")


def digest(params):
    """sha256 of every param's bytes, in flatten order (small trees)."""
    import hashlib
    from repro_torch import tree as T

    h = hashlib.sha256()
    for p in T.leaves(params):
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()[:16]


def dist_reference_child():
    """One rank of the reference phase's multi-process cases: every case
    of DIST_REF on this rank's workers, printing its losses (hex) and the
    digest of its final params."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.distributed.aggregate import WorkerGroup, ring_allgather

    cfg, params = smoke_params()
    group = WorkerGroup.join(2, backend="gloo", device="cuda:0")
    try:
        # the ring's hops stage through host buffers (gloo's send of a CUDA
        # tensor aborts the process); it must give the all-gather's bytes
        x = torch.randint(0, 256, (3, 1 << 20), dtype=torch.uint8,
                          device="cuda") + group.rank
        want = torch.empty((2,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device)
        torch.distributed.all_gather(list(want.unbind(0)), x)
        ring = ring_allgather(group, x)
        print(f"[dist-ref] ring_allgather equal={torch.equal(ring, want)}",
              flush=True)
        del x, want, ring
        for name, (kind, agg, part, n) in DIST_REF.items():
            losses, state = run_steps(
                T.tree_map(lambda p: p.cuda(), params), cfg, kind, n=n,
                agg=agg, participation=part,
                group=dataclasses.replace(group, n_workers=n))
            print(f"[dist-ref] {name} losses={[x.hex() for x in losses]} "
                  f"digest={digest(state.params)}", flush=True)
            del state
    finally:
        group.close()


def phase_reference_dist():
    """Two gloo ranks on cuda:0 against the one-process loop on the card,
    for each case of DIST_REF: losses and final params bitwise, on both
    ranks."""
    from repro_torch import tree as T

    cfg, params = smoke_params()
    want = {}
    for name, (kind, agg, part, n) in DIST_REF.items():
        losses, state = run_steps(T.tree_map(lambda p: p.cuda(), params),
                                  cfg, kind, n=n, agg=agg,
                                  participation=part)
        want[name] = ([x.hex() for x in losses], digest(state.params))
        del state
    torch.cuda.empty_cache()
    logs = run_ranks("reference")
    for r, log in enumerate(logs):
        if "[dist-ref] ring_allgather equal=True" not in log:
            raise AssertionError(f"[reference] rank {r}: ring_allgather "
                                 "differs from all_gather")
    print("[reference] ring_allgather on cuda:0 (staged through pinned host "
          "buffers) equal to all_gather on both ranks")
    for name, (losses, dig) in want.items():
        print(f"[reference] {name}: one process losses={losses} "
              f"digest={dig}")
        for r, log in enumerate(logs):
            got = re.findall(rf"\[dist-ref\] {name} losses=(\[.*?\]) "
                             r"digest=(\w+)", log)
            if got != [(str(losses), dig)]:
                raise AssertionError(f"[reference] {name}: rank {r} printed "
                                     f"{got}, want {(str(losses), dig)}")
        print(f"[reference] {name} ({DIST_REF[name]}): 2 gloo ranks on "
              "cuda:0 bitwise equal to the one-process loop (losses, "
              "params)")


def run_ranks(name, ranks=2, timeout=None):
    """``torchrun --standalone --nproc-per-node ranks chip_smoke.py
    --dist-child name DIR``, killed with every rank it started after
    ``timeout`` seconds (DIST_TIMEOUT_S); each rank writes its output to
    DIR/rank<r>.log.  Returns those outputs; fails when the launch does not
    exit 0."""
    timeout = timeout or DIST_TIMEOUT_S
    import os
    import shutil
    import signal

    outdir = ROOT / "build" / "dist" / name
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={ranks}", str(ROOT / "chip_smoke.py"),
           "--dist-child", name, str(outdir)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    t0 = time.perf_counter()
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out[-4000:])
        raise AssertionError(f"[dist] {name}: ranks not done in "
                             f"{timeout} s; killed")
    secs = time.perf_counter() - t0
    logs = []
    for r in range(ranks):
        path = outdir / f"rank{r}.log"
        logs.append(path.read_text() if path.exists() else "")
        for line in logs[-1].splitlines():
            print(f"[rank {r}] {line}")
    print(f"[dist] {name}: torchrun exit {proc.returncode} after "
          f"{secs:.1f} s")
    if proc.returncode != 0:
        print(out[-4000:])
        raise AssertionError(f"[dist] {name}: torchrun exit "
                             f"{proc.returncode}")
    return logs


def params_checksum(params):
    """A checksum of the params' bits, computed on their device: per leaf
    the int64 sums of its 32-bit words, all of them and every seventh."""
    from repro_torch import tree as T

    s = 0
    for p in T.leaves(params):
        x = p.detach().reshape(-1).view(torch.int32)
        s = (s * 1_000_003 + 3 * int(x.sum(dtype=torch.int64))
             + int(x[::7].sum(dtype=torch.int64))) % (1 << 61)
    return f"{s:016x}"


@contextlib.contextmanager
def recording(records, holder=None):
    """While open, every train step that ``launch.train`` builds (through
    ``Run.train_step``, which looks ``trainer.make_train_step`` up at each
    call) appends {loss (hex), params checksum, step ms} and, over a group,
    the host ms and bytes of its exchange, to ``records``; the step is
    timed between synchronisations, before the checksum.  On a mesh rank
    (a group with a ``model`` axis) also the host ms, calls and bytes sent
    of its model-axis collectives, and checksums of its shards of the
    master state (params, w, h_avg, AdamW's m and v).  ``holder["state"]``
    keeps the newest state."""
    from repro_torch.train import trainer as train

    make = train.make_train_step

    def make_recorded(*args, **kwargs):
        step_fn = make(*args, **kwargs)
        group = kwargs.get("group")
        axis = None if group is None else group.model

        def step(state, batch, key):
            torch.cuda.synchronize()
            stats = dict(group.stats) if group is not None else None
            mstats = dict(axis.stats) if axis is not None else None
            t0 = time.perf_counter()
            state, m = step_fn(state, batch, key)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rec = {"loss": loss.hex(), "step_ms": round(
                (time.perf_counter() - t0) * 1e3, 2)}
            if group is not None:
                rec["exchange_ms"] = round(1e3 * (group.stats["exchange_s"]
                                                  - stats["exchange_s"]), 2)
                rec["bytes"] = group.stats["bytes"] - stats["bytes"]
            if axis is not None:
                rec["model_ms"] = round(1e3 * (axis.stats["model_s"]
                                               - mstats["model_s"]), 2)
                rec["model_calls"] = (axis.stats["model_calls"]
                                      - mstats["model_calls"])
                rec["model_bytes"] = (axis.stats["model_bytes"]
                                      - mstats["model_bytes"])
                rec["master"] = {
                    "params": params_checksum(state.params),
                    "w": params_checksum(state.w),
                    "h_avg": params_checksum(state.h_avg),
                    "m": params_checksum(state.opt_state["m"]),
                    "v": params_checksum(state.opt_state["v"])}
            rec["checksum"] = params_checksum(state.params)
            records.append(rec)
            if holder is not None:
                holder["state"] = state
            return state, m
        return step

    train.make_train_step = make_recorded
    try:
        yield
    finally:
        train.make_train_step = make


def dist_child():
    """``--dist-child NAME DIR``: one rank under torchrun, its output in
    DIR/rank<RANK>.log.  ``reference``: :func:`dist_reference_child`;
    a DIST_PATHS name: that path through ``launch.train.main`` with launch
    counts reset just before it and read just after, then its step
    records, launches and peak memory."""
    import os

    name, outdir = sys.argv[2], Path(sys.argv[3])
    rank = int(os.environ["RANK"])
    sys.stdout = open(outdir / f"rank{rank}.log", "w", buffering=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == "reference":
        dist_reference_child()
        return 0
    if name == "mesh_specs":
        mesh_specs_child(outdir)
        return 0
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    records, holder = [], {}
    argv = MESH["argv"] if name == "mesh" else DIST_PATHS[name]["argv"]
    torch.cuda.reset_peak_memory_stats()
    with recording(records, holder):
        reset_launches()
        train.main(argv)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    print(f"[dist] records {json.dumps(records)}")
    print(f"[dist] launches {json.dumps(launches)}")
    print(f"[dist] peak_gib {torch.cuda.max_memory_allocated() / 2**30:.2f}")
    if name == "mesh" and rank < MESH_M:
        # the first worker group's shards, for the parent to reassemble
        from repro_torch import tree as T
        torch.save(T.tree_map(lambda a: a.cpu(), holder["state"].params),
                   outdir / f"params_rank{rank}.pt")
    return 0


#: the spec path's file, written from the pipelined path's flags
SPEC_FILE = ROOT / "build" / "spec" / "pipelined.json"
BASE_ARGV = ["--arch", "qwen2-0.5b", "--workers", str(WORKERS),
             "--steps", str(STEPS), "--global-batch", "8", "--seq", "128",
             "--algo", "efbv", "--agg", "sparse_allgather",
             "--log-every", "1"]
RUNS = WORKERS * STEPS * FULL_LEAVES
#: threefry draws of the init (JAX's weights, ``Model.init(random.key(0))``)
#: in every run of the driver, on every rank: the embedding and 7 weights a
#: layer (biases and norms are constants); full width 24 layers, smoke 2
INIT_DRAWS, SMOKE_INIT_DRAWS = 1 + 24 * 7, 1 + 2 * 7
# each main path: its flags, the exact bits it must print (regex -> values)
# and the launches of every kernel in its run
PATHS = {
    "block_topk": {
        "argv": BASE_ARGV + ["--compressor", "block_topk:256,16"],
        "bits": {r"(\d+) bits/round/worker": [FULL_BITS]},
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0, "threefry_uniform": INIT_DRAWS},
        "profile": ("pack_update_rows",),
    },
    "qsgd_bidirectional": {
        "argv": BASE_ARGV + ["--compressor", "qsgd:16",
                             "--downlink", "qsgd:16"],
        "bits": {r"(\d+) bits/round/worker": [QSGD_BITS],
                 r"downlink (\d+) bits/round broadcast": [QSGD_BITS],
                 r"total (\d+) bits/round up\+down": [QSGD_TOTAL_BITS]},
        # threefry: one uniform per leaf per worker, and one per leaf for
        # the broadcast
        "launches": {"pack_update": 0, "qsgd_pack_update": RUNS,
                     "randk_update": 0,
                     "threefry_uniform": (WORKERS + 1) * STEPS * FULL_LEAVES
                     + INIT_DRAWS},
        "profile": ("qsgd_pack_update_kernel", "threefry_fill_kernel"),
    },
    "randk": {
        "argv": BASE_ARGV + ["--compressor", f"randk:{RANDK_K}"],
        "bits": {r"(\d+) bits/round/worker": [RANDK_BITS],
                 r"(\d\.\d+)x dense fp32": ["0.0342"]},
        # the kernel on every leaf; one threefry draw per shuffle round
        "launches": {"pack_update": 0, "qsgd_pack_update": 0,
                     "randk_update": RUNS,
                     "threefry_uniform": SHUFFLE_ROUNDS * WORKERS * STEPS
                     + INIT_DRAWS},
        "profile": ("randk_histogram_kernel", "randk_scan_kernel",
                    "randk_scatter_kernel", "randk_tile_kernel",
                    "threefry_fill_kernel", "RadixSort"),
    },
    "pipelined": {
        "argv": BASE_ARGV + ["--compressor", "block_topk:256,16",
                             "--downlink", "qsgd:16", "--pipeline",
                             "depth:1"],
        "bits": {r"(\d+) bits/round/worker": [FULL_BITS],
                 r"downlink (\d+) bits/round broadcast": [QSGD_BITS],
                 r"total (\d+) bits/round up\+down": [PIPELINED_TOTAL_BITS],
                 r" (pipeline=depth:1) ": ["pipeline=depth:1"]},
        # every worker packs with the pack kernel; one uniform per leaf
        # for the broadcast
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0,
                     "threefry_uniform": STEPS * FULL_LEAVES + INIT_DRAWS},
        "profile": ("pack_update_rows", "threefry_fill_kernel"),
    },
    "federated": {
        "argv": BASE_ARGV + ["--compressor", "block_topk:256,16",
                             "--participation", "fixed:1"],
        "bits": {r"(\d+) bits/round/worker": [FULL_BITS],
                 r"E\|S_t\|=(\d+) of 2 payloads": [1],
                 r"\|S\|=(\d+)/2 ": [1] * STEPS},
        # every worker packs (an absent one's message is gated after its
        # pack); the mask's shuffle draws once a step
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0, "threefry_uniform": STEPS + INIT_DRAWS},
        "profile": ("pack_update_rows", "threefry_fill_kernel"),
    },
    # ROADMAP's SMOKE flags (block-top-k up, QSGD down, sequential) in one
    # process: the mesh path's reference (its final params are kept)
    "smoke_flags": {
        "argv": BASE_ARGV + ["--compressor", "block_topk:256,16",
                             "--downlink", "qsgd:16"],
        "bits": {r"(\d+) bits/round/worker": [FULL_BITS],
                 r"downlink (\d+) bits/round broadcast": [QSGD_BITS],
                 r"total (\d+) bits/round up\+down": [PIPELINED_TOTAL_BITS]},
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0,
                     "threefry_uniform": STEPS * FULL_LEAVES + INIT_DRAWS},
        "profile": None,
        "keep_params": True,
    },
    # per-leaf codecs: QSGD(16) on the embedding, the final norm dense,
    # block-top-k on the other 12 leaves (the TreeWire)
    "leaf_codecs": {
        "argv": BASE_ARGV + ["--compressor", "block_topk:256,16",
                             "--leaf-codecs", LEAF_RULES],
        "bits": {r"codec=(\S+) \d+ bits/round/worker":
                 ["block_sparse,dense_pack,qsgd_quant"],
                 r"(\d+) bits/round/worker": [LEAF_CODECS_BITS],
                 r"\((\d+\.\d+) MiB": ["300.49"],
                 r"(\d\.\d+)x dense fp32": ["0.1594"]},
        # 12 leaves packed by the pack kernel, the embed leaf quantized
        # (and its uniforms drawn), per worker and step
        "launches": {"pack_update": (FULL_LEAVES - 2) * WORKERS * STEPS,
                     "qsgd_pack_update": WORKERS * STEPS, "randk_update": 0,
                     "threefry_uniform": WORKERS * STEPS + INIT_DRAWS},
        "profile": ("pack_update_rows", "qsgd_pack_update_kernel",
                    "threefry_fill_kernel"),
    },
    # the pipelined path's flags as a spec file (``spec_from_args``,
    # written just before the run), run with --spec and the same runtime
    # flags: the same fingerprint and, at every step, the same loss and
    # params checksum as the pipelined path ("same_as"); not profiled again
    "spec": {
        "argv": ["--spec", str(SPEC_FILE), "--global-batch", "8", "--seq",
                 "128", "--log-every", "1"],
        "spec_of": "pipelined",
        "same_as": "pipelined",
        "bits": {r"(\d+) bits/round/worker": [FULL_BITS],
                 r"downlink (\d+) bits/round broadcast": [QSGD_BITS],
                 r"total (\d+) bits/round up\+down": [PIPELINED_TOTAL_BITS],
                 r" (pipeline=depth:1) ": ["pipeline=depth:1"]},
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0,
                     "threefry_uniform": STEPS * FULL_LEAVES + INIT_DRAWS},
        "profile": None,
    },
}
#: the main paths on two gloo ranks sharing cuda:0 (one worker each,
#: torchrun), each held bitwise against its one-process path ("same_as"):
#: losses and params checksums at every step, on every rank
DIST_PATHS = {
    "dist_block_topk": {
        "argv": PATHS["block_topk"]["argv"] + ["--dist-backend", "gloo"],
        "same_as": "block_topk",
        "bits": {**PATHS["block_topk"]["bits"],
                 r" (ranks=2 backend=gloo) device=": ["ranks=2 backend=gloo"]},
        "launches": {"pack_update": RUNS // WORKERS, "qsgd_pack_update": 0,
                     "randk_update": 0, "threefry_uniform": INIT_DRAWS},
    },
    "dist_pipelined": {
        "argv": PATHS["pipelined"]["argv"] + ["--dist-backend", "gloo"],
        "same_as": "pipelined",
        "bits": {**PATHS["pipelined"]["bits"],
                 r" (ranks=2 backend=gloo) device=": ["ranks=2 backend=gloo"]},
        # each rank packs its worker; the broadcast runs on every rank
        "launches": {"pack_update": RUNS // WORKERS, "qsgd_pack_update": 0,
                     "randk_update": 0,
                     "threefry_uniform": STEPS * FULL_LEAVES + INIT_DRAWS},
    },
}
#: the mesh path: the smoke_flags path's flags on a 2x2 mesh (2 workers x
#: 2-way tensor parallelism), four gloo ranks sharing cuda:0; every rank
#: packs every leaf once a step (in place or after a gather), encodes
#: every leaf of the broadcast, and draws the whole init to keep its shards
MESH_M = 2
MESH = {
    "argv": [a for a in PATHS["smoke_flags"]["argv"]
             if a not in ("--workers", str(WORKERS))]
    + ["--mesh", f"{WORKERS}x{MESH_M}", "--dist-backend", "gloo"],
    "bits": {**PATHS["smoke_flags"]["bits"],
             r" (mesh=2x2 ranks=4 backend=gloo) device=":
             ["mesh=2x2 ranks=4 backend=gloo"]},
    "launches": {"pack_update": STEPS * FULL_LEAVES, "qsgd_pack_update": 0,
                 "randk_update": 0, "threefry_uniform": STEPS * FULL_LEAVES
                 + INIT_DRAWS},
}
MESH_TIMEOUT_S = 600
#: the committed 2x2 specs (smoke size, 4 steps) and the launches each
#: makes on a rank: the smoke model's 14 leaves a step, packed or
#: quantized once, and each QSGD leaf's uniforms (up and down) drawn once;
#: bernoulli participation draws one uniform a step; and the init's draws
MESH_SPECS = {
    "pipelined_blocktopk": {"pack_update": 56, "threefry_uniform": 56 + SMOKE_INIT_DRAWS},
    "qsgd_bidirectional": {"qsgd_pack_update": 56, "threefry_uniform": 112 + SMOKE_INIT_DRAWS},
    "federated_blocktopk": {"pack_update": 56, "threefry_uniform": 4 + SMOKE_INIT_DRAWS},
    # per-leaf codecs: 12 block-sparse leaves packed, the embed leaf
    # quantized (its uniforms drawn) once a step
    "tree_mixed_codecs": {"pack_update": 48, "qsgd_pack_update": 4,
                          "threefry_uniform": 4 + SMOKE_INIT_DRAWS},
}
#: the exact bits each committed 2x2 spec prints: uplink per worker, and
#: the downlink broadcast and round total where it has a downlink
MESH_SPEC_BITS = {
    "pipelined_blocktopk": [5_776_384, 11_553_216, 23_105_984],
    "qsgd_bidirectional": [11_553_216, 11_553_216, 34_659_648],
    "federated_blocktopk": [5_776_384],
    "tree_mixed_codecs": [6_832_160],
}
#: each one-process path's step records (``recording``), for DIST_PATHS
#: and the spec path
MAIN_RECORDS = {}
#: the final params (on the host) of the paths that keep them
MAIN_PARAMS = {}
#: each one-process path's printed spec fingerprint
MAIN_FINGERPRINTS = {}


def collect(label):
    """Free what only reference cycles still hold, and say how much of the
    device memory that was (what an earlier phase left for the garbage
    collector)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    print(f"{label}: allocated {before:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after "
          "gc.collect()")


def phase_main(name):
    """Drive one main path through the launcher; launch counts are reset
    just before it and read just after."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    path = PATHS[name]
    written = None
    if path.get("spec_of"):
        # the flags of the path it repeats, folded into a spec file
        args = train.parse_args(PATHS[path["spec_of"]]["argv"])
        written = train.spec_from_args(args, args.workers)
        SPEC_FILE.parent.mkdir(parents=True, exist_ok=True)
        SPEC_FILE.write_text(written.to_json())
        print(f"[main] {name}: wrote {SPEC_FILE.relative_to(ROOT)} from the "
              f"{path['spec_of']} path's flags, fingerprint "
              f"{written.fingerprint()}")
    out = io.StringIO()
    torch.cuda.synchronize()
    collect(f"[main] {name}")
    torch.cuda.reset_peak_memory_stats()
    records = MAIN_RECORDS[name] = []
    holder = {}
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), recording(records, holder):
            reset_launches()
            train.main(path["argv"])
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
    finally:
        print(out.getvalue().rstrip())
    if path.get("keep_params"):
        from repro_torch import tree as T
        MAIN_PARAMS[name] = T.tree_map(lambda a: a.cpu(),
                                       holder["state"].params)
    holder.clear()
    secs = time.perf_counter() - t0
    text = out.getvalue()
    losses = [float(x) for x in re.findall(r"step\s+\d+ loss=(\S+)", text)]
    bits = {pat: [int(x) if x.isdigit() else x for x in re.findall(pat, text)]
            for pat in path["bits"]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] {name}: seconds={secs:.2f} peak_mem_gib={peak:.2f} "
          f"losses={losses} bits={list(bits.values())} launches={launches} "
          f"records={json.dumps(records)}")
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[main] {name}: expected {STEPS} finite losses")
    # random init with small embeddings: the first loss is close to ln(V)
    if abs(losses[0] - math.log(151936)) > 1.0:
        raise AssertionError(f"[main] {name}: first loss {losses[0]} far "
                             "from ln V")
    for pat, want in path["bits"].items():
        if bits[pat] != want:
            raise AssertionError(f"[main] {name}: printed {pat!r} "
                                 f"{bits[pat]} != {want}")
    # every kernel the path does not name must not launch
    want = {**dict.fromkeys(launches, 0), **path["launches"]}
    if launches != want:
        raise AssertionError(f"[main] {name}: launches {launches}, want "
                             f"{want}")
    if "pipeline=depth:1" in text:
        # round 0 applies the decode-zero priming payload: g = 0
        g0 = re.findall(r"step\s+0 loss=\S+ \|g\|=(\S+)", text)
        if g0 != ["0.000"]:
            raise AssertionError(f"[main] {name}: step 0 |g| {g0}, want "
                                 "0.000 (the zero priming payload)")
    fps = re.findall(r"spec fingerprint=([0-9a-f]{16})", text)
    MAIN_FINGERPRINTS[name] = fps
    if len(fps) != 1:
        raise AssertionError(f"[main] {name}: printed fingerprints {fps}")
    if written is not None:
        want = MAIN_FINGERPRINTS[path["same_as"]]
        if fps != [written.fingerprint()] or fps != want:
            raise AssertionError(
                f"[main] {name}: fingerprint {fps}, the file's "
                f"{written.fingerprint()}, the {path['same_as']} path's "
                f"{want}")
        same = [(a["loss"], a["checksum"]) for a in records] == \
            [(b["loss"], b["checksum"]) for b in MAIN_RECORDS[
                path["same_as"]]]
        print(f"[main] {name}: fingerprint {fps[0]} equal to the file's and "
              f"the {path['same_as']} path's; losses and params checksums "
              f"at every step {'equal' if same else 'NOT equal'} to the "
              f"{path['same_as']} path's")
        if not same:
            raise AssertionError(f"[main] {name}: records {records} != "
                                 f"{MAIN_RECORDS[path['same_as']]}")
    return launches


def phase_dist(name):
    """One main path on two gloo ranks sharing cuda:0 (``run_ranks``): rank
    0's printed bits, three finite losses and (pipelined) |g| = 0 at step
    0; on every rank the launches of its run, and at every step the loss
    and params checksum of the one-process path it repeats.  Then the dist
    profile lines: step ms, host ms in the exchange (the all-gather, or
    ``wait()`` when pipelined), bytes gathered per rank per round and the
    peak device memory, per rank.  Returns the launches summed over the
    ranks."""
    path = DIST_PATHS[name]
    want = MAIN_RECORDS[path["same_as"]]
    collect(f"[main] {name}")
    torch.cuda.empty_cache()
    logs = run_ranks(name)
    text = logs[0]
    losses = [float(x) for x in re.findall(r"step\s+\d+ loss=(\S+)", text)]
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[main] {name}: expected {STEPS} finite losses")
    for pat, expect in path["bits"].items():
        got = [int(x) if x.isdigit() else x for x in re.findall(pat, text)]
        if got != expect:
            raise AssertionError(f"[main] {name}: printed {pat!r} {got} != "
                                 f"{expect}")
    if path["same_as"] == "pipelined":
        g0 = re.findall(r"step\s+0 loss=\S+ \|g\|=(\S+)", text)
        if g0 != ["0.000"]:
            raise AssertionError(f"[main] {name}: step 0 |g| {g0}, want "
                                 "0.000 (the zero priming payload)")
    total = {}
    for r, log in enumerate(logs):
        records = json.loads(re.search(r"\[dist\] records (.*)", log)[1])
        launches = json.loads(re.search(r"\[dist\] launches (.*)", log)[1])
        peak = float(re.search(r"\[dist\] peak_gib (\S+)", log)[1])
        same = [(a["loss"], a["checksum"]) for a in records] == \
            [(b["loss"], b["checksum"]) for b in want]
        print(f"[main] {name} rank {r}: losses and params checksums at "
              f"every step {'equal' if same else 'NOT equal'} to the "
              f"one-process {path['same_as']} path's; launches={launches}")
        if not same:
            raise AssertionError(f"[main] {name} rank {r}: records "
                                 f"{records} != one-process {want}")
        expect = {**dict.fromkeys(launches, 0), **path["launches"]}
        if launches != expect:
            raise AssertionError(f"[main] {name} rank {r}: launches "
                                 f"{launches}, want {expect}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        # step 0 holds the first collective's set-up: the steady steps
        print(f"[profile] {name} rank {r}: step_ms="
              f"{[a['step_ms'] for a in records]} exchange_host_ms="
              f"{[a['exchange_ms'] for a in records]} bytes_gathered_per_"
              f"round={[a['bytes'] for a in records]} peak_gib={peak:.2f} "
              "(two processes time-slice one card; gloo moves the payload "
              "through host memory)")
    return total


def mesh_specs_child(outdir):
    """One rank of the mesh specs phase: probes whether gloo's all-reduce
    takes a bf16 CUDA tensor (the model axis reduces in f32 either way),
    then each committed 2x2 spec through ``launch.train.main`` with
    ``--spec`` (smoke size), its own file store, between marker lines, with
    launch counts reset just before it and read just after."""
    import os

    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{outdir}/probe",
                            rank=rank, world_size=world)
    try:
        x = torch.full((1024,), 1.5, dtype=torch.bfloat16, device="cuda")
        dist.all_reduce(x)
        probe = f"ok, sum {float(x[0])} (want {1.5 * world})"
    except Exception as e:  # the probe's answer, not a failure
        probe = f"refused: {type(e).__name__}: {str(e)[:200]}"
    dist.destroy_process_group()
    print(f"[mesh-specs] gloo all_reduce of a bf16 CUDA tensor: {probe}")
    for i, name in enumerate(MESH_SPECS):
        print(f"[mesh-specs] begin {name}", flush=True)
        reset_launches()
        train.main(["--spec", str(ROOT / "examples" / "specs" /
                                  f"{name}.json"),
                    "--global-batch", "8", "--seq", "32", "--log-every",
                    "1", "--dist-backend", "gloo", "--dist-init",
                    f"file://{outdir}/store{i}"])
        torch.cuda.synchronize()
        print(f"[mesh-specs] launches {name} {json.dumps(dict(LAUNCHES))}")
        print(f"[mesh-specs] end {name}", flush=True)


def phase_mesh():
    """The mesh path (``MESH``): four gloo ranks on cuda:0, full-width
    qwen2-0.5b from JAX's weights.  Rank 0's exact bits; a finite loss at
    every step on every rank; each kernel's launches per rank; at every
    step, the two ranks of each model index (one per worker) hold bitwise
    the same shards of params, w, h_avg, m and v; the first worker group's
    params shards, reassembled, against the one-process smoke_flags run
    from the same init (``mesh_params_check``).  Then the per-rank numbers.
    Returns the launches summed over the ranks."""
    collect("[main] mesh")
    torch.cuda.empty_cache()
    logs = run_ranks("mesh", ranks=WORKERS * MESH_M, timeout=MESH_TIMEOUT_S)
    text = logs[0]
    for pat, expect in MESH["bits"].items():
        got = [int(x) if x.isdigit() else x for x in re.findall(pat, text)]
        if got != expect:
            raise AssertionError(f"[main] mesh: printed {pat!r} {got} != "
                                 f"{expect}")
    want = MAIN_RECORDS["smoke_flags"]
    records, total = [], {}
    for r, log in enumerate(logs):
        recs = json.loads(re.search(r"\[dist\] records (.*)", log)[1])
        launches = json.loads(re.search(r"\[dist\] launches (.*)", log)[1])
        peak = float(re.search(r"\[dist\] peak_gib (\S+)", log)[1])
        losses = [float.fromhex(a["loss"]) for a in recs]
        if len(losses) != STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"[main] mesh rank {r}: losses {losses}")
        # bf16 activations summed in another order by the model axis's
        # all-reduces: the losses within 1e-3 relative of one process
        one = [float.fromhex(b["loss"]) for b in want]
        if any(abs(a - b) > 1e-3 * abs(b) for a, b in zip(losses, one)):
            raise AssertionError(f"[main] mesh rank {r}: losses {losses} "
                                 f"vs one process {one}")
        expect = {**dict.fromkeys(launches, 0), **MESH["launches"]}
        if launches != expect:
            raise AssertionError(f"[main] mesh rank {r}: launches "
                                 f"{launches}, want {expect}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        records.append(recs)
        print(f"[main] mesh rank {r} (worker {r // MESH_M}, model "
              f"{r % MESH_M}): losses={losses} (one process {one}) "
              f"launches={launches}")
        print(f"[profile] mesh rank {r}: step_ms="
              f"{[a['step_ms'] for a in recs]} model_axis_host_ms="
              f"{[a['model_ms'] for a in recs]} model_axis_calls="
              f"{[a['model_calls'] for a in recs]} model_axis_bytes_sent="
              f"{[a['model_bytes'] for a in recs]} exchange_host_ms="
              f"{[a['exchange_ms'] for a in recs]} exchange_bytes_sent="
              f"{[a['bytes'] // WORKERS for a in recs]} peak_gib={peak:.2f} "
              "(four processes time-slice one card; gloo moves every "
              "collective through host memory: not NCCL, not a "
              "tensor-parallel time)")
    for m in range(MESH_M):
        a, b = records[m], records[MESH_M + m]
        same = [x["master"] for x in a] == [y["master"] for y in b]
        print(f"[main] mesh: model index {m}: ranks {m} and {MESH_M + m} "
              f"hold {'bitwise the same' if same else 'DIFFERENT'} shards "
              "of params, w, h_avg, m, v at every step")
        if not same:
            raise AssertionError(f"[main] mesh: model index {m} ranks "
                                 "differ")
    mesh_params_check()
    return total


def mesh_params_check():
    """The mesh's final params (the first worker group's shards,
    reassembled by ``param_specs``) against the one-process smoke_flags
    run's, both from ``init(random.key(0))``.  Their bf16 activations are
    summed in another order, so a block-top-k near-tie can select other
    values, and AdamW then moves an element by up to lr_t * 1.001 a step
    (its m / sqrt(v) bound at b1 0.9, b2 0.95 over 3 steps) either way:
    max |diff| <= 2.02 * sum_t lr_t.  Beyond that bound, the share of
    elements that differ by more than 1e-6 must stay below 0.25 and the
    norm of the difference below half the norm of the update, which a
    wrong gradient or shard would break (at smoke size on the CPU: 2-8%
    and 0.19)."""
    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.layers import is_spec, spec_dim
    from repro_torch.models.model import build_model
    from repro_torch.optim.schedules import cosine

    model = build_model(get_config("qwen2-0.5b"))
    dims = [spec_dim(x) for x in T.leaves(model.param_specs(),
                                          is_leaf=is_spec)]
    outdir = ROOT / "build" / "dist" / "mesh"
    parts = [T.leaves(torch.load(outdir / f"params_rank{r}.pt"))
             for r in range(MESH_M)]
    one = T.leaves(MAIN_PARAMS["smoke_flags"])
    init = T.leaves(model.init(random.key(0), device="cuda"))
    sched = cosine(3e-4, total_steps=STEPS,
                   warmup_steps=max(STEPS // 20, 1))
    bound = 2.02 * sum(sched(t) for t in range(STEPS))
    worst, over, count, num, den = 0.0, 0, 0, 0.0, 0.0
    for dim, ps, o, i in zip(dims, zip(*parts), one, init):
        whole = (ps[0] if dim is None else torch.cat(ps, dim=dim)).cuda()
        o = o.cuda()
        d = (whole.double() - o.double()).abs()
        worst = max(worst, float(d.max()))
        over += int((d > 1e-6).sum())
        count += d.numel()
        num += float((d * d).sum())
        den += float(((o.double() - i.double()) ** 2).sum())
    share, rel = over / count, math.sqrt(num / den)
    print(f"[main] mesh: reassembled params after {STEPS} steps vs one "
          f"process: max |diff| {worst:.3e} (bound {bound:.3e}), share "
          f"differing > 1e-6 {share:.4f} (limit 0.25), |diff| / |update| "
          f"{rel:.4f} (limit 0.5)")
    if not (worst <= bound and share < 0.25 and rel < 0.5):
        raise AssertionError("[main] mesh: params outside the tolerance of "
                             "the one-process run")


def phase_mesh_specs():
    """The four committed 2x2 specs at smoke size on four gloo ranks:
    each exits 0 (the launch), prints the file's fingerprint, its exact
    bits and four finite losses, and launches its kernels as MESH_SPECS
    says on every rank.  Returns the launches summed over the ranks and
    specs."""
    from repro_torch.core import ExperimentSpec

    collect("[main] mesh_specs")
    torch.cuda.empty_cache()
    logs = run_ranks("mesh_specs", ranks=WORKERS * MESH_M)
    print(re.search(r"\[mesh-specs\] gloo all_reduce.*", logs[0])[0])
    total = {}
    for name, want in MESH_SPECS.items():
        spec = ExperimentSpec.from_json(
            (ROOT / "examples" / "specs" / f"{name}.json").read_text())
        bits = MESH_SPEC_BITS[name]
        for r, log in enumerate(logs):
            seg = log.split(f"[mesh-specs] begin {name}")[1].split(
                f"[mesh-specs] end {name}")[0]
            launches = json.loads(re.search(
                rf"\[mesh-specs\] launches {name} (.*)", seg)[1])
            expect = {**dict.fromkeys(launches, 0), **want}
            if launches != expect:
                raise AssertionError(f"[mesh-specs] {name} rank {r}: "
                                     f"launches {launches}, want {expect}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            if r:
                continue
            fps = re.findall(r"spec fingerprint=([0-9a-f]{16})", seg)
            got = [int(x) for x in re.findall(
                r"(\d+) bits/round(?:/worker)? (?:uplink|broadcast|up\+d"
                r"own)", seg)]
            losses = [float(x) for x in re.findall(
                r"step\s+\d+ loss=(\S+)", seg)]
            print(f"[mesh-specs] {name}: fingerprint {fps} (file "
                  f"{spec.fingerprint()}) bits {got} losses {losses} "
                  f"launches per rank {launches}")
            if fps != [spec.fingerprint()] or got != bits or \
                    len(losses) != spec.steps or \
                    not all(map(math.isfinite, losses)):
                raise AssertionError(f"[mesh-specs] {name}: wrong output")
    return total


def phase_bench():
    """The compressor bench's main path, ``compressor_bench.main(["--full"])``
    (launch counts reset just before it and read just after): every
    untimed full-width pass must launch block_topk, efbv_update and
    pack_update exactly once per leaf, and the rows must all be there."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import compressor_bench as bench

    collect("[main] compressor_bench")
    torch.cuda.empty_cache()
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rows = bench.main(["--full"])
        torch.cuda.synchronize()
    finally:
        print(out.getvalue().rstrip())
    launches = dict(LAUNCHES)
    print(f"[main] compressor_bench: seconds={time.perf_counter() - t0:.2f} "
          f"launches={launches}")
    rows = {r["name"]: r["derived"] for r in rows}
    per_pass = " ".join(f"{k}={FULL_LEAVES}" for k in
                        ("block_topk", "efbv_update", "pack_update"))
    for block, kb in bench.FULL_CONFIGS:
        got = rows.get(f"full/launches_b{block}_k{kb}")
        if got != per_pass:
            raise AssertionError(f"[main] compressor_bench b{block} k{kb}: "
                                 f"untimed pass launched {got}, want "
                                 f"{per_pass}")
        for k in ("block_topk", "efbv_update", "pack_update"):
            if f"full/{k}_b{block}_k{kb}" not in rows:
                raise AssertionError(f"[main] compressor_bench: no row "
                                     f"full/{k}_b{block}_k{kb}")
    codecs = [n for n in rows if n.startswith("wire/codec_")]
    if len(codecs) != 9 or "wire/fused_pack_bytes" not in rows:
        raise AssertionError(f"[main] compressor_bench: rows {sorted(rows)}")
    print(f"[main] compressor_bench: wire/fused_pack_bytes "
          f"{rows['wire/fused_pack_bytes']}")
    return launches


def timed_choices(fn):
    """(fn(), summed ms between CUDA events recorded just before and just
    after each ``random.choice`` call that fn makes, number of calls): the
    time the stream spends in the rand-k shuffles within that run."""
    from repro_torch import random

    choice, pairs = random.choice, []

    def timed(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = choice(*args, **kwargs)
        b.record()
        pairs.append((a, b))
        return out

    random.choice = timed
    try:
        out = fn()
    finally:
        random.choice = choice
    torch.cuda.synchronize()
    return out, sum(a.elapsed_time(b) for a, b in pairs), len(pairs)


def phase_profile(name):
    """Where a full-width step's time goes: after a warm-up step, one step
    timed on the host clock (for rand-k with its shuffles between CUDA
    events, ``timed_choices``) and one traced with torch.profiler (device
    time by kernel, and the device's busy share of the traced step).  A
    trace whose rows cannot be read is reported, not failed; a failure of
    the steps themselves fails the phase.  Then where its memory goes
    (``phase_peaks``, and for the QSGD path ``memory_probes``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.launch import train

    path = PATHS[name]
    collect(f"[profile] {name}")
    with contextlib.redirect_stdout(io.StringIO()):
        state, step_fn, data = train.setup(train.parse_args(path["argv"]))
    key = random.key(0)
    state, m = step_fn(state, data.batch(0), random.fold_in(key, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, m), shuffle_ms, choices = timed_choices(
        lambda: step_fn(state, data.batch(1), random.fold_in(key, 1)))
    loss = float(m["loss"])
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(loss):
        raise AssertionError(f"[profile] {name}: untraced step loss {loss}")
    print(f"[profile] {name}: untraced step wall_ms={untraced:.2f}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, data.batch(2), random.fold_in(key, 2))
        loss = float(m["loss"])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(loss):
        raise AssertionError(f"[profile] {name}: traced step loss {loss}")
    try:
        # device kernels only: CPU ops also carry the device time of the
        # kernels they launched, which would count every kernel twice
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    except Exception as e:  # reading the trace, not the port: report it
        print(f"[profile] {name}: not measured: {e!r}")
        rows = None
    if rows is not None:
        print_profile(name, rows, untraced, wall)
    if name == "randk":
        print(f"[profile] randk: the shuffles of the untraced step "
              f"({choices} random.choice calls between CUDA events) "
              f"ms={shuffle_ms:.2f}, {shuffle_ms / untraced:.3f} of it")
    # the holder is the only reference to the state, as the launcher's loop
    # variable is: a second one would keep a stale state alive in the steps
    holder = {"state": state}
    del state, prof
    phase_peaks(name, holder, step_fn, data)
    if name == "qsgd_bidirectional":
        memory_probes(holder["state"])
    if name == "randk":
        randk_memory_probes(holder["state"])
    if name == "pipelined":
        inflight = T.leaves(holder["state"].inflight)
        used = sum(a.numel() * a.element_size() for a in inflight)
        held = sum(a.untyped_storage().nbytes() for a in inflight)
        print(f"[memory] pipelined: in-flight buffer {len(inflight)} "
              f"tensors, {used} B of payload ({used / 2**30:.3f} GiB), "
              f"{held} B of storage")


def print_profile(name, rows, untraced, wall):
    """Device time by kernel of the traced step, and its busy share."""
    path = PATHS[name]
    busy = sum(r[0] for r in rows)
    print(f"[profile] {name}: traced step wall_ms={wall:.2f} (profiler "
          f"overhead included) device_kernel_ms={busy:.2f}; busy share of "
          f"the untraced step {busy / untraced:.3f}")
    for kernel in path["profile"]:
        ms = sum(r[0] for r in rows if kernel in r[2])
        n = sum(r[1] for r in rows if kernel in r[2])
        print(f"[profile] {name}: {kernel} device_ms={ms:.3f} x{n}")
    if name == "randk":
        # kernels that only the shuffles run: the threefry draws, the radix
        # sorts, the sorts' index fill and the arange; its gathers x[order]
        # and sign-bit XORs are generic kernels that the step runs for other
        # work too, so this is a lower bound
        only = ("threefry_fill_kernel", "RadixSort",
                "fill_reverse_indices_kernel", "arange_cuda_out")
        ms = sum(r[0] for r in rows if any(o in r[2] for o in only))
        print(f"[profile] {name}: kernels only the shuffles run device_ms="
              f"{ms:.3f}, {ms / busy:.3f} of the device kernel time, "
              f"{ms / untraced:.3f} of the untraced step")
    for t, count, key in sorted(rows, reverse=True)[:15]:
        print(f"[profile] {name}: {t:9.3f} ms x{count:<5d} {key[:90]}")


def peak_above(fn):
    """(fn(), GiB of device memory allocated at fn's peak above what was
    allocated when it started)."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


PHASES = ("value_and_grad", "compress_local", "exchange",
          "combine_global", "apply_updates", "broadcast_global")


def phase_peaks(name, holder, step_fn, data):
    """The device memory peak of one full-width step, and of each of its
    phases: the trainer's calls of PHASES are wrapped so that each resets
    the peak before it runs and reads it after.  ``holder["state"]`` is
    the state, replaced by each step."""
    from repro_torch import random
    from repro_torch.train import trainer

    peaks = {}

    def wrapped(phase, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            peaks[phase] = max(peaks.get(phase, 0),
                               torch.cuda.max_memory_allocated() / 2**30)
            return out
        return call

    gc.collect()
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    holder["state"], _ = step_fn(holder["state"], data.batch(3),
                                 random.fold_in(random.key(0), 3))
    torch.cuda.synchronize()
    step = torch.cuda.max_memory_allocated() / 2**30
    saved = {p: getattr(trainer, p) for p in PHASES}
    try:
        for p in PHASES:
            setattr(trainer, p, wrapped(p, saved[p]))
        holder["state"], m = step_fn(holder["state"], data.batch(4),
                                     random.fold_in(random.key(0), 4))
    finally:
        for p in PHASES:
            setattr(trainer, p, saved[p])
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"[memory] {name}: step loss not finite")
    print(f"[memory] {name}: resting_gib={rest:.2f} step_peak_gib={step:.2f}"
          f"; peak GiB within each phase: "
          + " ".join(f"{p}={peaks[p]:.2f}" for p in PHASES if p in peaks))


def memory_probes(state):
    """Transient memory of the QSGD path's phases, each run alone on the
    full-width state: one worker's uplink encode, the downlink broadcast,
    and the embed leaf's encode_update and norm pass."""
    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.core.compressors import QSGD
    from repro_torch.configs import get_config
    from repro_torch.core.efbv import EFBV, Downlink, downlink_key
    from repro_torch.distributed import aggregate, wire
    from repro_torch.launch.train import tuning_dim

    key = random.fold_in(random.key(0), 5)
    algo = EFBV.make(QSGD(16), d=tuning_dim(get_config("qwen2-0.5b")),
                     n=WORKERS)
    h0 = T.tree_map(lambda a: a[0], state.h)
    out, uplink = peak_above(lambda: aggregate.compress_local(
        algo, random.fold_in(key, 0), state.params, h0,
        mode="sparse_allgather"))
    del out
    out, down = peak_above(lambda: aggregate.broadcast_global(
        Downlink(QSGD(16)), downlink_key(key), state.params, state.w))
    del out
    g, h = T.leaves(state.params)[0], T.leaves(h0)[0]
    codec = wire.QsgdQuant(shape=tuple(g.shape), size=g.numel(), s=16)
    out, enc = peak_above(lambda: codec.encode_update(
        random.fold_in(key, 1), g, h, algo.lam))
    del out
    _, norm = peak_above(lambda: torch.linalg.vector_norm(g - h))
    print(f"[memory] qsgd_bidirectional: alone on the full-width state, "
          f"peak above their inputs: one worker's compress_local "
          f"{uplink:.2f} GiB, broadcast_global {down:.2f} GiB, the embed "
          f"leaf's encode_update {enc:.2f} GiB and its norm pass "
          f"{norm:.2f} GiB ({g.numel()} values)")


def randk_memory_probes(state):
    """Transient memory of the rand-k path, each run alone on the
    full-width state: one worker's uplink encode, and the embed leaf's
    encode_update (the kernel path) and its shuffle (``random.choice``)."""
    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import RandK
    from repro_torch.core.efbv import EFBV
    from repro_torch.distributed import aggregate
    from repro_torch.launch.train import tuning_dim

    key = random.fold_in(random.key(0), 5)
    algo = EFBV.make(RandK(RANDK_K), d=tuning_dim(get_config("qwen2-0.5b")),
                     n=WORKERS)
    h0 = T.tree_map(lambda a: a[0], state.h)
    out, uplink = peak_above(lambda: aggregate.compress_local(
        algo, random.fold_in(key, 0), state.params, h0,
        mode="sparse_allgather"))
    del out
    g, h = T.leaves(state.params)[0], T.leaves(h0)[0]
    codec = RandK(RANDK_K).codec(tuple(g.shape))
    out, enc = peak_above(lambda: codec.encode_update(
        random.fold_in(key, 1), g, h, algo.lam))
    del out
    _, shuffle = peak_above(lambda: random.choice(
        random.fold_in(key, 2), g.numel(), RANDK_K, "cuda"))
    print(f"[memory] randk: alone on the full-width state, peak above their "
          f"inputs: one worker's compress_local {uplink:.2f} GiB, the embed "
          f"leaf's encode_update {enc:.2f} GiB and its shuffle "
          f"{shuffle:.2f} GiB ({g.numel()} values)")


KERNEL_ROWS = {
    "pack_update": ("src/repro_torch/kernels/csrc/pack_update.cu",
                    "src/repro/kernels/pack.py:91 (and :78: the two Pallas "
                    "bodies of pack_update_pallas give the same bits)"),
    "qsgd_pack_update": ("src/repro_torch/kernels/csrc/qsgd_pack_update.cu",
                         "src/repro/kernels/pack.py:227"),
    "randk_update": ("src/repro_torch/kernels/csrc/randk_update.cu",
                     "src/repro/kernels/pack.py:166"),
    # no Pallas kernel: the JAX package's uniforms come from XLA
    "threefry_uniform": ("src/repro_torch/kernels/csrc/threefry.cu",
                         "src/repro/distributed/wire.py:442 "
                         "(jax.random.uniform; no Pallas kernel)"),
    "block_topk": ("src/repro_torch/kernels/csrc/block_topk.cu",
                   "src/repro/kernels/block_topk.py:55 (block_topk_pallas; "
                   "body _block_topk_kernel :49)"),
    "efbv_update": ("src/repro_torch/kernels/csrc/block_topk.cu",
                    "src/repro/kernels/block_topk.py:86 (efbv_update_pallas; "
                    "body _efbv_update_kernel :70)"),
    # the reference backend's batched round; no Pallas kernel: JAX's draws
    # under vmap and its worker mean are XLA's
    "threefry_rows": ("src/repro_torch/kernels/csrc/threefry.cu",
                      "src/repro/core/efbv.py:604 (jax.random under vmap "
                      "over the workers of run_reference; no Pallas "
                      "kernel)"),
    "worker_sum": ("src/repro_torch/kernels/csrc/worker_sum.cu",
                   "src/repro/core/efbv.py:608 (jnp.mean over the vmapped "
                   "workers, and :611 masked; no Pallas kernel)"),
}


def main():
    if sys.argv[1:2] == ["--randk-trap-child"]:
        return randk_trap_child()
    if sys.argv[1:2] == ["--dist-child"]:
        return dist_child()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 2
    print(f"[env] torch={torch.__version__} cuda={torch.version.cuda} "
          f"device={torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(f"[env] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")

    t0 = time.perf_counter()
    phase_build()
    timing = phase_kernels()
    torch.cuda.empty_cache()
    phase_reference()
    torch.cuda.empty_cache()
    phase_zoo()
    torch.cuda.empty_cache()
    phase_reference_dist()
    launches = {}
    launches["reference"] = phase_reference_spec()
    torch.cuda.empty_cache()
    for name in PATHS:
        launches[name] = phase_main(name)
        torch.cuda.empty_cache()
        if PATHS[name]["profile"] is not None:
            phase_profile(name)
            torch.cuda.empty_cache()
    for name in DIST_PATHS:
        launches[name] = phase_dist(name)
    launches["mesh"] = phase_mesh()
    MAIN_PARAMS.clear()
    launches["mesh_specs"] = phase_mesh_specs()
    launches["compressor_bench"] = phase_bench()
    torch.cuda.empty_cache()
    print(f"[env] phases took {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # summed over the main paths, and by path
            "launches": sum(run[name] for run in launches.values()),
            "launches_by_path": {p: run[name] for p, run in launches.items()
                                 if run[name]},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(f"[kernels] launches on the main paths: {launches}")
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"[kernels] never launched on a main path: "
                             f"{idle}")
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
