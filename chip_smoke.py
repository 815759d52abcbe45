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
              versions at n in {16, 1000} and d in {64, 112, 300, 2**20}
              and, for the worker sum, at its layouts' edges (n = 33,
              1024, 1025, 32**3 + 1 and the narrow layout's last row count
              +-1; 1, 31, 33 and 113 columns), timed beside them (the
              worker sum's device time by the profiler at (1000, 112); a
              plain version above 2**24 values is not timed); the stable
              sorts of the batched compressors with forced ties, card ==
              CPU == numpy.  The row shuffle (``shuffle_rows``: every sort
              round of ``permutation_rows``/``choice_rows`` and the cut in
              one launch) bitwise against its plain version at the
              reference's shapes, rows of 1-3 values, 1625/1626 (one and
              two rounds), 16384/16385 (both routes of ``shuffle_plan``),
              one row and 65,539 rows, and card == CPU; timed at its
              SHUFFLE_TIMED shapes beside the sequence it replaced and
              ``argsort(rand)`` (not bit-equal), its bound from its SASS.
              The threefry draw's SASS per value: all
              instructions, the integer pipe's, the FMA pipe's IMADs.
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
3a'. families -- the ssm, moe, hybrid, encdec and vlm families at smoke
              size (``phase_families``): the initial trees of mamba2,
              granite-moe, zamba2, whisper and qwen2-vl drawn on the card
              bitwise equal to the CPU's (mamba2's and zamba2's dt_bias and
              A_log run XLA's f32 exp, expm1 and log, emulated); two steps
              of ``build(spec)``'s trainer (block-top-k up; whisper's frames
              and qwen2-vl's vision embeddings in every batch) on the card
              and the CPU for those and dbrx, held as the zoo phase holds
              its cases;
              the fixed-routing MoE regime (zero routers): only experts
              0..k-1 carry gradients on the card, one step with
              ``grad_transform=zero_inactive_expert_grads`` gives the
              CPU's loss and params, and a mask dropping active expert 0
              leaves its slabs unchanged by the step; and fault w at full
              width: one chunk-128 mamba2 layer's gradients finite on the
              card where JAX's literal form is not.
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
              problems' threefry draws, one row shuffle -- every sort
              round and the cut -- and one worker sum a round, none of it
              growing with n) are a main path's, ``reference``.
4. main paths -- the driver's ``setup`` and loop (``train.train_loop``),
              as ``repro_torch.launch.train.main`` runs them in one
              process, at the full width and depth of qwen2-0.5b, 2 workers, 3 steps, sparse all-gather
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
                16) up, QSGD(16) down, sequential), qwen2-0.5b cut to 4
                of 24 layers (``cut_depth``), dist_fsdp's reference (not
                profiled);
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
              (hex), the workers' raw gradient norm (finite) and a
              checksum of the params are recorded, and every leaf shape
              the path gives ``pack_update`` is held bitwise against its
              plain version on the card after the counts are read.
              * mamba2: mamba2-130m at full width and depth (24 SSD
                blocks, d_model 768, 24 heads of 64, state 128, 128,983,488
                params in 15 leaves), sequence 512 (4 chunks of 128: the
                inter-chunk recurrence carries state), block-top-k (256,
                16), a checkpoint every step (``--ckpt-dir``): 515,936,256
                bits a worker, 90 ``pack_update`` and 193
                ``threefry_uniform`` launches, finite losses, |g| and
                h_res, and the last checkpoint
                restored bitwise into the template, its embedded spec the
                run's, a restore under another spec refused;
              * moe: granite-moe-3b-a800m at full width with 4 of its 32
                layers (553,916,928 params, 13 leaves), built by the
                driver's ``setup`` on the cut config (``cut_depth``: the
                driver has no depth flag) and run by its loop
                (``train.train_loop``),
                block-top-k (256, 16): 2,215,667,712 bits a worker, 78
                ``pack_update`` and 34 ``threefry_uniform`` launches,
                finite losses, gradient norms and aux losses.
              * hybrid: zamba2-7b at full width with 12 of its 81 layers
                (1,370,644,416 params, 25 leaves; the shared attention
                block after layers 5 and 11), by ``cut_depth`` and the
                driver's loop: 5,482,579,968 bits a worker, 150
                ``pack_update`` and 105 ``threefry_uniform`` launches,
                finite losses, |g|, h_res and raw gradient norms (SSD
                chunk 128: fault w's repair at the hybrid's widths).
              * encdec: whisper-medium whole (24 + 24 layers,
                1,012,314,112 params, 27 leaves), through the driver's
                CLI, each batch with JAX's 1500 stub frames a sample:
                4,049,256,448 bits a worker, 162 ``pack_update`` and 434
                ``threefry_uniform`` launches.
              * vlm: qwen2-vl-2b at full width with 8 of its 28 layers
                (841,131,520 params, 15 leaves), by ``cut_depth``, each
                batch with JAX's 1024 stub patches before the 128 tokens
                (M-RoPE positions): 3,364,526,080 bits a worker, 90
                ``pack_update`` and 58 ``threefry_uniform`` launches.
   Then the CLI at ``--smoke`` on the card for granite-moe, dbrx (their
              step lines carry the aux loss) and minicpm (``--schedule
              auto`` picks WSD and says so), 2 steps each
              (``cli_smoke``).
   Then, one process per worker: two gloo ranks sharing cuda:0 under
              ``torchrun`` (this script's ``--dist-child``), each rank's
              output in ``build/dist/<path>/rank<r>.log``:
              * dist_block_topk: the block-top-k path's flags, sparse
                all-gather of one byte buffer per round;
              * dist_pipelined: the pipelined path's flags, the all-gather
                started asynchronously and waited on before the next
                round's combine.
              Both at 4 of 24 layers since PR 31 (``cut_depth``), each
              against a one-process path of its flags and depth
              (``dist_block_topk_ref``, ``dist_pipelined_ref``).
              Rank 0 must print the exact bits and (pipelined) |g| = 0 at
              step 0; on every rank, every step's loss and params checksum
              must equal the one-process path's, and its launches must be
              as stated (42 ``pack_update`` per rank; pipelined also 42
              ``threefry_uniform``).  A rank that fails, or a launch not
              done in DIST_TIMEOUT_S (then killed with all its ranks),
              fails the run.
              * dist_fsdp: the smoke_flags path's flags and depth (4 of
                24 layers) with ``--trainer
                fsdp`` (the master state sharded over the two ranks by
                ``fsdp_specs``: every qwen2-0.5b leaf halves, the
                embedding by its columns).  At every step each rank's
                losses equal smoke_flags's, and the ranks' shards of
                params, w, h_avg, m and v, reassembled (``layout_sum``:
                every 32-bit word weighted by its logical flat index, a
                sum over the ranks), are bitwise smoke_flags's; each
                rank's resident state, counted leaf by leaf, within 1% of
                (5/2 + 1) x the params' bytes, the allocator's reading
                beside it; 42 ``pack_update`` and 42 + 85
                ``threefry_uniform`` a rank.
   Then the mesh paths (``MESH_PATHS``), gloo ranks sharing cuda:0,
              each against a one-process main path of the same flags and
              depth: ``mesh``, the smoke_flags path's flags on ``--mesh
              2x2`` (2 workers x 2-way tensor parallelism) with qwen2-0.5b
              cut to 4 of 24 layers (``cut_depth``; against
              ``mesh_ref``), its final checkpoint (``--ckpt-dir``: the
              params gathered over the model axis, rank 0 writing JAX's
              npz) bitwise the reassembled shards; ``mesh_fsdp``, the
              mesh path's flags under ``--trainer fsdp`` in the same
              launch (each rank's master trees its fsdp part, over the
              worker group, of its model shard), which must equal the
              mesh path bit for bit: every rank's losses and h, the
              master trees' layout sums over the ranks at every step, the
              final checkpoint, and each rank resident in exactly the
              fsdp-on-model specs' part (``fsdp_part_bytes``);
              ``mesh_heads``, the same flags on 1x4 with qwen2-0.5b at
              4 of 24 layers (3.5 query heads and half a KV head a rank;
              against ``mesh_heads_ref``); ``mesh_mamba2``, the mamba2
              path's flags on 1x2 with mamba2-130m at 12 of 24 layers (against
              ``mesh_mamba2_ref``).  Each: rank 0's exact bits, finite
              losses and raw gradient norms within 1e-3 relative of the
              reference's losses on every rank, its launches a rank, every
              master tree resident in exactly its shards' bytes, the two
              ranks of each model index bitwise equal in their shards of
              params, w, h_avg, m and v after every step (two workers),
              and the first worker's shards, reassembled, within the
              stated bound of the reference's final params
              (``mesh_params_check``); per rank the step ms, the host ms,
              calls and bytes sent of the model-axis collectives and of
              the worker exchange, and the peak, beside the card's name
              and power limit.  In the mesh_mamba2 launch,
              ``mesh_families``: every arch's smoke config in f32 on 1x2,
              its loss and gathered gradients against one rank on the
              card (1e-5 relative, 1e-4 of each leaf's largest entry), and
              granite-moe at full width cut to 2 layers (no leaf sharded)
              bitwise.  Then
              the four committed 2x2 specs (``examples/specs/``
              pipelined_blocktopk, qsgd_bidirectional, federated_blocktopk,
              tree_mixed_codecs)
              at smoke size in the four-rank launch of mesh and mesh_heads:
              each prints the file's fingerprint, its exact bits and four
              finite losses, with its launches per rank as MESH_SPECS
              says; and whether gloo's all-reduce takes a bf16 CUDA
              tensor.  In the same launch the three committed fsdp specs
              (zoo_qwen2_fsdp, zoo_mamba2_fsdp, finetune_moe) through the
              fine-tuning CLI (``launch.train finetune --spec ...
              --steps 2 --processes 4``): each prints the file's
              fingerprint, its exact up, down and total bits (the
              ``zoo_scaling`` rows of ``BENCH_bits.json``, ZOO_SPECS
              here), two finite losses and a finite eval loss, with its
              launches per rank as ZOO_SPECS says; then zoo_qwen2_fsdp and
              finetune_moe made 2x2 (``"mesh": "2x2", "n": 2``, written
              to build/spec/) with ``--processes 2`` (two processes of two
              ranks): the fingerprints and bits pinned against JAX's
              FinetuneLoop on the CPU (``FSDP_SPECS_2X2``), and no slab
              of h moved for an expert that a worker's gradients never
              touched.
   Then the fine-tuning harness in one process (``finetune``):
              ``launch.train.FinetuneLoop`` on ``finetune_moe.json`` at
              full width (granite-moe-3b-a800m cut to 4 of its 32 layers,
              d its tuning dim, the spec's 4 workers, the expert leaves'
              rules ``expert_sparse_rules`` of the cut tree): 3 steps,
              ``evaluate`` on one batch and a checkpoint restored bitwise;
              its exact bits, the expert leaves at exactly 1/5 of their
              dense bits, a finite eval loss; 120 ``pack_update`` and 73
              ``threefry_uniform`` launches.
   Then the compressor bench (``repro_torch.launch.compressor_bench``
              ``main(["--full"])``): every compressor and codec row at
              d = 2**16, the fused pack's device bytes on the embed leaf,
              and the dense kernels and the pack at the 14 full-width
              leaves (block/kb 256/16, 1024/16, 1024/64, 4096/64), whose
              untimed pass must launch each kernel exactly 14 times.
5. profile -- each path, one step on the host clock and one under
              torch.profiler: device time by kernel, busy share; the peak
              device memory of a step and of each of its phases; for the
              mamba2 and moe paths the device kernel time of the SSD scan
              and of the MoE dispatch, forward and backward, alone at the
              step's shapes, as a share of the step's; for the
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

6. serving -- through the driver's ``serve`` subcommand
              (``launch.train.main(["serve", ...])``), launch counts reset
              just before each run and read just after:
              * serve_fleet (the slice's main path): the replica fleet of
                qwen2-0.5b at full width and depth from JAX's weights (seed
                0), ``downlink: qsgd:16``, 2 replicas of 4 slots, prompts of
                16 and 16 generated tokens, 3 pushes (the spec written to
                ``build/spec/serve_fleet.json``): every replica's w bitwise
                the pusher's after each push (``run_fleet`` asserts it),
                3,952,262,720 delta bits against 15,809,048,704 checkpoint
                bits a push, 16 requests and 512 tokens, 285
                ``threefry_uniform`` launches (169 init, 42 QSGD uniforms,
                42 training-move normals, 32 prompt draws) and no other;
                tok/s, the largest stage and swap, the peak, and one decode
                step's host and device time, kernels and busy share;
              * serve_delta: the committed ``serve_delta.json`` (mamba2's
                smoke config), JAX's fingerprint 7d408c73e1bcf250 and bits
                2,734,560 / 10,935,936 (0.250053); the same spec with
                ``smoke: false`` (mamba2-130m whole), 1,031,868,512 /
                4,127,471,744; and one dropped push resynced bitwise from
                the pusher's checkpoints (``build/ckpt/serve_delta``);
              * serve_families: one smoke decode per family (dense, moe,
                ssm, hybrid, encdec, vlm), the card's greedy ids the CPU's
                up to a near tie, the card's engine (2 slots) its fixed
                batch's.
              Every threefry shape a serving path drew is held bitwise
              against the plain version on the card afterwards.
7. tooling -- ``sanitize``: JAX's two ``make sanitize-smoke`` commands
              on the card in one four-rank gloo launch (``--dist-child
              sanitize``): the train command on 2x2, as is then with
              ``--sanitize``, every rank's step and final losses bitwise
              the same, the sanitized run launching no kernel and the
              other launching ``pack_update``; then the finetune command
              (``finetune_moe.json``) runs as one process the same
              way (rank 1 sanitized, rank 3 as is, side by side), and
              rank 2 puts a NaN in a param leaf, which must raise
              FloatingPointError naming an aten op.
              ``dense_free``: ``kernels.ops.dense_free`` of the three pack
              kernels at JAX's cases' shapes and the full-width embed
              leaf, the device bytes above those held before each call
              within the declared outputs + 1 MiB.  ``dryrun``: the dry
              run of qwen2-0.5b at its four shapes on 16x16, then its
              prediction (argument + temp) for a 1x1 train step at global
              batch 8, sequence 128, against the same step's
              ``max_memory_allocated`` on the card: within 10%.
              ``compute-sanitizer`` (memcheck of the eight kernels,
              racecheck of those with shared memory, after a control
              program without PyTorch) is not in the default run: on the
              H100 machine it was written for the tool refuses the card
              ("Device not supported", and cudaMalloc fails) even for the
              control.  ``python3 chip_smoke.py --compute-sanitizer`` runs
              it alone.

The last lines are a JSON object per kernel (times, bound, launches), the
card's name and power limit, and the result line.  Needs one CUDA GPU and
the CUDA toolkit; imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
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
# schedulers (128 thread instructions).
H100_ISSUE_PER_S = H100_F32_OPS_PER_S / 2   # thread instructions, f32 ops
# SASS opcodes of the integer pipe, counted apart in the threefry draw's
# SASS; not a bound: the card ran 48.75 of them a value faster than the 64
# a clock per SM that the CUDA C++ Programming Guide gives (PERF.md §6)
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
    """Every kernel against its plain version, section by section; prints
    each section's seconds."""
    secs = {}

    def section(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        secs[fn.__name__] = time.perf_counter() - t
        return out

    pack_row = section(kernels_pack)
    qsgd_row = section(kernels_qsgd)
    randk_row = section(kernels_randk)
    threefry_row = section(kernels_threefry)
    section(kernels_permutation)
    dense_rows = section(kernels_dense)
    rows_rows = section(kernels_rows)
    shuffle_row = section(kernels_shuffle)
    print("[kernels] seconds by section: " + " ".join(
        f"{k}={v:.1f}" for k, v in secs.items()))
    return {"pack_update": pack_row, "qsgd_pack_update": qsgd_row,
            "randk_update": randk_row, "threefry_uniform": threefry_row,
            **dense_rows, **rows_rows, "shuffle_rows": shuffle_row}


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
    # one launch (1000 values) and bucketed (2**22 values); the four
    # children at once (each spends seconds reaching the card), each
    # trap in its own context
    cases = ((1000, 1000), (-1, 1000), (1 << 22, 1 << 22), (-5, 1 << 22))
    children = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--randk-trap-child",
         str(bad), str(size)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for bad, size in cases]
    try:
        for (bad, size), child in zip(cases, children):
            out, err = child.communicate(timeout=300)
            print(out.strip())
            if child.returncode != 3 or "launch failed" not in out:
                raise AssertionError(
                    f"[kernels] randk position {bad} of {size}: launch did "
                    f"not fail (exit {child.returncode}): {err[-2000:]}")
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.communicate()
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
#: the worker sum's layout edges (``ops.worker_sum_plan``): one window of
#: 17 + 16 rows, 1024 rows with no padding, two levels at 1025 and three
#: at 32**3 + 1, and the narrow layout's last row count and its neighbours
#: (the switch to the streamed column form, ``ops.SUM_NARROW_ROWS``), at
#: one column, a partial tile of 4 and the tiles around 32 and 112
SUM_EDGE_NS = (33, 1024, 1025)
SUM_BIG_NS = (32**3 + 1,)
SUM_EDGE_COLS = (1, 31, 33, 113)
#: a plain version's call above this many values is not timed (the
#: (1000, 2**20) loops take over a second a call)
PLAIN_TIMED_MAX = 2**24


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


def check_worker_sum(n, cols, kind, order, fuse, gen, dev, dgen):
    """``worker_sum`` of (n, cols) with weights of ``kind`` in ``order``
    (fused with the master update or not) against its plain version on
    the card, bitwise, on data with -0.0, inf and a NaN in the last
    worker's row (its mask is 0: 0 * NaN stays NaN); returns the max
    |kernel - plain|.  The data d and h are drawn on the card (``dgen``, a
    CUDA generator: a (1000, 2**20) draw on the host took seconds a case),
    the weights on the host (``gen``).  The plain version takes a host
    copy of an (n,) tensor of weights (the same values: its loop reads
    each row's weight, which from the card would cost a synchronisation a
    row)."""
    from repro_torch.kernels import ops, ref

    d = torch.randn(n, cols, generator=dgen, device=dev)
    d[0, :3] = torch.tensor([-0.0, float("inf"), -1.5], device=dev)[:cols]
    if kind in ("rows", "mask*scale"):
        d[n - 1, 1 % cols] = float("nan")
    w = sum_weights(n, kind, gen, dev)
    h = torch.randn(cols, generator=dgen, device=dev)
    c_g, c_h = f32(0.37 / n), f32(0.011 / n)
    args = (d, w) + ((h, c_g, c_h) if fuse else (None, 0.0, 0.0))
    k = ops.worker_sum(*args, order=order)
    if isinstance(w, torch.Tensor):
        args = (d, w.cpu()) + args[2:]
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
    ``ref.topk_rows`` (top-k's tie order); ``random.permutation_rows`` card
    against CPU is :func:`kernels_shuffle`'s."""
    import numpy as np

    from repro_torch import random
    from repro_torch.kernels import ops, ref, threefry

    dev = torch.device("cuda")
    secs, t0 = {}, time.perf_counter()

    def lap(label):
        nonlocal t0
        secs[label] = time.perf_counter() - t0
        t0 = time.perf_counter()

    per_value = sass_per_value("threefry", "threefry_rows_kernel")
    print(f"[kernels] threefry_rows SASS per value: {per_value[0]:.2f} "
          f"instructions, {per_value[1]:.2f} on the integer pipe, "
          f"{per_value[3]:.2f} IMADs on the FMA pipe")
    err_rows = {}
    draws = sorted(rows_cases(ROW_NS, (1, 7) + ROW_DS)
                   | rows_cases(MAIN_NS, MAIN_MS))
    for n, m in draws:
        err_rows[n, m] = max(check_threefry_rows(n, m, f, dev)
                             for f in (False, True))
        torch.cuda.empty_cache()
    print(f"[kernels] threefry_rows (n, m) in {draws}, words and uniforms: "
          "bitwise == plain, rows == the 1-D draw")
    lap("row_draws")
    err_sum = {}
    gen = torch.Generator(device="cpu").manual_seed(5)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    sums = sorted(rows_cases(ROW_NS, ROW_DS)
                  | rows_cases(MAIN_NS, [2 * m for m in MAIN_MS])
                  | set(SUM_EXTRA))
    for n, cols in sums:
        err_sum[n, cols] = max(
            check_worker_sum(n, cols, kind, order, fuse, gen, dev, dgen)
            for kind, order in SUM_KINDS for fuse in (False, True))
        torch.cuda.empty_cache()
    print(f"[kernels] worker_sum (n, cols) in {sums} (weights and orders "
          f"{SUM_KINDS}, each with and without the fused update): bitwise "
          "== plain; a NaN row under a zero mask stays NaN")
    lap("sums")
    edges = [(n, cols, kind, order, fuse)
             for n in SUM_EDGE_NS + SUM_BIG_NS for cols in SUM_EDGE_COLS
             for kind, order in SUM_KINDS for fuse in (False, True)
             if n not in SUM_BIG_NS or cols in (1, 113) and fuse]
    # at the switch (95,232 rows: the plain version's loop over them takes
    # about half a second a call): the windowed kinds at a partial tile,
    # fused, and the plain sum alone
    switch = tuple(ops.SUM_NARROW_ROWS + k for k in (-1, 0, 1))
    edges += [(n, 113, kind, order, kind is not None)
              for n in switch for kind, order in SUM_KINDS[:4]]
    layouts = collections.Counter()
    for n, cols, kind, order, fuse in edges:
        check_worker_sum(n, cols, kind, order, fuse, gen, dev, dgen)
        layouts[ops.worker_sum_plan(n, cols, order).layout] += 1
    torch.cuda.empty_cache()
    print(f"[kernels] worker_sum at the layouts' edges: n in "
          f"{SUM_EDGE_NS + SUM_BIG_NS + switch} x cols in {SUM_EDGE_COLS} "
          f"({len(edges)} cases; the switch at SUM_NARROW_ROWS = "
          f"{ops.SUM_NARROW_ROWS} rows), by layout {dict(layouts)}: bitwise "
          "== plain")
    lap("sum_edges")
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
                            reps=5) if n * m <= PLAIN_TIMED_MAX \
                else float("nan")
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
                p_ms = timed_ms(lambda: ref.worker_sum_ref(*args),
                                reps=5) if n * cols <= PLAIN_TIMED_MAX \
                    else float("nan")
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
                    dev_us = device_us(lambda: ops.worker_sum(*args),
                                       "worker_sum")
                    print(f"[kernels] worker_sum device time at {SUM_MAIN} "
                          f"{wname} fuse={fuse} (layout "
                          f"{ops.worker_sum_plan(*SUM_MAIN).layout}): "
                          f"{dev_us:.2f} us a call (profiler, 50 calls) "
                          f"beside kernel_ms={k_ms:.4f} (the wrapper, CUDA "
                          f"events) and torch_sum_ms={l_ms:.4f}")
            del d
            torch.cuda.empty_cache()
    lap("timing")
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
    lap("sorts")
    print("[kernels] rows seconds: " + " ".join(f"{k}={v:.1f}"
                                                for k, v in secs.items()))
    return timing


#: the row shuffle's cases beyond the reference's own shapes (MAIN_NS x
#: MAIN_MS, k in 1, 2 and m): rows of 1, 2 and 3 values (0 and 1 rounds),
#: one round's widest row (1625) and two rounds' narrowest (1626), the
#: fused route's widest row and the first past it (the sorts route), one
#: row, and 65,536 + 3 rows (the grid's rows loop)
SHUFFLE_CASES = ((16, 1, 1), (16, 2, 2), (16, 2, 1), (16, 3, 3), (16, 3, 1),
                 (16, 1625, 1625), (16, 1625, 7), (16, 1626, 1626),
                 (16, 1626, 3), (4, 16384, 16384), (4, 16384, 2),
                 (4, 16385, 16385), (4, 16385, 5), (1, 56, 1), (1, 56, 56),
                 (65539, 56, 1), (65539, 34, 34))
#: the shuffle's timed shapes: the committed spec's comp-(2, 32) at n = 16,
#: Figure 2's comp-(1, 34) and comp-(1, 56) at n = 1000 (the JSON line's)
SHUFFLE_TIMED = ((16, 32, 2), (1000, 34, 1), (1000, 56, 1))


def check_shuffle_rows(n, m, k, dev):
    """``threefry.shuffle_rows`` at (n, m, k) on the card against its plain
    version, bitwise, on the subkeys ``permutation_rows`` copies; the
    launch must take the plan's route (one ``shuffle_rows`` launch up to
    SHUFFLE_MAX_M, a ``threefry_rows`` launch a round above).  Returns the
    route."""
    from repro_torch import random
    from repro_torch.kernels import LAUNCHES, ref, threefry

    keys = random.split(random.fold_in(random.key(9), 7 * n + m), n)
    sub, _ = random._shuffle_keys(keys, m, dev)
    before = dict(LAUNCHES)
    got = threefry.shuffle_rows(sub, n, m, k)
    torch.cuda.synchronize()
    route = threefry.shuffle_plan(m)
    rounds = random.shuffle_rounds(m)
    took = {key: LAUNCHES[key] - before[key]
            for key in ("shuffle_rows", "threefry_rows")}
    want_took = {"shuffle_rows": int(route == "fused"),
                 "threefry_rows": 0 if route == "fused" else rounds}
    want = ref.shuffle_rows_ref(sub, n, m, k)
    if not (torch.equal(got, want) and took == want_took):
        raise AssertionError(f"[kernels] shuffle_rows ({n}, {m}, {k}) "
                             f"route {route}: kernel != plain or launches "
                             f"{took} != {want_took}")
    return route


def shuffle_sass():
    """(instructions a drawn key, a compare-exchange, a value permuted) in
    the row shuffle kernel's innermost loops (cuobjdump): the draw's holds
    the threefry rounds' 20 funnel shifts (SHF.L.W) and stores its key
    (STS.64); a compare-exchange's loads two keys (LDS.64); the permute's
    two move x through the key slots (LDS and STS, no LDS.64)."""
    (insts,) = sass_functions("threefry", "threefry_shuffle_rows_kernel")
    loops = sass_loops(insts)
    inner = [b for s, e, b in loops
             if not any((s2, e2) != (s, e) and s <= s2 and e2 <= e
                        for s2, e2, _ in loops)]

    def count(body, op):
        return sum(o == op for o in body)

    def rotates(body):
        return sum(o.startswith("SHF.L.W") for o in body)

    draw = [len(b) / count(b, "STS.64") for b in inner
            if rotates(b) >= 20 and count(b, "STS.64")]
    cmpx = [len(b) / (count(b, "LDS.64") / 2) for b in inner
            if count(b, "LDS.64") >= 2 and not rotates(b)]
    perm = [len(b) for b in inner if not count(b, "LDS.64")
            and not rotates(b) and any(o.startswith("LDS") for o in b)
            and any(o.startswith("STS") for o in b)]
    if not (draw and cmpx and perm):
        raise AssertionError(f"[kernels] shuffle_rows SASS: loops not "
                             f"found (draw {draw}, network {cmpx}, "
                             f"permute {perm})")
    return min(draw), min(cmpx), sum(perm)


#: a compare of two distinct 64-bit keys: the least SASS it takes, the low
#: words' ISETP and the high words' ISETP.EX
KEY_COMPARE_SASS = 2
#: a value moved from one round's order to the next: a load and a store
VALUE_MOVE_SASS = 2


def shuffle_work(n, m, k, sass):
    """(thread instructions, bytes) that one shuffle of (n, m) cut to k
    needs, whatever the algorithm: each round m draws at the kernel's SASS
    a drawn key (``sass[0]``: the threefry rounds, the least a word
    takes); every round but the last a comparison sort, log2(m!) compares,
    and a move of every value; the last round only the k smallest in
    order, max(m - 1, log2(m! / (m - k)!)) compares (the minimum alone
    needs m - 1), and no move; KEY_COMPARE_SASS a compare.  Bytes: the
    keys read (8 B a row a round) and the k columns written."""
    from repro_torch import random

    rounds = random.shuffle_rounds(m)
    log2_fact = math.lgamma(m + 1) / math.log(2)
    select = max(m - 1, log2_fact - math.lgamma(m - k + 1) / math.log(2))
    compares = (rounds - 1) * log2_fact + (select if rounds else 0)
    per_row = (sass[0] * m * rounds + KEY_COMPARE_SASS * compares
               + VALUE_MOVE_SASS * m * max(rounds - 1, 0))
    return n * per_row, 8 * rounds * n + 4 * n * k


def network_work(n, m, k, sass):
    """(thread instructions, bytes) of the kernel's own algorithm, for
    comparison with :func:`shuffle_work`: each round a draw and a permute
    of every value and the bitonic network's (p / 2) log p (log p + 1) / 2
    compare-exchanges over the padded power of two p, at the SASS counts
    ``sass``; the same bytes."""
    from repro_torch import random

    rounds = random.shuffle_rounds(m)
    lg = max(m - 1, 0).bit_length()
    stages = lg * (lg + 1) // 2
    draw, cmpx, perm = sass
    per_row = (draw + perm) * m + cmpx * (2 ** lg // 2) * stages
    return n * rounds * per_row, 8 * rounds * n + 4 * n * k


def kernels_shuffle():
    """The row shuffle (``threefry.shuffle_rows``: every sort round of
    ``permutation_rows``/``choice_rows`` and the cut in one launch) bitwise
    against its plain version on the card at the reference's shapes
    (MAIN_NS x MAIN_MS, k in 1, 2 and m) and SHUFFLE_CASES, both routes of
    ``shuffle_plan``; then
    ``permutation_rows``/``choice_rows`` card against CPU; then, at
    SHUFFLE_TIMED, the wrapper (CUDA events), the kernel's device time
    (profiler), the plain version, the sequence it replaced (a row draw,
    ``stable_order`` and ``gather`` a round, the cut) and a yardstick that
    is several calls and not bit-equal (``argsort`` of ``torch.rand``),
    beside the bound from the function's work (:func:`shuffle_work`) and,
    for comparison, the kernel's network's count (:func:`network_work`)."""
    from repro_torch import random
    from repro_torch.kernels import ref, threefry

    dev = torch.device("cuda")
    sass = shuffle_sass()
    cases = sorted({(n, m, k) for n in MAIN_NS for m in MAIN_MS
                    for k in (1, 2, m)} | set(SHUFFLE_CASES))
    routes = collections.Counter(check_shuffle_rows(n, m, k, dev)
                                 for n, m, k in cases)
    torch.cuda.empty_cache()
    print(f"[kernels] shuffle_rows (n, m, k) in {cases}: bitwise == plain, "
          f"by route {dict(routes)} (fused up to m = "
          f"{threefry.SHUFFLE_MAX_M})")
    if set(routes) != {"fused", "sorts"}:
        raise AssertionError(f"[kernels] shuffle_rows routes {routes}")
    # the plan owns the switch; the launcher refuses only a row that does
    # not fit a block's shared memory, which the first row past the plan's
    # limit does not
    from repro_torch.kernels import build

    over = threefry.SHUFFLE_MAX_M + 1
    sub, _ = random._shuffle_keys(random.split(random.key(3), 2), over, dev)
    out = torch.empty((2, 1), dtype=torch.int32, device=dev)
    err = build.launch(build.load("threefry").threefry_shuffle_rows, dev,
                       sub.data_ptr(), 2, over, 1,
                       random.shuffle_rounds(over), out.data_ptr())
    if err != 1:  # cudaErrorInvalidValue
        raise AssertionError(f"[kernels] shuffle_rows launcher at m = "
                             f"{over}: cudaError {err}, want 1 (the row "
                             "past the plan's limit does not fit)")
    print(f"[kernels] shuffle_rows launcher refuses m = {over} "
          "(cudaErrorInvalidValue: 8 B a padded slot and 4 B a value exceed "
          "a block's shared memory), the first row the plan sends to the "
          "sorts route")
    for n, m, k in ((1000, 56, 1), (1000, 34, 1), (16, 32, 2),
                    (1000, 112, 112), (16, 16385, 4), (16, 2**20, 2**20)):
        keys = random.split(random.key(m + 1), n)
        gpu = random.choice_rows(keys, m, k, "cuda").cpu()
        cpu = random.choice_rows(keys, m, k, "cpu")
        perm = k == m and torch.equal(
            random.permutation_rows(keys, m, "cuda").cpu(), cpu)
        if not torch.equal(gpu, cpu) or (k == m and not perm):
            raise AssertionError(f"[kernels] choice_rows/permutation_rows "
                                 f"({n}, {m}, {k}): card != CPU")
        print(f"[kernels] choice_rows ({n}, {m}, {k})"
              + (" and permutation_rows" if k == m else "")
              + f" rounds={random.shuffle_rounds(m)} route "
              f"{threefry.shuffle_plan(m)}: card == CPU bitwise")
    timing = None
    for n, m, k in SHUFFLE_TIMED:
        sub, _ = random._shuffle_keys(random.split(random.key(n), n), m,
                                      dev)
        k_ms = timed_ms(lambda: threefry.shuffle_rows(sub, n, m, k))
        dev_us = device_us(lambda: threefry.shuffle_rows(sub, n, m, k),
                           "shuffle_rows")
        p_ms = timed_ms(lambda: ref.shuffle_rows_ref(sub, n, m, k), reps=5)
        s_ms = timed_ms(lambda: random.shuffle_by_sorts(
            sub, n, m, k, threefry.threefry_rows))
        s_us = device_us(lambda: random.shuffle_by_sorts(
            sub, n, m, k, threefry.threefry_rows), "")
        y_ms = timed_ms(lambda: torch.argsort(
            torch.rand((n, m), device=dev), dim=1)[:, :k])
        bounds = []
        for work in (shuffle_work, network_work):
            ops, nbytes = work(n, m, k, sass)
            t_ops, t_bytes = (ops / H100_ISSUE_PER_S,
                              nbytes / H100_BYTES_PER_S)
            bounds.append((max(t_ops, t_bytes) * 1e3,
                           "bytes" if t_bytes >= t_ops else "operations",
                           ops / (n * random.shuffle_rounds(m) * m)))
        (b_ms, by, per_value), (n_ms, _, n_value) = bounds
        print(f"[kernels] shuffle_rows n={n} m={m} k={k}: kernel_ms="
              f"{k_ms:.4f} (wrapper, CUDA events) device_us={dev_us:.2f} "
              f"(profiler, 50 calls) plain_ms={p_ms:.4f} "
              f"sequence_ms={s_ms:.4f} sequence_device_us={s_us:.2f} (row "
              f"draw, stable_order, gather, cut) argsort_rand_ms={y_ms:.4f} "
              f"(not one call, not bit-equal) bound_ms={b_ms:.6f} ({by}; "
              f"the function's work, {per_value:.1f} SASS instructions a "
              f"value a round) network_bound_ms={n_ms:.6f} (the kernel's "
              f"bitonic network's count, {n_value:.1f} a value a round) "
              f"[{SMI}]")
        if (n, m) == ROWS_MAIN:
            timing = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": by, "max_abs_err": 0.0,
                      "library_ms": None, "yardstick_ms": y_ms,
                      "device_us": dev_us, "sequence_ms": s_ms}
    print(f"[kernels] shuffle_rows SASS: {sass[0]:.2f} instructions a "
          f"drawn key, {sass[1]:.2f} a compare-exchange, {sass[2]:.2f} a "
          "value permuted (the two permute loops)")
    return timing


def device_us(fn, name, calls=50):
    """Microseconds of device time a call of ``fn`` spends in kernels whose
    name holds ``name`` (torch.profiler over ``calls`` calls), apart from
    the wrapper's host time that CUDA events around a lone call also see."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.key) / calls


def store_loop_values(body):
    """Values one pass of a grid-stride store loop handles: 4 per 16-byte
    store it holds."""
    return 4 * sum(o.startswith("STG") and ".128" in o for o in body)


def sass_functions(lib, kernel):
    """The SASS of every function of the built library ``lib`` (a source's
    name, or the path of a library) whose name holds ``kernel``
    (cuobjdump), each as a list of (address, opcode) without NOPs."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    path = lib if isinstance(lib, Path) else build.lib_path(lib)
    text = subprocess.run([str(tool), "-sass", str(path)],
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
    """(instructions, integer-pipe instructions, opcode counts, IMADs: the
    FMA pipe's integer instructions) per value in the loop of ``kernel``,
    read from the SASS of the built library ``lib`` (cuobjdump).  The
    opcode counts key on the opcode's first word, and IMAD.WIDE apart.  A loop is the span of a backward branch;
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
                op = "IMAD.WIDE" if o.startswith("IMAD.WIDE") \
                    else o.split(".")[0]
                hist[op] = hist.get(op, 0) + 1
            ints = sum(c for o, c in hist.items() if o in INT_PIPE)
            imads = hist.get("IMAD", 0) + hist.get("IMAD.WIDE", 0)
            if best is None or len(body) / values < best[0]:
                best = (len(body) / values, ints / values,
                        {o: c / values for o, c in hist.items()},
                        imads / values)
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
    scheduler and clock.  Not its integer-pipe instructions at 64 per SM and
    clock: the card ran a loop of 48.75 of them a value in less time than
    that rate allows (PERF.md §6)."""
    t_bytes = 4 * n / H100_BYTES_PER_S
    t_ops = per_value[0] * n / H100_ISSUE_PER_S
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
          f"instructions, {per_value[1]:.2f} on the integer pipe, "
          f"{per_value[3]:.2f} IMADs on the FMA pipe; "
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
    data = StepBatches(SyntheticLM(vocab=cfg.vocab, seq_len=32,
                                   global_batch=8, n_workers=spec.n, seed=0),
                       cfg, 8)
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


#: the families phase: the ssm, moe, hybrid, encdec and vlm smoke configs,
#: card against CPU
FAMILY_ARCHS = ("mamba2-130m", "granite-moe-3b-a800m", "dbrx-132b",
                "zamba2-7b", "whisper-medium", "qwen2-vl-2b")
#: init on the card bitwise with the CPU's (mamba2's and zamba2's dt_bias
#: and A_log are XLA's f32 exp, expm1 and log, emulated)
FAMILY_INIT = ("mamba2-130m", "granite-moe-3b-a800m", "zamba2-7b",
               "whisper-medium", "qwen2-vl-2b")


def family_spec(arch, cfg, **fields):
    from repro_torch.core import ExperimentSpec

    kw = dict(compressor="block_topk:256,16", agg="sparse_allgather",
              backend="shard_map", problem=arch, smoke=True, mesh="2x1", n=2,
              d=max(cfg.d_model * max(cfg.d_ff, 1), 1), steps=ZOO_STEPS)
    return ExperimentSpec(**{**kw, **fields})


def fixed_routing_check(cfg, params):
    """The fixed-routing MoE regime on the card: with every router zero,
    each layer's expert gradients are nonzero for experts 0..k-1 only
    (``expert_activity_mask``), as on the CPU.  Then one step of the
    trainer with ``grad_transform=zero_inactive_expert_grads``, card
    against CPU: the loss within 1e-5 relative and the params after the
    step within AdamW's bound.  Then the hook with an explicit mask that
    drops active expert 0 (AdamW without weight decay): on the card that
    expert's slabs come out of the step bitwise unchanged, while those of
    experts 1..k-1 move."""
    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.core import build
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.train.trainer import value_and_grad

    fixed = L.fixed_routing_params(params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8,
                       n_workers=2, seed=0)
    model = build_model(cfg)
    k = cfg.experts_per_tok
    want = torch.arange(cfg.n_experts) < k
    batch = {key: torch.as_tensor(v[:4]).cuda()
             for key, v in data.batch(0).items()}
    _, grads = value_and_grad(model.loss, T.tree_map(lambda p: p.cuda(),
                                                     fixed), batch)
    mask = L.expert_activity_mask(grads["layers"]["moe"]).cpu()
    if not bool((mask == want).all()):
        raise AssertionError(f"[families] fixed routing: active experts "
                             f"{mask.tolist()}, want the first {k}")
    spec = family_spec("granite-moe-3b-a800m", cfg, steps=1)
    lr = 3e-4

    def one_step(dev, weight_decay, hook):
        run_ = build(spec)
        opt = adamw(constant(lr), weight_decay=weight_decay)
        state = run_.init_state(
            T.tree_map(lambda p: p.to(dev).clone(), fixed), opt)
        step = run_.train_step(model.loss, opt, grad_transform=hook)
        state, m = step(state, data.batch(0),
                        random.fold_in(random.key(0), 0))
        return float(m["loss"]), state.params

    (cpu, pc), (gpu, pg) = (one_step(dev, 0.01, L.zero_inactive_expert_grads)
                            for dev in ("cpu", "cuda"))
    bound = 2.02 * lr
    worst = max(float((b.cpu() - a).abs().max())
                for a, b in zip(T.leaves(pc), T.leaves(pg)))
    drop = want.clone()
    drop[0] = False
    drop = drop.expand(cfg.n_layers, -1).cuda()
    _, pm = one_step("cuda", 0.0,
                     lambda g: L.zero_inactive_expert_grads(g, drop))
    kept = all(same_bits(pm["layers"]["moe"][n][:, 0].cpu(),
                         fixed["layers"]["moe"][n][:, 0])
               for n in L.EXPERT_LEAVES)
    moved = all(not same_bits(pm["layers"]["moe"][n][:, 1:k].cpu(),
                              fixed["layers"]["moe"][n][:, 1:k])
                for n in L.EXPERT_LEAVES)
    print(f"[families] fixed routing: every layer's active experts "
          f"{mask[0].tolist()} on the card; one step with "
          f"grad_transform=zero_inactive_expert_grads: loss cpu={cpu} "
          f"gpu={gpu}, params max |diff| {worst:.3e} (bound {bound:.3e}); "
          f"the hook dropping active expert 0: its slabs "
          f"{'unchanged' if kept else 'CHANGED'} by the step, experts "
          f"1..{k - 1}'s {'moved' if moved else 'NOT moved'}")
    if abs(cpu - gpu) > 1e-5 * abs(cpu) or not worst <= bound:
        raise AssertionError("[families] fixed routing: card vs CPU")
    if not (kept and moved):
        raise AssertionError("[families] fixed routing: grad_transform's "
                             "mask not seen in the step's update")


def ssd_gradient_check():
    """Fault w on the card: one full-width mamba2-130m layer (layer 0 of
    ``Model.init(random.key(0))``, chunk 128) at the mamba2 path's
    sequence, 512, on x ~ N(0, 1): every gradient of <y, r> (r ~ N(0, 1))
    finite.  The data reach the fault: above the diagonal the same layer's
    decay sums pass f32 exp's overflow, where JAX's literal
    ``where(causal, exp(diff), 0)`` (``mamba2.py:98``) has a non-finite
    gradient."""
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model

    cfg = get_config("mamba2-130m")
    params = build_model(cfg).init(random.key(0), device="cuda")
    p = {n: v[0].clone().requires_grad_(True)
         for n, v in params["layers"]["mamba"].items()}
    del params
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, Q, H = 2, 512, cfg.ssm_chunk, cfg.ssm_heads()
    x = torch.randn((B, S, cfg.d_model), device="cuda", generator=gen,
                    requires_grad=True)
    r = torch.randn((B, S, cfg.d_model), device="cuda", generator=gen)
    y = L.mamba2_apply(p, x, d_inner=cfg.d_inner(), d_state=cfg.ssm_state,
                       n_heads=H, chunk=Q, norm_eps=cfg.norm_eps)
    (y * r).sum().backward()
    bad = [n for n, v in p.items() if not bool(torch.isfinite(v.grad).all())]
    bad += [] if bool(torch.isfinite(x.grad).all()) else ["x"]
    with torch.no_grad():
        dt = L.softplus((x @ p["wdt"]).float() + p["dt_bias"])
        cum = (dt * -torch.exp(p["A_log"])).reshape(B, S // Q, Q, H)
        cum = cum.cumsum(2)
    diff = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).requires_grad_()
    idx = torch.arange(Q, device="cuda")
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    upper = float(diff.detach().masked_fill(causal, -math.inf).max())
    torch.where(causal, torch.exp(diff), 0.0).sum().backward()
    literal = int((~torch.isfinite(diff.grad)).sum())
    print(f"[families] fault w on the card: one full-width mamba2 layer "
          f"(chunk {Q}, seq {S}): decay sums above the diagonal up to "
          f"{upper:.1f} (f32 exp overflows above 88.72), JAX's literal "
          f"form has {literal} non-finite gradient values there; the "
          f"port's gradients of x and of the {len(p)} leaves "
          f"{'finite' if not bad else 'NOT finite: ' + str(bad)}")
    if bad or not upper > 88.72 or not literal:
        raise AssertionError("[families] fault w: the SSD's gradient on "
                             "the card")


def phase_families():
    """The ssm, moe, hybrid, encdec and vlm families at smoke size: the
    initial trees of FAMILY_INIT drawn on the card bitwise equal to the
    CPU's; two steps of ``build(spec)``'s trainer (block-top-k up; the
    encdec's frames and the vlm's vision embeddings in every batch) on the
    card and on the CPU for each of FAMILY_ARCHS, held to each other as
    the zoo phase holds its cases (losses within 1e-5 relative, params
    within AdamW's bound); the fixed-routing MoE regime; and, first, fault
    w's repair at full width (``ssd_gradient_check``)."""
    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.core import build
    from repro_torch.models.model import build_model
    from repro_torch.optim.schedules import cosine

    t0 = time.perf_counter()
    ssd_gradient_check()
    torch.cuda.empty_cache()
    sched = cosine(3e-4, total_steps=ZOO_STEPS, warmup_steps=0)
    bound = 2.02 * sum(sched(t) for t in range(ZOO_STEPS))
    for arch in FAMILY_ARCHS:
        cfg, params = smoke_params(arch)
        if arch in FAMILY_INIT:
            card = build_model(cfg).init(random.key(0), device="cuda")
            bad = ["/".join(p) for (p, a), b in zip(
                T.flatten_with_path(card), T.leaves(params))
                if not same_bits(a.cpu(), b)]
            print(f"[families] init: {cfg.name} from random.key(0) on the "
                  f"card {'bitwise equal to' if not bad else 'NOT equal to'}"
                  f" the CPU's ({len(T.leaves(card))} leaves)")
            if bad:
                raise AssertionError(f"[families] {cfg.name} init differs "
                                     f"on {bad}")
            del card
        spec = family_spec(arch, cfg)
        bits = build(spec).round_bits(params)
        cpu, pc = zoo_steps(spec, cfg, params)
        gpu, pg = zoo_steps(spec, cfg, T.tree_map(lambda p: p.cuda(),
                                                  params))
        loss_err = max(abs(a - b) / abs(a) for a, b in zip(cpu, gpu))
        diff = torch.cat([(b.cpu() - a).abs().reshape(-1)
                          for a, b in zip(T.leaves(pc), T.leaves(pg))])
        worst = float(diff.max())
        share = float((diff > 1e-5).float().mean())
        print(f"[families] {cfg.name}: bits up={bits['up']}; losses cpu="
              f"{cpu} gpu={gpu} max rel diff {loss_err:.3e} (limit 1e-5); "
              f"params max |diff| {worst:.3e} (bound {bound:.3e}), share > "
              f"1e-5 {share:.5f}")
        if not (all(map(math.isfinite, gpu)) and loss_err <= 1e-5
                and worst <= bound):
            raise AssertionError(f"[families] {cfg.name}: card vs CPU "
                                 "beyond the CPU tests' tolerance")
        if arch == "granite-moe-3b-a800m":
            fixed_routing_check(cfg, params)
    print(f"[families] {len(FAMILY_ARCHS)} archs in "
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
    f32 leaf: each round one row shuffle of k' (every sort round, for all
    n workers at once; a row draw per sort round where k' is wider than the
    fused kernel takes) and one ordered worker sum with the master update
    fused; none of it depends on n."""
    from repro_torch import random
    from repro_torch.kernels import threefry

    if threefry.shuffle_plan(comp.kp) == "fused":
        return {"shuffle_rows": rounds, "worker_sum": rounds}
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
    return launches / PROFILE_ROUNDS, copies / PROFILE_ROUNDS


def recording_kernel_shapes():
    """Wrap the row draw's, the row shuffle's and the worker sum's wrappers
    so that every call on the card notes its shape (and as_float; the cut
    k; weights, order, fusion).  Returns (the notes, a function that
    restores the wrappers)."""
    from repro_torch.kernels import ops, threefry

    seen = {"threefry_rows": set(), "shuffle_rows": set(),
            "worker_sum": set()}
    rows, shuffle, wsum = (threefry.threefry_rows, threefry.shuffle_rows,
                           ops.worker_sum)

    def rows_noted(keys, m, as_float):
        if keys.is_cuda:
            seen["threefry_rows"].add((keys.shape[0], m, bool(as_float)))
        return rows(keys, m, as_float)

    def shuffle_noted(keys, n, m, k):
        if keys.is_cuda:
            seen["shuffle_rows"].add((n, m, k))
        return shuffle(keys, n, m, k)

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
        threefry.threefry_rows, threefry.shuffle_rows, ops.worker_sum = \
            rows, shuffle, wsum

    threefry.threefry_rows, threefry.shuffle_rows, ops.worker_sum = \
        rows_noted, shuffle_noted, sum_noted
    return seen, restore


def check_main_shapes(seen):
    """Each (shape, form) the main path gave the reference kernels, held
    bitwise against its plain version on the card on fresh data of that
    shape (after the launch counts are read)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(7)
    dgen = torch.Generator(device="cuda").manual_seed(7)
    for n, m, as_float in sorted(seen["threefry_rows"]):
        check_threefry_rows(n, m, as_float, dev)
    for n, m, k in sorted(seen["shuffle_rows"]):
        check_shuffle_rows(n, m, k, dev)
    for n, cols, kind, order, fuse in sorted(seen["worker_sum"], key=str):
        check_worker_sum(n, cols, kind, order, fuse, gen, dev, dgen)
    torch.cuda.empty_cache()
    print(f"[reference-spec] the main path's own shapes, each bitwise == "
          f"plain on the card: threefry_rows (n, m, as_float) "
          f"{sorted(seen['threefry_rows'])}; shuffle_rows (n, m, k) "
          f"{sorted(seen['shuffle_rows'])}; worker_sum (n, cols, weights, "
          f"order, fused) {sorted(seen['worker_sum'], key=str)}")
    if not (seen["shuffle_rows"] and seen["worker_sum"]):
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
    shuffle of comp's positions (``shuffle_rows``: every sort round and
    the cut) and one ordered worker sum (``worker_sum``);
    ``threefry_uniform`` draws only the problems.  Launch counts are reset
    just before and read just after (the profiled run is not counted);
    only the card's runs launch.  Every shape the runs give the kernels is
    noted and, after the counts are read, held bitwise against the plain
    version (``check_main_shapes``).  A line sums up a round: launches and
    key copies (the profile), ms at n = 16 (a) and n = 1000 (c)."""
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
    round_ms = {}
    for dev in ("cuda", "cpu"):
        res, ms, prob, f_star = reference_case(run, dev)
        round_ms[spec.n, dev] = ms
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
            round_ms[FIG2["n"], dev, mode] = ms
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
            per_round = profile_reference_round(frun, probs["cuda"],
                                                gamma_c, f_star_c)
            torch.cuda.synchronize()
            LAUNCHES.update(saved)
    torch.cuda.synchronize()
    print(f"[reference-spec] (c) launches of the two n = {FIG2['n']} runs "
          f"of {FIG2['steps']} rounds: "
          f"{ {k: LAUNCHES[k] - before[k] for k in LAUNCHES} } (a loop "
          f"over the workers would launch threefry_uniform n x rounds = "
          f"{2 * FIG2['n'] * FIG2['steps']})")
    print(f"[reference-spec] a round on the card: {per_round[0]:.1f} "
          f"launches and {per_round[1]:.1f} key copies (profiled, n = "
          f"{FIG2['n']}); {round_ms[spec.n, 'cuda']:.3f} ms at n = {spec.n} "
          f"(a), {round_ms[FIG2['n'], 'cuda', 'efbv']:.3f} ms EF-BV and "
          f"{round_ms[FIG2['n'], 'cuda', 'ef21']:.3f} ms EF21 at n = "
          f"{FIG2['n']} (c) [{SMI}]")
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


#: each arch's smoke config and JAX initial weights, drawn once a process
#: (a few MB each; the CPU's draw took 0.3-1.7 s an arch)
SMOKE_PARAMS = {}


def smoke_params(arch="qwen2-0.5b"):
    """(the arch's smoke config with f32 activations, a copy of its JAX
    initial weights on the host)."""
    import dataclasses
    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model

    if arch not in SMOKE_PARAMS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  activation_dtype="float32")
        SMOKE_PARAMS[arch] = (cfg, build_model(cfg).init(random.key(0),
                                                         device="cpu"))
    cfg, params = SMOKE_PARAMS[arch]
    return cfg, T.tree_map(torch.clone, params)


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


def layout_sum(tree, shards=None, replica=False, slots=False):
    """A checksum of a master tree's bits that sums over the ranks' parts:
    for each leaf j, the sum of its 32-bit words times (1 + the word's
    flat index in the logical leaf mod 65521), weighted by j + 1, all mod
    2**64.  ``shards`` (a rank's ``ModelShards`` or ``FsdpShards``) places
    this rank's tensor in the logical leaf by the dims that its axes split
    (the model spec's, the fsdp dim, or both); a leaf that an axis does
    not split counts on that axis's rank 0 only, and a ``replica`` (a
    mesh rank of a worker group other than the first, whose shards repeat
    the first's) counts nowhere; ``slots`` (m, v, h_avg) places them by
    their own layout (``slot_dims``).  Without shards, the whole tree."""
    from repro_torch import tree as T

    if replica:
        return 0
    cuts = []  # (dims a leaf, axis): each axis that splits the tree
    if shards is not None:
        fsdp = not shards.shards_worker_state
        model = shards.model if fsdp else shards
        if model is not None:
            cuts.append((model.slot_dims if slots else model.dims,
                         model.axis))
        if fsdp:
            cuts.append((shards.slot_dims if slots else shards.dims,
                         shards.axis))
    total = 0
    for j, x in enumerate(T.leaves(tree)):
        shape = tuple(x.shape) if shards is None else shards.shape(j)
        offsets = [0] * len(shape)
        if any(dims[j] is None and axis.rank for dims, axis in cuts):
            continue
        for dims, axis in cuts:
            if dims[j] is not None:
                offsets[dims[j]] = axis.rank * x.shape[dims[j]]
        # the logical flat index of each word of this rank's part
        idx = torch.zeros((), dtype=torch.int64, device=x.device)
        stride = 1
        for d in reversed(range(len(shape))):
            view = [1] * len(shape)
            view[d] = x.shape[d]
            idx = idx + (torch.arange(x.shape[d], device=x.device,
                                      dtype=torch.int64)
                         + offsets[d]).view(view) * stride
            stride *= shape[d]
        idx = idx.reshape(-1) % 65521 + 1
        words = x.detach().contiguous().view(torch.int32).reshape(-1)
        total = (total + (j + 1) * int((words.to(torch.int64) * idx).sum())
                 ) & MASK64
        del idx, words
    return total


@contextlib.contextmanager
def recording(records, holder=None, layout=False):
    """While open, every train step that ``launch.train`` builds (through
    ``Run.train_step``, which looks ``trainer.make_train_step`` up at each
    call) appends {loss (hex), the workers' mean raw gradient norm
    (``grad_norm``, before compression), params checksum, step ms} and,
    over a group,
    the host ms and bytes of its exchange, to ``records``; the step is
    timed between synchronisations, before the checksum.  On a mesh rank
    (a group with a ``model`` axis) also the host ms, calls and bytes sent
    of its model-axis collectives, and checksums of its shards of the
    master state (params, w, h_avg, AdamW's m and v).  ``holder["state"]``
    keeps the newest state; a recorded step's ``unrecorded`` is the step
    function the trainer built.  The fsdp trainer's steps
    (``make_train_step_fsdp``) too, with the host ms, calls and bytes of
    their gathers over the worker group in the model axis's fields, or on
    a model axis in ``fsdp_*`` (the first stage, over the worker group)
    and ``fsdp_model_*`` (the second, over the model axis); with
    ``layout`` each record also holds the ``layout_sum`` of params, w,
    h_avg, m and v."""
    from repro_torch.train import trainer as train

    makers = {"make_train_step": train.make_train_step,
              "make_train_step_fsdp": train.make_train_step_fsdp}

    def recorded(make, *args, **kwargs):
        step_fn = make(*args, **kwargs)
        shards = getattr(step_fn, "shards", None)
        group = kwargs.get("group")
        tp = None if group is None else group.model
        fsdp = shards is not None and not shards.shards_worker_state
        # the collectives counted apart, by field prefix: the model axis's
        # (or without one the fsdp gathers over the worker group), and on
        # a model axis the fsdp gathers' two stages
        axes = {"model": shards.axis if fsdp and tp is None else tp}
        if fsdp and tp is not None:
            axes.update(fsdp=shards.axis, fsdp_model=shards.model_axis)
        axes = {k: a for k, a in axes.items() if a is not None}
        # a mesh rank of another worker group than the first holds a copy
        # of the first's shards
        replica = tp is not None and not fsdp and group.rank > 0

        def step(state, batch, key):
            torch.cuda.synchronize()
            stats = dict(group.stats) if group is not None else None
            before = {k: dict(a.stats) for k, a in axes.items()}
            t0 = time.perf_counter()
            state, m = step_fn(state, batch, key)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rec = {"loss": loss.hex(), "grad_norm": float(m["grad_norm"]),
                   "step_ms": round(
                (time.perf_counter() - t0) * 1e3, 2)}
            if group is not None:
                rec["exchange_ms"] = round(1e3 * (group.stats["exchange_s"]
                                                  - stats["exchange_s"]), 2)
                rec["bytes"] = group.stats["bytes"] - stats["bytes"]
            for k, a in axes.items():
                rec[f"{k}_ms"] = round(1e3 * (a.stats["model_s"]
                                              - before[k]["model_s"]), 2)
                rec[f"{k}_calls"] = (a.stats["model_calls"]
                                     - before[k]["model_calls"])
                rec[f"{k}_bytes"] = (a.stats["model_bytes"]
                                     - before[k]["model_bytes"])
            if tp is not None:
                rec["master"] = {
                    "params": params_checksum(state.params),
                    "w": params_checksum(state.w),
                    "h_avg": params_checksum(state.h_avg),
                    "m": params_checksum(state.opt_state["m"]),
                    "v": params_checksum(state.opt_state["v"])}
            rec["checksum"] = params_checksum(state.params)
            if layout:
                trees = {"params": state.params, "w": state.w,
                         "h_avg": state.h_avg, "m": state.opt_state["m"],
                         "v": state.opt_state["v"]}
                rec["layout"] = {k: layout_sum(trees[k], shards, replica,
                                               slots=k in SLOT_TREES)
                                 for k in LAYOUT_TREES}
            records.append(rec)
            if holder is not None:
                holder["state"], holder["shards"] = state, shards
            return state, m
        step.unrecorded = step_fn
        step.shards = shards
        return step

    for name, make in makers.items():
        setattr(train, name, functools.partial(recorded, make))
    try:
        yield
    finally:
        for name, make in makers.items():
            setattr(train, name, make)


def dist_child():
    """``--dist-child NAME DIR``: one rank under torchrun, its output in
    DIR/rank<RANK>.log.  ``reference``: :func:`dist_reference_child`;
    a MESH_LAUNCHES name: its mesh paths (:func:`mesh_path_child`) and
    checks; a DIST_PATHS name: that path through ``launch.train.main`` with launch
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
    if name == "sanitize":
        sanitize_rank(outdir)
        return 0
    if name in MESH_LAUNCHES:
        # the launch's mesh paths one after the other, each between
        # marker lines, then its other checks
        launch = MESH_LAUNCHES[name]
        for sub in launch["paths"]:
            t0 = time.perf_counter()
            print(f"[dist] begin {sub}", flush=True)
            mesh_path_child(sub, outdir, rank)
            print(f"[dist] seconds {time.perf_counter() - t0:.1f}")
            print(f"[dist] end {sub}", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        if launch.get("families"):
            mesh_families_child(outdir)
        if launch.get("specs"):
            mesh_specs_child(outdir)
        return 0
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    records, holder = [], {}
    path = DIST_PATHS[name]
    torch.cuda.reset_peak_memory_stats()
    with recording(records, holder, layout=path.get("layout", False)), \
            cut_depth(path.get("layers")):
        reset_launches()
        train.main(path["argv"])
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    print(f"[dist] records {json.dumps(records)}")
    print(f"[dist] launches {json.dumps(launches)}")
    print(f"[dist] peak_gib {torch.cuda.max_memory_allocated() / 2**30:.2f}")
    if path.get("layout"):
        from repro_torch import tree as T
        st = holder["state"]
        trees = (st.params, st.w, st.h_avg, st.opt_state["m"],
                 st.opt_state["v"], st.h)
        resident = sum(x.numel() * x.element_size() for t in trees
                       for x in T.leaves(t))
        gc.collect()
        print(f"[dist] resident_bytes {resident} allocated "
              f"{torch.cuda.memory_allocated()}")
        print(f"[dist] fsdp_dims {json.dumps(holder['shards'].dims)}")
    return 0


def mesh_path_child(name, outdir, rank):
    """One rank of a mesh path (``MESH_PATHS[name]``) through
    ``launch.train.main`` (its own file store, cut by ``cut_depth`` to the
    path's depth), launch counts reset just before it and read just
    after; then its step records (with ``layout``, the master trees'
    layout sums), launches, peak memory, every master tree's resident
    bytes against its shards' (an fsdp rank's: its parts') and the
    logical tree's, a checksum of h and whether it holds the worker's
    model shards, and, on the first worker group's ranks of a mesh path
    without fsdp, the params shards for the parent to reassemble."""
    from repro_torch import tree as T
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    path = MESH_PATHS[name]
    records, holder = [], {}
    torch.cuda.reset_peak_memory_stats()
    with recording(records, holder, layout=path.get("layout", False)), \
            cut_depth(path.get("layers")):
        reset_launches()
        train.main(path["argv"] + ["--dist-init",
                                   f"file://{outdir}/store_{name}"])
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    print(f"[dist] records {json.dumps(records)}")
    print(f"[dist] launches {json.dumps(launches)}")
    print(f"[dist] peak_gib {torch.cuda.max_memory_allocated() / 2**30:.2f}")
    st, shards = holder.pop("state"), holder.pop("shards")
    # every master tree holds this rank's shards, never a whole leaf that
    # the specs shard: its bytes, counted leaf by leaf, against the
    # shards' and the logical tree's
    from repro_torch.distributed import wire

    want = sum(4 * math.prod(shards.shard_shape(j))
               for j in range(len(shards.dims)))
    # m, v and h_avg: JAX's layout (each leaf as the first of its shape)
    slots = sum(4 * math.prod(shards.slot_shape(j))
                for j in range(len(shards.dims)))
    logical = sum(4 * math.prod(shards.shape(j))
                  for j in range(len(shards.dims)))
    trees = {"params": st.params, "w": st.w, "h_avg": st.h_avg,
             "m": st.opt_state["m"], "v": st.opt_state["v"]}
    resident = {k: sum(x.numel() * x.element_size() for x in T.leaves(t))
                for k, t in trees.items() if t is not None}
    paths = wire.leaf_paths(shards.logical)
    moved = [paths[j] for j in range(len(paths)) if not shards.same_slot(j)]
    print(f"[dist] resident {json.dumps(resident)} shards {want} slots "
          f"{slots} logical {logical} sharded_leaves "
          f"{sum(d is not None for d in shards.dims)} of "
          f"{len(shards.dims)}")
    print(f"[dist] slots moved {json.dumps(moved)}")
    # a worker's h_i: its model shards, under fsdp as on the mesh
    fsdp = not shards.shards_worker_state
    model = shards.model if fsdp else shards
    h_shards = all(tuple(x.shape[1:]) == model.shard_shape(j)
                   for j, x in enumerate(T.leaves(st.h)))
    print(f"[dist] h {params_checksum(st.h)} model_shards {h_shards}")
    if fsdp:
        print(f"[dist] fsdp_dims {json.dumps(shards.dims)}")
    elif rank < path["m"]:
        torch.save(T.tree_map(lambda a: a.cpu(), st.params),
                   outdir / f"params_{name}_rank{rank}.pt")


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
#: qwen2-0.5b at full width cut to 4 of its 24 layers (smoke_flags,
#: dist_fsdp and mesh_heads: cut to 12 to keep the run's time with
#: mesh_fsdp, to 4 with the tooling phases and remat's recomputed
#: forwards): its bits a worker up (block_topk:256,16) and down
#: (qsgd:16), and its init's draws
HALF_LAYERS = 4
HALF_BITS = (783_140_864, 1_566_281_152)
HALF_INIT_DRAWS = 1 + HALF_LAYERS * 7
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
        "layers": HALF_LAYERS,
        "bits": {r"(\d+) bits/round/worker": [HALF_BITS[0]],
                 r"downlink (\d+) bits/round broadcast": [HALF_BITS[1]],
                 r"total (\d+) bits/round up\+down":
                 [WORKERS * HALF_BITS[0] + HALF_BITS[1]]},
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0,
                     "threefry_uniform": STEPS * FULL_LEAVES
                     + HALF_INIT_DRAWS},
        "profile": None,
        "keep_params": True,
        # dist_fsdp's reference: the master trees' layout sums each step
        "layout": True,
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
#: the ssm and moe main paths: mamba2-130m at full width and depth, and
#: granite-moe-3b-a800m at full width with 4 of its 32 layers (cut from 8
#: to keep the run's time with the serving paths)
MAMBA2_BITS = 515_936_256       # mamba2-130m, block_topk:256,16, per worker
MAMBA2_LEAVES, MOE_LEAVES = 15, 13
MOE_BITS = 2_215_667_712        # granite-moe 4 layers, block_topk:256,16
MOE_LAYERS = 4
#: the inits' threefry draws: mamba2's embedding and 8 a layer (5 normal
#: projections, dt_bias's uniform, conv_w, wo); granite-moe's embedding,
#: untied head and 8 a layer (4 attention and 4 expert weights)
MAMBA2_INIT_DRAWS = 1 + 24 * 8
#: mamba2-130m cut to 12 of its 24 layers (mesh_mamba2 and its
#: reference, since PR 31): its bits a worker and its init's draws
MAMBA2_HALF_LAYERS = 12
MAMBA2_HALF_BITS = 335_201_280
MAMBA2_HALF_INIT_DRAWS = 1 + MAMBA2_HALF_LAYERS * 8
#: the smoke config's (2 layers)
SMOKE_MAMBA2_INIT_DRAWS = 1 + 2 * 8
MOE_INIT_DRAWS = 2 + MOE_LAYERS * 8
#: the mamba2 path's checkpoints (one a step, JAX's npz format)
CKPT_DIR = ROOT / "build" / "ckpt" / "mamba2"


def arch_argv(arch, seq=128):
    """BASE_ARGV with another arch and sequence length."""
    out = list(BASE_ARGV)
    out[out.index("--arch") + 1] = arch
    out[out.index("--seq") + 1] = str(seq)
    return out


PATHS.update({
    # 4 chunks of 128 a sequence: the inter-chunk recurrence carries state
    "mamba2": {
        "argv": arch_argv("mamba2-130m", seq=512)
        + ["--compressor", "block_topk:256,16", "--ckpt-dir", str(CKPT_DIR),
           "--ckpt-every", "1"],
        "vocab": 50280,
        "bits": {r"(\d+) bits/round/worker": [MAMBA2_BITS],
                 r"checkpoint @ (\d+)": [1, 2, 3]},
        "finite": (r"\|g\|=(\S+)", r"h_res=(\S+)"),
        "launches": {"pack_update": MAMBA2_LEAVES * WORKERS * STEPS,
                     "qsgd_pack_update": 0, "randk_update": 0,
                     "threefry_uniform": MAMBA2_INIT_DRAWS},
        "profile": ("pack_update_rows",),
        "checkpoint": CKPT_DIR,
        "op": "ssd_chunked",
    },
    # the driver has no depth flag (nor has JAX's): its setup and loop on
    # the config cut to 4 layers (``cut_depth``)
    "moe": {
        "argv": arch_argv("granite-moe-3b-a800m")
        + ["--compressor", "block_topk:256,16"],
        "layers": MOE_LAYERS,
        "vocab": 49155,
        "bits": {r"(\d+) bits/round/worker": [MOE_BITS]},
        "finite": (r"\|g\|=(\S+)", r"h_res=(\S+)", r"aux_loss=(\S+) "),
        "launches": {"pack_update": MOE_LEAVES * WORKERS * STEPS,
                     "qsgd_pack_update": 0, "randk_update": 0,
                     "threefry_uniform": MOE_INIT_DRAWS},
        "profile": ("pack_update_rows",),
        "op": "dispatch_groups",
    },
})
#: the hybrid, encdec and vlm main paths: zamba2-7b at full width with 12
#: of its 81 layers (the shared attention block after layers 5 and 11),
#: whisper-medium whole (24 + 24 layers, 1500 frames) and qwen2-vl-2b at
#: full width with 8 of its 28 layers (1024 patches before 128 tokens;
#: cut from 16 to keep the run's time with the serving paths)
HYBRID_BITS = 5_482_579_968     # zamba2-7b 12 layers, block_topk:256,16
ENCDEC_BITS = 4_049_256_448     # whisper-medium, block_topk:256,16
VLM_BITS = 3_364_526_080        # qwen2-vl-2b 8 layers, block_topk:256,16
HYBRID_LAYERS, VLM_LAYERS = 12, 8
HYBRID_LEAVES, ENCDEC_LEAVES, VLM_LEAVES = 25, 27, 15
#: the inits' threefry draws: the embedding and the untied head, then
#: zamba2's 8 a mamba layer and 7 for the shared block (4 attention, 3
#: MLP weights); whisper's 11 a decoder layer (attention, cross-attention,
#: MLP) and 7 an encoder layer; qwen2-vl's 7 a layer
HYBRID_INIT_DRAWS = 2 + HYBRID_LAYERS * 8 + 7
ENCDEC_INIT_DRAWS = 2 + 24 * 11 + 24 * 7
VLM_INIT_DRAWS = 2 + VLM_LAYERS * 7

PATHS.update({
    # the driver has no depth flag: cut to 12 layers by ``cut_depth``, a
    # multiple of attn_every = 6, so the shared block runs twice
    "hybrid": {
        "argv": arch_argv("zamba2-7b")
        + ["--compressor", "block_topk:256,16"],
        "layers": HYBRID_LAYERS,
        "vocab": 32000,
        "bits": {r"(\d+) bits/round/worker": [HYBRID_BITS]},
        "finite": (r"\|g\|=(\S+)", r"h_res=(\S+)"),
        "launches": {"pack_update": HYBRID_LEAVES * WORKERS * STEPS,
                     "qsgd_pack_update": 0, "randk_update": 0,
                     "threefry_uniform": HYBRID_INIT_DRAWS},
        "profile": ("pack_update_rows",),
    },
    # whole, through the driver's CLI: each step's batch carries JAX's
    # frames (``train.family_batch_extras``)
    "encdec": {
        "argv": arch_argv("whisper-medium")
        + ["--compressor", "block_topk:256,16"],
        "vocab": 51865,
        "bits": {r"(\d+) bits/round/worker": [ENCDEC_BITS]},
        "finite": (r"\|g\|=(\S+)", r"h_res=(\S+)"),
        "launches": {"pack_update": ENCDEC_LEAVES * WORKERS * STEPS,
                     "qsgd_pack_update": 0, "randk_update": 0,
                     "threefry_uniform": ENCDEC_INIT_DRAWS},
        "profile": ("pack_update_rows",),
    },
    # 8 of 28 layers; each step's batch carries JAX's vision embeddings
    "vlm": {
        "argv": arch_argv("qwen2-vl-2b")
        + ["--compressor", "block_topk:256,16"],
        "layers": VLM_LAYERS,
        "vocab": 151936,
        "bits": {r"(\d+) bits/round/worker": [VLM_BITS]},
        "finite": (r"\|g\|=(\S+)", r"h_res=(\S+)"),
        "launches": {"pack_update": VLM_LEAVES * WORKERS * STEPS,
                     "qsgd_pack_update": 0, "randk_update": 0,
                     "threefry_uniform": VLM_INIT_DRAWS},
        "profile": ("pack_update_rows",),
    },
})
#: the main paths on two gloo ranks sharing cuda:0 (one worker each,
#: torchrun), each held bitwise against its one-process path ("same_as"):
#: losses and params checksums at every step, on every rank
#: the one-process references of the dist paths, at their depth: the
#: block-top-k and pipelined paths' flags, qwen2-0.5b cut to HALF_LAYERS
#: (whole before PR 31), their records (not profiled)
PATHS.update({
    "dist_block_topk_ref": {
        "argv": PATHS["block_topk"]["argv"], "layers": HALF_LAYERS,
        "bits": {r"(\d+) bits/round/worker": [HALF_BITS[0]]},
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0, "threefry_uniform": HALF_INIT_DRAWS},
        "profile": None,
    },
    "dist_pipelined_ref": {
        "argv": PATHS["pipelined"]["argv"], "layers": HALF_LAYERS,
        "bits": {r"(\d+) bits/round/worker": [HALF_BITS[0]],
                 r"downlink (\d+) bits/round broadcast": [HALF_BITS[1]],
                 r"total (\d+) bits/round up\+down":
                 [WORKERS * HALF_BITS[0] + HALF_BITS[1]],
                 r" (pipeline=depth:1) ": ["pipeline=depth:1"]},
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0,
                     "threefry_uniform": STEPS * FULL_LEAVES
                     + HALF_INIT_DRAWS},
        "profile": None,
    },
})
DIST_PATHS = {
    "dist_block_topk": {
        "argv": PATHS["block_topk"]["argv"] + ["--dist-backend", "gloo"],
        "same_as": "dist_block_topk_ref", "layers": HALF_LAYERS,
        "bits": {**PATHS["dist_block_topk_ref"]["bits"],
                 r" (ranks=2 backend=gloo) device=": ["ranks=2 backend=gloo"]},
        "launches": {"pack_update": RUNS // WORKERS, "qsgd_pack_update": 0,
                     "randk_update": 0, "threefry_uniform": HALF_INIT_DRAWS},
    },
    "dist_pipelined": {
        "argv": PATHS["pipelined"]["argv"] + ["--dist-backend", "gloo"],
        "same_as": "dist_pipelined_ref", "layers": HALF_LAYERS,
        "bits": {**PATHS["dist_pipelined_ref"]["bits"],
                 r" (ranks=2 backend=gloo) device=": ["ranks=2 backend=gloo"]},
        # each rank packs its worker; the broadcast runs on every rank
        "launches": {"pack_update": RUNS // WORKERS, "qsgd_pack_update": 0,
                     "randk_update": 0,
                     "threefry_uniform": STEPS * FULL_LEAVES
                     + HALF_INIT_DRAWS},
    },
}
DIST_PATHS["dist_fsdp"] = {
    "argv": PATHS["smoke_flags"]["argv"] + ["--trainer", "fsdp",
                                            "--dist-backend", "gloo"],
    "same_as": "smoke_flags",
    "layout": True,
    "layers": HALF_LAYERS,
    "bits": {**PATHS["smoke_flags"]["bits"],
             r" (ranks=2 backend=gloo) device=": ["ranks=2 backend=gloo"]},
    # each rank packs its worker; every rank draws the whole init and
    # encodes every leaf of the broadcast whole
    "launches": {"pack_update": RUNS // WORKERS, "qsgd_pack_update": 0,
                 "randk_update": 0,
                 "threefry_uniform": STEPS * FULL_LEAVES + HALF_INIT_DRAWS},
}
#: the master trees whose fsdp shards dist_fsdp holds against smoke_flags
LAYOUT_TREES = ("params", "w", "h_avg", "m", "v")
#: the master trees laid out as JAX's ``spec_for`` lays them out, each leaf
#: as the first leaf of its shape (``ModelShards.slot_of``)
SLOT_TREES = ("h_avg", "m", "v")
MASK64 = (1 << 64) - 1


def with_workers(argv, n):
    """``argv`` with ``--workers n``."""
    out = list(argv)
    out[out.index("--workers") + 1] = str(n)
    return out


def with_mesh(argv, mesh):
    """``argv`` on ``--mesh mesh`` (its worker count in place of
    ``--workers``) over gloo ranks."""
    out = list(argv)
    i = out.index("--workers")
    del out[i:i + 2]
    return out + ["--mesh", mesh, "--dist-backend", "gloo"]


def mesh_bits(up, down=None, total=None, mesh=None, ranks=None):
    """A mesh path's printed bits: the uplink per worker, the downlink
    broadcast and the round's total where there is a downlink, and the
    header's mesh and ranks."""
    out = {r"(\d+) bits/round/worker": [up]}
    if down is not None:
        out[r"downlink (\d+) bits/round broadcast"] = [down]
        out[r"total (\d+) bits/round up\+down"] = [total]
    out[rf" (mesh={mesh} ranks={ranks} backend=gloo) device="] = [
        f"mesh={mesh} ranks={ranks} backend=gloo"]
    return out


#: the mesh paths, each on gloo ranks sharing cuda:0 (``--dist-child
#: NAME``), against a one-process path of the same flags and depth
#: (``ref``, in PATHS): ``m`` ranks a worker, ``workers`` workers, the
#: arch (cut to ``layers``), the exact bits rank 0 prints, the launches on
#: every rank -- each rank packs every leaf of its worker once a step (in
#: place or after a gather), encodes every leaf of the broadcast, and
#: draws the whole init to keep its shards.
#:   mesh: the smoke_flags path's flags on a 2x2 mesh (2 workers x 2-way
#:     tensor parallelism), qwen2-0.5b cut to 4 of its 24 layers (cut
#:     from 24 to 8 to keep the run's time with the model-axis paths,
#:     to 4 with the tooling phases and remat), a checkpoint at the end;
#:   mesh_fsdp: the mesh path's flags under ``--trainer fsdp``: each rank
#:     holds its fsdp part (over the worker group) of its model shard of
#:     every master tree, and must match the mesh path bit for bit
#:     (``same_as``): losses, the master trees' layout sums at every step,
#:     each rank's h, the final checkpoint;
#:   mesh_heads: the same flags on 1x4, qwen2-0.5b at full width cut to
#:     4 of its 24 layers: 14 / 4 = 3.5 query heads
#:     and half a KV head a rank, so each layer's attention runs on
#:     weights gathered on use, its MLP Megatron-style;
#:   mesh_mamba2: the mamba2 path's flags (seq 512, no checkpoint: a
#:     rank's shards are not JAX's format) on 1x2, mamba2-130m at 12 of
#:     its 24 layers (whole before PR 31): the
#:     SSD leaves gathered on use, the embedding (vocab 50,280) and the
#:     tied head replicated; the same two ranks then run the
#:     ``mesh_families`` module check (``mesh_families_child``).
MESH_M = 2
MESH_LAYERS = 4
#: qwen2-0.5b at 4 layers, block_topk:256,16 up and qsgd:16 down
MESH_CUT_BITS = (783_140_864, 1_566_281_152, 3_132_562_880)
MESH_INIT_DRAWS = 1 + MESH_LAYERS * 7
MAMBA2_MESH_ARGV = arch_argv("mamba2-130m", seq=512) \
    + ["--compressor", "block_topk:256,16"]
MESH_CKPT = ROOT / "build" / "ckpt"
MESH_PATHS = {
    "mesh": {
        "argv": with_mesh(PATHS["smoke_flags"]["argv"],
                          f"{WORKERS}x{MESH_M}")
        + ["--ckpt-dir", str(MESH_CKPT / "mesh")],
        "m": MESH_M, "workers": WORKERS, "arch": "qwen2-0.5b",
        "layers": MESH_LAYERS, "ref": "mesh_ref", "layout": True,
        "checkpoint": MESH_CKPT / "mesh",
        "bits": mesh_bits(*MESH_CUT_BITS, mesh="2x2", ranks=4),
        "launches": {"pack_update": STEPS * FULL_LEAVES,
                     "threefry_uniform": STEPS * FULL_LEAVES
                     + MESH_INIT_DRAWS},
    },
    "mesh_fsdp": {
        "argv": with_mesh(PATHS["smoke_flags"]["argv"],
                          f"{WORKERS}x{MESH_M}")
        + ["--trainer", "fsdp", "--ckpt-dir", str(MESH_CKPT / "mesh_fsdp")],
        "m": MESH_M, "workers": WORKERS, "arch": "qwen2-0.5b",
        "layers": MESH_LAYERS, "ref": "mesh_ref", "layout": True,
        "checkpoint": MESH_CKPT / "mesh_fsdp", "same_as": "mesh",
        "bits": mesh_bits(*MESH_CUT_BITS, mesh="2x2", ranks=4),
        "launches": {"pack_update": STEPS * FULL_LEAVES,
                     "threefry_uniform": STEPS * FULL_LEAVES
                     + MESH_INIT_DRAWS},
    },
    "mesh_heads": {
        "argv": with_mesh(PATHS["smoke_flags"]["argv"], "1x4"),
        "m": 4, "workers": 1, "arch": "qwen2-0.5b", "ref": "mesh_heads_ref",
        "layers": HALF_LAYERS,
        "bits": mesh_bits(*HALF_BITS, sum(HALF_BITS), mesh="1x4", ranks=4),
        "launches": {"pack_update": STEPS * FULL_LEAVES,
                     "threefry_uniform": STEPS * FULL_LEAVES
                     + HALF_INIT_DRAWS},
    },
    "mesh_mamba2": {
        "argv": with_mesh(MAMBA2_MESH_ARGV, "1x2"),
        "m": 2, "workers": 1, "arch": "mamba2-130m",
        "ref": "mesh_mamba2_ref", "layers": MAMBA2_HALF_LAYERS,
        "bits": mesh_bits(MAMBA2_HALF_BITS, mesh="1x2", ranks=2),
        "launches": {"pack_update": MAMBA2_LEAVES * STEPS,
                     "threefry_uniform": MAMBA2_HALF_INIT_DRAWS},
    },
}
#: the torchrun launches that run the mesh paths, to pay each launch's
#: start (about 25 s: four processes importing torch, joining gloo and
#: drawing the init) once: four ranks run mesh, mesh_fsdp, mesh_heads,
#: then the committed specs and the two fsdp specs on 2x2
#: (``mesh_specs_child``); two run mesh_mamba2, then the
#: ``mesh_families`` check
MESH_LAUNCHES = {
    "mesh_four": {"ranks": 4, "paths": ("mesh", "mesh_fsdp", "mesh_heads"),
                  "specs": True},
    "mesh_two": {"ranks": 2, "paths": ("mesh_mamba2",), "families": True},
}
#: the mesh paths' one-process references (main paths of their own, run
#: with the others, their final params kept)
PATHS.update({
    "mesh_ref": {
        "argv": PATHS["smoke_flags"]["argv"], "layers": MESH_LAYERS,
        "bits": {k: v for k, v in mesh_bits(*MESH_CUT_BITS, mesh="2x2",
                                            ranks=4).items()
                 if "mesh=" not in k},
        "launches": {"pack_update": RUNS, "qsgd_pack_update": 0,
                     "randk_update": 0, "threefry_uniform":
                     STEPS * FULL_LEAVES + MESH_INIT_DRAWS},
        "profile": None, "keep_params": True,
    },
    "mesh_heads_ref": {
        "argv": with_workers(PATHS["smoke_flags"]["argv"], 1),
        "layers": HALF_LAYERS,
        "bits": {k: v for k, v in MESH_PATHS["mesh_heads"]["bits"].items()
                 if "mesh=" not in k},
        "launches": {"pack_update": STEPS * FULL_LEAVES,
                     "qsgd_pack_update": 0, "randk_update": 0,
                     "threefry_uniform": STEPS * FULL_LEAVES
                     + HALF_INIT_DRAWS},
        "profile": None, "keep_params": True,
    },
    "mesh_mamba2_ref": {
        "argv": with_workers(MAMBA2_MESH_ARGV, 1), "vocab": 50280,
        "layers": MAMBA2_HALF_LAYERS,
        "bits": {r"(\d+) bits/round/worker": [MAMBA2_HALF_BITS]},
        "finite": (r"\|g\|=(\S+)", r"h_res=(\S+)"),
        "launches": {"pack_update": MAMBA2_LEAVES * STEPS,
                     "qsgd_pack_update": 0, "randk_update": 0,
                     "threefry_uniform": MAMBA2_HALF_INIT_DRAWS},
        "profile": None, "keep_params": True,
    },
})
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
#: the committed fsdp specs, run at smoke size on four ranks through the
#: fine-tuning CLI (2 steps): their fingerprints and their up, down and
#: total bits (``BENCH_bits.json``'s ``zoo_scaling`` rows), and each
#: rank's launches: its worker packs every block-sparse leaf a step, and it
#: draws the smoke init and encodes every leaf of the broadcast whole
ZOO_STEPS_FSDP = 2
ZOO_SPECS = {
    "zoo_qwen2_fsdp": {
        "fingerprint": "e379cbd8a0e45487",
        "bits": [23_105_536, 11_553_216, 34_658_752],
        "launches": {"pack_update": 28, "threefry_uniform": 28 + 15}},
    "zoo_mamba2_fsdp": {
        "fingerprint": "6a9502177435874c",
        "bits": [5_484_544, 2_734_432, 8_218_976],
        "launches": {"pack_update": 30, "threefry_uniform": 30 + 17}},
    # 10 block-sparse leaves packed, the 3 expert leaves' plain top-k
    "finetune_moe": {
        "fingerprint": "f67bc877b3e73340",
        "bits": [21_024_768, 13_658_528, 34_683_296],
        "launches": {"pack_update": 20, "threefry_uniform": 26 + 18}},
}
#: the committed fsdp specs made 2x2 (``"mesh": "2x2", "n": 2``: two
#: workers of 2-way tensor parallelism), written to build/spec/ and run
#: through the fine-tuning CLI in the same launch (2 steps, ``--processes
#: 2``: a JAX process owning a row of the mesh is two ranks here): their
#: fingerprints (pinned against JAX's FinetuneLoop by
#: tests/test_torch_train.py's FSDP_SPECS_2X2), exact up, down and total
#: bits, and each rank's launches -- its worker packs every block-sparse
#: leaf once a step, in place or gathered, and it draws the smoke init and
#: encodes every leaf of the broadcast whole, as at 4x1
FSDP_SPECS_2X2 = {
    "zoo_qwen2_fsdp": {
        "fingerprint": "14ee601318e673be",
        "bits": [11_552_768, 11_553_216, 23_105_984],
        "launches": ZOO_SPECS["zoo_qwen2_fsdp"]["launches"]},
    "finetune_moe": {
        "fingerprint": "3bf8fba981e36383",
        "bits": [10_512_384, 13_658_528, 24_170_912],
        "launches": ZOO_SPECS["finetune_moe"]["launches"]},
}
FSDP_SPECS_2X2_DIR = ROOT / "build" / "spec"


def fsdp_spec_2x2_path(name):
    return FSDP_SPECS_2X2_DIR / f"{name}_2x2.json"


def write_fsdp_specs_2x2():
    """The committed fsdp specs on a 2x2 mesh of two workers, as JSON
    files under build/spec/."""
    from repro_torch.core import ExperimentSpec

    FSDP_SPECS_2X2_DIR.mkdir(parents=True, exist_ok=True)
    for name in FSDP_SPECS_2X2:
        spec = ExperimentSpec.from_json(
            (ROOT / "examples" / "specs" / f"{name}.json").read_text())
        fsdp_spec_2x2_path(name).write_text(dataclasses.replace(
            spec, mesh="2x2", n=2).to_json())


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
    pack_calls = collections.Counter()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), \
                recording(records, holder, layout=path.get("layout", False)), \
                recording_pack_shapes(pack_calls):
            reset_launches()
            drive(path, holder)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
    finally:
        print(out.getvalue().rstrip())
    if path.get("keep_params"):
        from repro_torch import tree as T
        MAIN_PARAMS[name] = T.tree_map(lambda a: a.cpu(),
                                       holder["state"].params)
    if path.get("checkpoint"):
        checkpoint_check(name, path, holder["state"].params)
    if path["profile"] is not None:
        # the run's final state, its step and its batches: the profile
        # phase goes on from them (an init of the same model again took
        # 1-6 s a path)
        step_fn, data = holder["run"]
        PROFILE_RUNS[name] = (holder["state"], step_fn.unrecorded, data)
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
    for pat in path.get("finite", ()):
        vals = [float(x) for x in re.findall(pat, text)]
        if len(vals) != STEPS or not all(map(math.isfinite, vals)):
            raise AssertionError(f"[main] {name}: printed {pat!r} {vals}, "
                                 f"want {STEPS} finite values")
    # the workers' raw gradients, before compression (a NaN row would
    # pack to (0.0, 0) and leave |g| and the losses finite)
    if not all(math.isfinite(r["grad_norm"]) for r in records):
        raise AssertionError(f"[main] {name}: workers' grad_norm "
                             f"{[r['grad_norm'] for r in records]}")
    # random init with small embeddings: the first loss is close to ln(V)
    if abs(losses[0] - math.log(path.get("vocab", 151936))) > 1.0:
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
    check_pack_shapes(name, pack_calls, launches["pack_update"])
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


#: each profiled main path's (final state, step function, batches), kept
#: by ``phase_main`` for ``phase_profile``
PROFILE_RUNS = {}
#: (numel, block, kb) of the pack kernel's calls on the main paths, each
#: held bitwise against its plain version once (``check_pack_shapes``)
PACK_CHECKED = set()


@contextlib.contextmanager
def recording_pack_shapes(calls):
    """While open, every call on the card of ``ops.efbv_pack_update`` (the
    wire's one way to the pack kernel) counts its leaf's (numel, block,
    kb) in ``calls``."""
    from repro_torch.kernels import ops

    fn = ops.efbv_pack_update

    def noted(g, h, lam, block=1024, kb=64):
        if g.is_cuda:
            calls[(g.numel(), block, kb)] += 1
        return fn(g, h, lam, block=block, kb=kb)

    ops.efbv_pack_update = noted
    try:
        yield
    finally:
        ops.efbv_pack_update = fn


def check_pack_shapes(name, calls, launches):
    """Every (numel, block, kb) that a main path gave the pack kernel and no
    earlier path did, held bitwise against its plain version on the card
    on fresh data of that size (after the launch counts are read).  The
    calls noted must be the kernel's launches."""
    if sum(calls.values()) != launches:
        raise AssertionError(f"[main] {name}: {sum(calls.values())} pack "
                             f"calls noted, {launches} launches")
    gen = torch.Generator(device="cuda").manual_seed(11)
    new = sorted(set(calls) - PACK_CHECKED)
    for numel, block, kb in new:
        g = torch.randn(numel, device="cuda", generator=gen)
        h = 0.5 * torch.randn(numel, device="cuda", generator=gen)
        pack_case(f"{name} leaf", g, h, block, kb, timing=False,
                  quiet=True)
        del g, h
        PACK_CHECKED.add((numel, block, kb))
    torch.cuda.empty_cache()
    print(f"[main] {name}: pack_update's calls by (numel, block, kb) "
          f"{dict(sorted(calls.items()))}; the {len(new)} shapes no earlier "
          "path gave it each bitwise == plain on the card")


class StepBatches:
    """A run's batches as the driver's loop makes them: ``data.batch(s)``
    with the family's extras (``train.step_batch``: the encdec's frames,
    the vlm's vision embeddings)."""

    def __init__(self, data, cfg, global_batch):
        self.data, self.cfg, self.global_batch = data, cfg, global_batch

    def batch(self, step):
        from repro_torch.launch import train

        return train.step_batch(self.data, self.cfg, self.global_batch,
                                step)


@contextlib.contextmanager
def cut_depth(layers):
    """While open, ``launch.train.run_config`` gives the spec's config cut
    to ``layers`` layers (None: as it is): the driver, which has no depth
    flag, then builds, shards, prints and trains the cut model under its
    own flags' spec, in one process or on a mesh rank."""
    from repro_torch.launch import train

    full = train.run_config
    if layers:
        train.run_config = lambda spec: dataclasses.replace(
            full(spec), n_layers=layers)
    try:
        yield
    finally:
        train.run_config = full


def drive(path, holder):
    """Run one main path through the driver's loop (``train.train_loop``)
    on ``train.setup`` of its flags, as ``train.main`` runs it in one
    process, under ``cut_depth`` for a path cut in depth (``layers``; the
    spec is the flags', which name the full-depth arch: the cut is this
    script's).  ``holder["run"]`` keeps the run's step function and its
    batches (``StepBatches``), not its state: only the loop holds
    that."""
    from repro_torch.launch import train

    args = train.parse_args(path["argv"])
    spec = train.experiment(args)

    def make():
        state, step_fn, data = train.setup(args, None, spec)
        holder["run"] = (step_fn, StepBatches(data, train.run_config(spec),
                                              args.global_batch))
        return state, step_fn, data

    with cut_depth(path.get("layers")):
        return train.train_loop(args, None, spec, make)


def checkpoint_check(name, path, params):
    """The path's last checkpoint (``--ckpt-dir``, JAX's npz format)
    restores into the model's template bitwise equal to the run's final
    params, its embedded spec equals the run's, and a restore under
    another spec is refused."""
    import dataclasses
    import shutil
    from repro_torch import tree as T
    from repro_torch.launch import train
    from repro_torch.models.model import build_model

    ckpt = str(path["checkpoint"])
    args = train.parse_args(path["argv"])
    spec = train.experiment(args)
    step = T.latest_step(ckpt)
    template = {"params": build_model(train.run_config(spec))
                .init_abstract()}
    t0 = time.perf_counter()
    back = T.restore_checkpoint(ckpt, step, template, spec=spec)["params"]
    secs = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(zip(T.leaves(back),
                                            T.leaves(params)))
           if not same_bits(a, b.cpu())]
    saved = T.saved_spec(ckpt, step)
    try:
        T.restore_checkpoint(ckpt, step, template,
                             spec=dataclasses.replace(spec, seed=1))
        refused = False
    except ValueError as e:
        refused = "refusing resume" in str(e)
    print(f"[main] {name}: checkpoint step {step} of {ckpt} restored in "
          f"{secs:.2f} s, {'bitwise equal to' if not bad else 'NOT equal to'}"
          f" the run's final params ({len(T.leaves(back))} leaves); saved "
          f"spec {'equal to' if saved == spec else 'NOT equal to'} the "
          f"run's ({spec.fingerprint()}); a restore under another spec "
          f"{'refused' if refused else 'NOT refused'}")
    shutil.rmtree(ckpt, ignore_errors=True)
    if bad or saved != spec or not refused or step != STEPS:
        raise AssertionError(f"[main] {name}: checkpoint round trip")


#: the fine-tuning path: ``finetune_moe.json`` made full width
#: (granite-moe-3b-a800m at MOE_LAYERS = 4 of 32 layers, d its tuning dim,
#: the expert leaves' rules ``expert_sparse_rules`` of the cut tree:
#: topk:1572864, 8
#: of 40 experts), the spec's 4 workers, global batch 8 of 128 tokens
FINETUNE_SPEC = ROOT / "examples" / "specs" / "finetune_moe.json"
FINETUNE_WORKERS = 4
FINETUNE_BITS = [4_030_832_640, 4_431_335_840, 8_462_168_480]
#: the expert leaves' payload bits, sparse and under the dense block-top-k
FINETUNE_EXPERT_BITS = [301_989_888, 1_509_949_440]
#: 10 block-sparse leaves packed a worker a step (the 3 expert leaves are
#: plain top-k); the init's draws and one uniform a leaf a step for the
#: broadcast
FINETUNE_LAUNCHES = {"pack_update": 10 * FINETUNE_WORKERS * STEPS,
                     "qsgd_pack_update": 0, "randk_update": 0,
                     "threefry_uniform": MOE_INIT_DRAWS + MOE_LEAVES * STEPS}
FINETUNE_CKPT = ROOT / "build" / "ckpt" / "finetune"
#: the kernels the finetune path's profile reports
FINETUNE_PROFILE = ("pack_update_rows", "threefry_fill_kernel")


def phase_finetune():
    """The staged fine-tuning harness (``launch.train.FinetuneLoop``) in
    one process on ``finetune_moe.json`` made full width, its config cut
    to ``MOE_LAYERS`` layers (the harness takes ``config=``; the spec names
    the whole arch): ``setup``, ``build_data``, ``train`` for STEPS steps
    (the spec's cosine over its own 8), ``evaluate`` on one held-out
    batch, and the final checkpoint, restored and compared bitwise.  Its
    printed fingerprint and exact bits, the expert leaves at exactly 1/5
    of their dense bits (8 of 40 experts routed), finite losses and eval
    loss, its launches (reset just before the harness and read after
    the evaluation), and the state's resident bytes beside the allocator's
    reading.  Keeps its run for ``phase_profile``.  Returns the
    launches."""
    import shutil
    from fractions import Fraction

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import ExperimentSpec, make_compressor
    from repro_torch.distributed import wire
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.models.layers import EXPERT_LEAVES
    from repro_torch.models.model import build_model

    committed = ExperimentSpec.from_json(FINETUNE_SPEC.read_text())
    full = get_config(committed.problem)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    tree = build_model(cfg).init_abstract()
    rules = train.expert_sparse_rules(
        tree, make_compressor(committed.compressor),
        n_experts=cfg.n_experts, experts_per_tok=cfg.experts_per_tok)
    spec = dataclasses.replace(committed, smoke=False,
                               d=train.tuning_dim(full), leaf_codecs=rules)
    print(f"[finetune] {FINETUNE_SPEC.name} at full width: leaf_codecs "
          f"{rules}, fingerprint {spec.fingerprint()} (committed "
          f"{committed.fingerprint()}); {cfg.name} at {cfg.n_layers} of "
          f"{full.n_layers} layers, {cfg.param_count():,} params")
    shutil.rmtree(FINETUNE_CKPT, ignore_errors=True)
    settings = train.FinetuneSettings(global_batch=8, seq_len=128,
                                      eval_batches=1, log_every=1,
                                      ckpt_dir=str(FINETUNE_CKPT))
    collect("[main] finetune")
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    records, holder = [], {}
    pack_calls = collections.Counter()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), recording(records, holder), \
                recording_pack_shapes(pack_calls):
            reset_launches()
            loop = train.FinetuneLoop(spec, settings, config=cfg)
            loop.setup()
            loop.build_data()
            loop.train(steps=STEPS)
            eval_loss = loop.evaluate()
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
    finally:
        print(out.getvalue().rstrip())
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    text = out.getvalue()
    st = loop.state
    resident = sum(x.numel() * x.element_size() for t in (
        st.params, st.w, st.h_avg, st.opt_state["m"], st.opt_state["v"],
        st.h) for x in T.leaves(t))
    losses = [float(x) for x in re.findall(r"step\s+\d+ loss=(\S+)", text)]
    fps = re.findall(r"spec fingerprint=([0-9a-f]{16})", text)
    bits = [int(x) for x in re.search(
        r"wire: up=(\d+) down=(\d+) total=(\d+) bits/round", text).groups()]
    run = loop.run_obj
    paths = wire.leaf_paths(tree)
    expert = [i for i, p in enumerate(paths)
              if p.split("/")[-1] in EXPERT_LEAVES and "moe" in p.split("/")]
    expert_bits = [sum(wire.tree_format_for(
        run.compressor, tree, wire_dtype=spec.wire_dtype,
        rules=r).bits_by_leaf()[i] for i in expert)
        for r in (run.leaf_rules, (("*", run.compressor),))]
    ratio = Fraction(*expert_bits)
    gc.collect()
    print(f"[main] finetune: seconds={secs:.2f} peak_mem_gib={peak:.2f} "
          f"resident state {resident / 2**30:.3f} GiB counted leaf by leaf "
          f"(params, w, h_avg, m, v and {FINETUNE_WORKERS} h), allocator "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; losses={losses} "
          f"eval_loss={eval_loss} bits up/down/total={bits} expert leaves "
          f"{expert_bits[0]} of dense {expert_bits[1]} bits = {ratio} "
          f"launches={launches} records={json.dumps(records)}")
    if fps != [spec.fingerprint()] or bits != FINETUNE_BITS or \
            expert_bits != FINETUNE_EXPERT_BITS or ratio != Fraction(1, 5):
        raise AssertionError(f"[main] finetune: fingerprint {fps}, bits "
                             f"{bits}, expert bits {expert_bits}")
    if len(losses) != STEPS or not all(map(math.isfinite,
                                           losses + [eval_loss])):
        raise AssertionError(f"[main] finetune: losses {losses}, eval "
                             f"{eval_loss}")
    if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        raise AssertionError(f"[main] finetune: first loss {losses[0]}")
    want = {**dict.fromkeys(launches, 0), **FINETUNE_LAUNCHES}
    if launches != want:
        raise AssertionError(f"[main] finetune: launches {launches}, want "
                             f"{want}")
    check_pack_shapes("finetune", pack_calls, launches["pack_update"])
    t1 = time.perf_counter()
    restored = T.restore_checkpoint(str(FINETUNE_CKPT), STEPS,
                                    {"params": tree}, spec=spec)["params"]
    same = all(same_bits(a, b.cpu()) for a, b in
               zip(T.leaves(restored), T.leaves(st.params)))
    print(f"[main] finetune: checkpoint step {STEPS} restored in "
          f"{time.perf_counter() - t1:.1f} s, "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} the params")
    if not same:
        raise AssertionError("[main] finetune: restored params differ")
    del restored
    # the run's final state, its step and its batches, for phase_profile
    PROFILE_RUNS["finetune"] = (loop.state, loop.step_fn.unrecorded,
                                StepBatches(loop.data, cfg, 8))
    del loop, st
    holder.clear()
    return launches


def phase_cli_smoke():
    """The driver's CLI on the card at ``--smoke`` for the other new archs:
    granite-moe and dbrx (each step line with its aux_loss) and minicpm
    (``--schedule auto`` picks WSD, and the header says so): finite
    losses, the exact bits, and every leaf packed by the kernel on each
    worker at each step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compressors import make_compressor
    from repro_torch.distributed import wire
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch import tree as T
    from repro_torch.models.model import build_model

    total = {}
    for arch in ("granite-moe-3b-a800m", "dbrx-132b", "minicpm-2b"):
        cfg = get_smoke_config(arch)
        abstract = build_model(cfg).init_abstract()
        bits = wire.tree_format_for(make_compressor("block_topk:256,16"),
                                    abstract).bits_per_round()
        argv = ["--arch", arch, "--smoke", "--workers", str(WORKERS),
                "--steps", "2", "--global-batch", "8", "--seq", "32",
                "--compressor", "block_topk:256,16", "--agg",
                "sparse_allgather", "--log-every", "1"]
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                reset_launches()
                train.main(argv)
                torch.cuda.synchronize()
                launches = dict(LAUNCHES)
        finally:
            print(out.getvalue().rstrip())
        text = out.getvalue()
        losses = [float(x) for x in re.findall(r"step\s+\d+ loss=(\S+)",
                                               text)]
        aux = [float(x) for x in re.findall(r"aux_loss=(\S+) ", text)]
        packs = len(T.leaves(abstract)) * WORKERS * 2
        ok = (len(losses) == 2 and all(map(math.isfinite, losses))
              and f" {bits} bits/round/worker" in text
              and launches.get("pack_update") == packs)
        if cfg.family == "moe":
            ok = ok and len(aux) == 2 and all(map(math.isfinite, aux))
        if arch == "minicpm-2b":
            ok = ok and " schedule=wsd " in text
        print(f"[cli_smoke] {cfg.name}: losses={losses} aux_loss={aux} "
              f"bits={bits} launches={launches} (pack_update want {packs})")
        if not ok:
            raise AssertionError(f"[cli_smoke] {cfg.name} failed")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def op_share(name, path, state, step_fn, data, busy):
    """The share of the step's device time that the path's family op takes
    (``op``: the SSD scan or the MoE dispatch, forward and backward): its
    inputs are captured from one call in a step, then the op alone runs
    forward and backward on them under torch.profiler, and its device
    kernel time, times its calls a step, is held against the traced
    step's device kernel time ``busy``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random
    from repro_torch.models import layers as L

    op = getattr(L, path["op"])
    seen = []

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return op(*args, **kwargs)

    setattr(L, path["op"], spy)
    try:
        state, _ = step_fn(state, data.batch(5),
                           random.fold_in(random.key(0), 5))
    finally:
        setattr(L, path["op"], op)
    calls = len(seen)
    args, kwargs = seen[0]
    seen.clear()
    args = [a.detach().clone().requires_grad_(a.is_floating_point())
            if isinstance(a, torch.Tensor) else a for a in args]
    if isinstance(args[0], dict):      # dispatch_groups(p, xg): the weights
        args[0] = {k: v.detach().clone().requires_grad_(True)
                   for k, v in args[0].items()}

    def fwd_bwd():
        with torch.enable_grad():
            out = op(*args, **kwargs)
            out = out[0] if isinstance(out, tuple) else out
            out.float().sum().backward()

    fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    try:
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    except Exception as e:  # reading the trace, not the port: report it
        print(f"[profile] {name}: {path['op']} not measured: {e!r}")
        return state
    share = f"{ms * calls / busy:.3f}" if busy else "not measured"
    print(f"[profile] {name}: {path['op']} forward+backward alone at the "
          f"step's shapes: {ms:.3f} ms of device kernels x {calls} calls a "
          f"step = {ms * calls:.2f} ms, {share} of the traced step's "
          "device kernel time")
    return state


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
    if "--pipeline" in path["argv"]:
        g0 = re.findall(r"step\s+0 loss=\S+ \|g\|=(\S+)", text)
        if g0 != ["0.000"]:
            raise AssertionError(f"[main] {name}: step 0 |g| {g0}, want "
                                 "0.000 (the zero priming payload)")
    total, ranks = {}, []
    # an fsdp rank holds shards: its losses must be the one-process path's
    # and its shards are checked together below (``fsdp_check``)
    key = "loss" if path.get("layout") else "checksum"
    for r, log in enumerate(logs):
        records = json.loads(re.search(r"\[dist\] records (.*)", log)[1])
        launches = json.loads(re.search(r"\[dist\] launches (.*)", log)[1])
        peak = float(re.search(r"\[dist\] peak_gib (\S+)", log)[1])
        ranks.append(records)
        same = [(a["loss"], a[key]) for a in records] == \
            [(b["loss"], b[key]) for b in want]
        what = "losses" if path.get("layout") else \
            "losses and params checksums"
        print(f"[main] {name} rank {r}: {what} at every step "
              f"{'equal' if same else 'NOT equal'} to the one-process "
              f"{path['same_as']} path's; launches={launches}")
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
        if path.get("layout"):
            print(f"[profile] {name} rank {r}: fsdp_gather_host_ms="
                  f"{[a['model_ms'] for a in records]} fsdp_collectives="
                  f"{[a['model_calls'] for a in records]} fsdp_bytes_sent="
                  f"{[a['model_bytes'] for a in records]}")
    if path.get("layout"):
        fsdp_check(name, logs, ranks, want)
    return total


def fsdp_check(name, logs, ranks, want):
    """dist_fsdp's ranks against the one-process path: their fsdp dims are
    ``fsdp_specs``'s for full-width qwen2-0.5b (at the path's depth) on a
    2x1 mesh (every leaf
    halves; the embedding by its columns); at every step the sum over the
    ranks of each master tree's ``layout_sum`` (params, w, h_avg, m, v:
    their shards reassembled) equals the one-process tree's; each rank's
    resident state, counted leaf by leaf, is within 1% of (5/2 + 1) x the
    params' f32 bytes (h whole: one worker a rank), the allocator's
    reading printed beside it."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.aggregate import fsdp_dims, make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import fsdp_specs

    from repro_torch import tree as T

    model = build_model(dataclasses.replace(
        get_config("qwen2-0.5b"), n_layers=DIST_PATHS[name]["layers"]))
    mesh = make_mesh((WORKERS, 1))
    logical = model.init_abstract()
    dims = list(fsdp_dims(fsdp_specs(mesh, model.param_specs(), logical),
                          mesh))
    params = sum(x.numel() for x in T.leaves(logical))
    predicted = (5 / WORKERS + 1) * 4 * params
    for r, log in enumerate(logs):
        got = json.loads(re.search(r"\[dist\] fsdp_dims (.*)", log)[1])
        m = re.search(r"\[dist\] resident_bytes (\d+) allocated (\d+)", log)
        resident, allocated = int(m[1]), int(m[2])
        print(f"[main] {name} rank {r}: fsdp dims {got} (fsdp_specs: "
              f"{dims}); resident state {resident} B = "
              f"{resident / 2**30:.3f} GiB counted leaf by leaf, predicted "
              f"{predicted / 2**30:.3f} GiB, allocator "
              f"{allocated / 2**30:.3f} GiB")
        if got != dims or None in got:
            raise AssertionError(f"[main] {name} rank {r}: dims {got}")
        if abs(resident - predicted) > 0.01 * predicted:
            raise AssertionError(f"[main] {name} rank {r}: resident "
                                 f"{resident} B, predicted {predicted}")
    for s, one in enumerate(want):
        for k in LAYOUT_TREES:
            summed = sum(recs[s]["layout"][k] for recs in ranks) & MASK64
            if summed != one["layout"][k]:
                raise AssertionError(f"[main] {name}: step {s} {k}: the "
                                     f"ranks' shards sum {summed:x}, one "
                                     f"process {one['layout'][k]:x}")
    print(f"[main] {name}: at each of {len(want)} steps the {len(ranks)} "
          f"ranks' shards of {', '.join(LAYOUT_TREES)}, reassembled by "
          "fsdp_specs (layout sums over the ranks), bitwise the one-process "
          "smoke_flags path's")


def mesh_specs_child(outdir):
    """One rank of the mesh specs phase: probes whether gloo's all-reduce
    takes a bf16 CUDA tensor (the model axis reduces in f32 either way),
    then each committed 2x2 spec through ``launch.train.main`` with
    ``--spec`` (smoke size), its own file store, between marker lines, with
    launch counts reset just before it and read just after; then the
    committed fsdp specs through the fine-tuning CLI, at 4x1 and made 2x2
    (``FSDP_SPECS_2X2``: two processes of two ranks, a moe worker's h
    against the experts its gradients touched)."""
    import os

    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.models import layers as L

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
    # the committed fsdp specs through the fine-tuning CLI, truncated to
    # ZOO_STEPS_FSDP steps (the spec's identity kept)
    for i, name in enumerate(ZOO_SPECS):
        print(f"[mesh-specs] begin {name}", flush=True)
        t0 = time.perf_counter()
        reset_launches()
        train.main(["finetune", "--spec", str(ROOT / "examples" / "specs" /
                                              f"{name}.json"),
                    "--steps", str(ZOO_STEPS_FSDP), "--processes",
                    str(world), "--global-batch", "8", "--seq", "32",
                    "--log-every", "1", "--eval-batches", "1",
                    "--dist-backend", "gloo", "--dist-init",
                    f"file://{outdir}/zoo{i}"])
        torch.cuda.synchronize()
        print(f"[mesh-specs] launches {name} {json.dumps(dict(LAUNCHES))}")
        print(f"[mesh-specs] seconds {name} {time.perf_counter() - t0:.1f}")
        print(f"[mesh-specs] end {name}", flush=True)
    # the committed fsdp specs on 2x2 (fsdp on a model axis), two
    # processes of two ranks; a moe worker's h is checked against the
    # experts its gradients touched
    for i, name in enumerate(FSDP_SPECS_2X2):
        label = f"{name}_2x2"
        print(f"[mesh-specs] begin {label}", flush=True)
        t0 = time.perf_counter()
        active, records, holder = {}, [], {}
        activity = L.expert_activity_mask

        def watch(moe_grads):
            # the experts this worker's gradients touched in any step so
            # far, as ``zero_inactive_expert_grads`` reads them
            m = activity(moe_grads)
            active["mask"] = m | active.get("mask", torch.zeros_like(m))
            return m

        L.expert_activity_mask = watch
        reset_launches()
        try:
            with recording(records, holder):
                train.main(["finetune", "--spec",
                            str(fsdp_spec_2x2_path(name)), "--steps",
                            str(ZOO_STEPS_FSDP), "--processes", "2",
                            "--global-batch", "8", "--seq", "32",
                            "--log-every", "1", "--eval-batches", "1",
                            "--dist-backend", "gloo", "--dist-init",
                            f"file://{outdir}/fsdp22_{i}"])
            torch.cuda.synchronize()
        finally:
            L.expert_activity_mask = activity
        print(f"[mesh-specs] launches {label} {json.dumps(dict(LAUNCHES))}")
        if active:
            # an expert no step of this worker routed a token to: its
            # slabs of h stay exactly zero
            h = holder["state"].h["layers"]["moe"]
            idle = ~active["mask"]
            print(f"[mesh-specs] experts {label} " + json.dumps({
                "idle_slabs": int(idle.sum()),
                "slabs": idle.numel(),
                "nonzero_idle": {k: int(h[k][0][idle].count_nonzero())
                                 for k in L.EXPERT_LEAVES},
                "nonzero_active": {k: int(h[k][0][~idle].count_nonzero())
                                   for k in L.EXPERT_LEAVES}}))
        del holder
        print(f"[mesh-specs] seconds {label} {time.perf_counter() - t0:.1f}")
        print(f"[mesh-specs] end {label}", flush=True)


def phase_mesh(name):
    """A mesh path (``MESH_PATHS[name]``): its ranks on cuda:0 from JAX's
    weights.  Rank 0's exact bits; a finite loss and a finite raw gradient
    norm (``grad_norm``, before compression: fault w on mamba2) at every
    step on every rank, within 1e-3 relative of the one-process ``ref``
    path's losses; each kernel's launches per rank; every master tree
    (params, w, h_avg, m, v) resident on every rank in exactly its shards'
    bytes, below the logical tree's; with two workers, the two ranks of
    each model index hold bitwise the same shards of params, w, h_avg, m
    and v at every step; the first worker group's params shards,
    reassembled, against the ``ref`` path's final params
    (``mesh_params_check``).  Then the per-rank numbers.  Returns the
    launches summed over the ranks."""
    path = MESH_PATHS[name]
    m, workers = path["m"], path["workers"]
    logs = mesh_segments(name)
    text = logs[0]
    for pat, expect in path["bits"].items():
        got = [int(x) if x.isdigit() else x for x in re.findall(pat, text)]
        if got != expect:
            raise AssertionError(f"[main] {name}: printed {pat!r} {got} != "
                                 f"{expect}")
    want = MAIN_RECORDS[path["ref"]]
    one = [float.fromhex(b["loss"]) for b in want]
    records, total = [], {}
    for r, log in enumerate(logs):
        recs = json.loads(re.search(r"\[dist\] records (.*)", log)[1])
        launches = json.loads(re.search(r"\[dist\] launches (.*)", log)[1])
        peak = float(re.search(r"\[dist\] peak_gib (\S+)", log)[1])
        res = re.search(r"\[dist\] resident (\{.*\}) shards (\d+) slots "
                        r"(\d+) logical (\d+) sharded_leaves (\d+) of "
                        r"(\d+)", log)
        resident = json.loads(res[1])
        shard_bytes, slot_bytes, logical = (int(res[2]), int(res[3]),
                                            int(res[4]))
        moved = json.loads(re.search(r"\[dist\] slots moved (.*)", log)[1])
        losses = [float.fromhex(a["loss"]) for a in recs]
        norms = [a["grad_norm"] for a in recs]
        if len(losses) != STEPS or not all(map(math.isfinite,
                                               losses + norms)):
            raise AssertionError(f"[main] {name} rank {r}: losses {losses} "
                                 f"grad_norm {norms}")
        # bf16 activations summed in another order by the model axis's
        # collectives: the losses within 1e-3 relative of one process
        if any(abs(a - b) > 1e-3 * abs(b) for a, b in zip(losses, one)):
            raise AssertionError(f"[main] {name} rank {r}: losses {losses} "
                                 f"vs one process {one}")
        expect = {**dict.fromkeys(launches, 0), **path["launches"]}
        if launches != expect:
            raise AssertionError(f"[main] {name} rank {r}: launches "
                                 f"{launches}, want {expect}")
        # params and w in their shards, m, v and h_avg in JAX's layout
        if any(v != (slot_bytes if k in SLOT_TREES else shard_bytes)
               for k, v in resident.items()) or \
                not max(shard_bytes, slot_bytes) < logical:
            raise AssertionError(f"[main] {name} rank {r}: resident "
                                 f"{resident}, shards {shard_bytes}, slots "
                                 f"{slot_bytes}, logical {logical}")
        h = re.search(r"\[dist\] h (\S+) model_shards (\S+)", log)
        if h[2] != "True":
            raise AssertionError(f"[main] {name} rank {r}: h does not hold "
                                 "the worker's model shards")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        records.append(recs)
        print(f"[main] {name} rank {r} (worker {r // m}, model {r % m}): "
              f"losses={losses} (one process {one}) grad_norm={norms} "
              f"launches={launches}; resident bytes by tree {resident} = "
              f"its shards' {shard_bytes} (params, w) and JAX's spec_for "
              f"layout's {slot_bytes} (m, v, h_avg; moved {moved}) of the "
              f"logical {logical} ({res[5]} of {res[6]} leaves sharded) "
              f"[{SMI}]")
        print(f"[profile] {name} rank {r}: step_ms="
              f"{[a['step_ms'] for a in recs]} model_axis_host_ms="
              f"{[a['model_ms'] for a in recs]} model_axis_calls="
              f"{[a['model_calls'] for a in recs]} model_axis_bytes_sent="
              f"{[a['model_bytes'] for a in recs]} exchange_host_ms="
              f"{[a['exchange_ms'] for a in recs]} exchange_bytes_sent="
              f"{[a['bytes'] // workers for a in recs]} peak_gib={peak:.2f} "
              + "".join(
                  f"{stage}_gathers_host_ms={[a[k + '_ms'] for a in recs]} "
                  f"{stage}_gathers_calls={[a[k + '_calls'] for a in recs]} "
                  f"{stage}_gathers_bytes_sent="
                  f"{[a[k + '_bytes'] for a in recs]} "
                  for k, stage in (("fsdp", "worker_group"),
                                   ("fsdp_model", "model_axis"))
                  if k + "_ms" in recs[0])
              + f"on {SMI} ({workers * m} processes time-slice one card; "
              "gloo moves every collective through host memory: not NCCL, "
              "not a tensor-parallel time)")
    if path.get("same_as"):
        fsdp_mesh_check(name, logs, records)
        secs = re.search(r"\[dist\] seconds (\S+)", logs[0])[1]
        print(f"[main] {name}: {secs} s on rank 0 from its driver's start "
              "to its last check")
        return total
    for i in range(m if workers > 1 else 0):
        a, b = records[i], records[m + i]
        same = [x["master"] for x in a] == [y["master"] for y in b]
        print(f"[main] {name}: model index {i}: ranks {i} and {m + i} "
              f"hold {'bitwise the same' if same else 'DIFFERENT'} shards "
              "of params, w, h_avg, m, v at every step")
        if not same:
            raise AssertionError(f"[main] {name}: model index {i} ranks "
                                 "differ")
    secs = re.search(r"\[dist\] seconds (\S+)", logs[0])[1]
    print(f"[main] {name}: {secs} s on rank 0 from its driver's start to "
          "its last check")
    mesh_params_check(name)
    return total


def mesh_segments(name):
    """Each rank's log of the mesh path ``name`` (between its markers)."""
    return [log.split(f"[dist] begin {name}\n")[1].split(
        f"[dist] end {name}\n")[0] for log in mesh_launch_logs(name)]


def npz_params(ckpt):
    """The ``params|...`` entries of a path's last checkpoint (JAX's npz
    format, step STEPS), as numpy arrays by key."""
    import numpy as np

    with np.load(Path(ckpt) / f"step_{STEPS:08d}.npz") as f:
        return {k: f[k] for k in f.files if k.startswith("params|")}


def fsdp_part_bytes(arch, layers, shape, slots=False):
    """Each rank's bytes of one f32 master tree under fsdp on a mesh of
    ``shape``, from the specs alone: every leaf's dims divided by the
    axes that its fsdp spec (``fsdp_specs`` over the model's
    ``param_specs``) names, the worker axes by the worker count and
    ``model`` by the model axis; with ``slots`` (m, v, h_avg) each leaf
    by the fsdp spec of the first leaf of its shape (JAX's ``spec_for``
    in ``fsdp_state_shardings``)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed.aggregate import make_mesh
    from repro_torch.models.layers import is_spec
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import fsdp_specs

    model = build_model(dataclasses.replace(get_config(arch),
                                            n_layers=layers))
    mesh = make_mesh(shape)
    logical = model.init_abstract()
    parts = []
    for leaf, spec in zip(T.leaves(logical), T.leaves(fsdp_specs(
            mesh, model.param_specs(), logical), is_leaf=is_spec)):
        part = list(leaf.shape)
        for i, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    part[i] //= mesh.shape[a]
        parts.append(4 * math.prod(part))
    if slots:
        shapes = [tuple(x.shape) for x in T.leaves(logical)]
        parts = [parts[shapes.index(s)] for s in shapes]
    return sum(parts)


def fsdp_mesh_check(name, logs, records):
    """A mesh path under fsdp (``same_as``) against its mesh path, bit for
    bit: every rank's losses; at every step the master trees' layout sums
    over the four ranks (params, w, h_avg, m, v: the fsdp parts of the
    model shards, placed in the logical leaves) against the mesh path's
    (its first worker group's shards); every rank's h checksum against the
    same rank's; the final checkpoints' params; and each rank's resident
    bytes of every master tree, exactly the fsdp-on-model specs' part
    (``fsdp_part_bytes``), beside the mesh path's."""
    import shutil

    path = MESH_PATHS[name]
    base = path["same_as"]
    blogs = mesh_segments(base)
    brecs = [json.loads(re.search(r"\[dist\] records (.*)", log)[1])
             for log in blogs]
    for r, (recs, want) in enumerate(zip(records, brecs)):
        if [a["loss"] for a in recs] != [b["loss"] for b in want]:
            raise AssertionError(f"[main] {name} rank {r}: losses differ "
                                 f"from {base}'s")
        h = re.search(r"\[dist\] h (\S+)", logs[r])[1]
        bh = re.search(r"\[dist\] h (\S+)", blogs[r])[1]
        if h != bh:
            raise AssertionError(f"[main] {name} rank {r}: h {h} != "
                                 f"{base}'s {bh}")
    for s in range(STEPS):
        for k in LAYOUT_TREES:
            got = sum(recs[s]["layout"][k] for recs in records) & MASK64
            want = sum(recs[s]["layout"][k] for recs in brecs) & MASK64
            if got != want:
                raise AssertionError(f"[main] {name}: step {s} {k}: the "
                                     f"parts sum {got:x}, {base} {want:x}")
    mine, theirs = (npz_params(path["checkpoint"]),
                    npz_params(MESH_PATHS[base]["checkpoint"]))
    bad = sorted(k for k in theirs if k not in mine
                 or mine[k].tobytes() != theirs[k].tobytes())
    if bad or mine.keys() != theirs.keys():
        raise AssertionError(f"[main] {name}: checkpoint differs from "
                             f"{base}'s at {bad[:4]}")
    mesh_dims = (path["workers"], path["m"])
    part = fsdp_part_bytes(path["arch"], path["layers"], mesh_dims)
    slot = fsdp_part_bytes(path["arch"], path["layers"], mesh_dims,
                           slots=True)
    for r, log in enumerate(logs):
        resident = json.loads(re.search(r"\[dist\] resident (\{.*\}) ",
                                        log)[1])
        bres = json.loads(re.search(r"\[dist\] resident (\{.*\}) ",
                                    blogs[r])[1])
        moved = re.search(r"\[dist\] slots moved (.*)", log)[1]
        print(f"[main] {name} rank {r}: resident bytes by tree {resident} "
              f"(the fsdp-on-model specs' part: {part} for params and w, "
              f"{slot} for m, v and h_avg by JAX's spec_for, moved "
              f"{moved}; {base}: {bres}) [{SMI}]")
        if any(v != (slot if k in SLOT_TREES else part)
               for k, v in resident.items()):
            raise AssertionError(f"[main] {name} rank {r}: resident "
                                 f"{resident}, want {part} a tree, {slot} "
                                 f"for {SLOT_TREES}")
    dims = re.search(r"\[dist\] fsdp_dims (.*)", logs[0])[1]
    print(f"[main] {name}: fsdp dims {dims}; at each of {STEPS} steps the "
          f"{len(logs)} ranks' parts of {', '.join(LAYOUT_TREES)} "
          f"(layout sums) bitwise {base}'s, every rank's losses and h "
          f"bitwise, the final checkpoint's {len(mine)} params bitwise "
          f"{base}'s")
    for p in (path["checkpoint"], MESH_PATHS[base]["checkpoint"]):
        shutil.rmtree(p, ignore_errors=True)


def mesh_launch_logs(name):
    """The rank logs of the MESH_LAUNCHES launch that runs the mesh path
    ``name``, launching it the first time one of its paths asks."""
    import shutil

    launch = next(k for k, v in MESH_LAUNCHES.items() if name in v["paths"])
    if launch not in MESH_LOGS:
        collect(f"[main] {launch}")
        torch.cuda.empty_cache()
        for sub in MESH_LAUNCHES[launch]["paths"]:
            if MESH_PATHS[sub].get("checkpoint"):
                shutil.rmtree(MESH_PATHS[sub]["checkpoint"],
                              ignore_errors=True)
        if MESH_LAUNCHES[launch].get("specs"):
            write_fsdp_specs_2x2()
        MESH_LOGS[launch] = run_ranks(launch,
                                      ranks=MESH_LAUNCHES[launch]["ranks"],
                                      timeout=MESH_TIMEOUT_S)
    return MESH_LOGS[launch]


def mesh_params_check(name):
    """A mesh path's final params (the first worker group's shards,
    reassembled by ``param_specs``) against its one-process ``ref``
    path's, both from ``init(random.key(0))`` at the same depth.  Their
    bf16 activations are summed in another order, so a block-top-k
    near-tie can select other values, and AdamW then moves an element by
    up to lr_t * 1.001 a step (its m / sqrt(v) bound at b1 0.9, b2 0.95
    over 3 steps) either way: max |diff| <= 2.02 * sum_t lr_t.  Beyond
    that bound, the share of elements that differ by more than 1e-6 must
    stay below 0.25 and the norm of the difference below half the norm of
    the update, which a wrong gradient or shard would break (at smoke size
    on the CPU: 2-8% and 0.19).  A path with a ``checkpoint`` also holds
    its final npz (rank 0's, of the params gathered over the model axis)
    bitwise against the reassembled shards."""
    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.layers import is_spec, spec_dim
    from repro_torch.models.model import build_model
    from repro_torch.optim.schedules import cosine

    path = MESH_PATHS[name]
    cfg = get_config(path["arch"])
    if path.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=path["layers"])
    model = build_model(cfg)
    dims = [spec_dim(x) for x in T.leaves(model.param_specs(),
                                          is_leaf=is_spec)]
    launch = next(k for k, v in MESH_LAUNCHES.items() if name in v["paths"])
    outdir = ROOT / "build" / "dist" / launch
    parts = [T.leaves(torch.load(outdir / f"params_{name}_rank{r}.pt"))
             for r in range(path["m"])]
    one = T.leaves(MAIN_PARAMS[path["ref"]])
    init = T.leaves(model.init(random.key(0), device="cuda"))
    sched = cosine(3e-4, total_steps=STEPS,
                   warmup_steps=max(STEPS // 20, 1))
    bound = 2.02 * sum(sched(t) for t in range(STEPS))
    # the path's final checkpoint, written by rank 0 from the gathered
    # params: bitwise the shards reassembled here
    ckpt = npz_params(path["checkpoint"]) if path.get("checkpoint") else {}
    keys = ["params|" + "|".join(k) for k, _ in
            T.flatten_with_path(model.init_abstract())]
    worst, over, count, num, den = 0.0, 0, 0, 0.0, 0.0
    for key, dim, ps, o, i in zip(keys, dims, zip(*parts), one, init):
        whole = ps[0] if dim is None else torch.cat(ps, dim=dim)
        if ckpt and ckpt[key].tobytes() != whole.numpy().tobytes():
            raise AssertionError(f"[main] {name}: checkpoint {key} is not "
                                 "the reassembled shards")
        whole = whole.cuda()
        o = o.cuda()
        d = (whole.double() - o.double()).abs()
        worst = max(worst, float(d.max()))
        over += int((d > 1e-6).sum())
        count += d.numel()
        num += float((d * d).sum())
        den += float(((o.double() - i.double()) ** 2).sum())
    share, rel = over / count, math.sqrt(num / den)
    print(f"[main] {name}: reassembled params after {STEPS} steps vs one "
          f"process ({path['ref']}): max |diff| {worst:.3e} (bound "
          f"{bound:.3e}), share differing > 1e-6 {share:.4f} (limit 0.25), "
          f"|diff| / |update| {rel:.4f} (limit 0.5)"
          + (f"; the final checkpoint's {len(ckpt)} params bitwise the "
             "reassembled shards" if ckpt else ""))
    if ckpt and len(ckpt) != len(keys):
        raise AssertionError(f"[main] {name}: checkpoint holds {len(ckpt)} "
                             f"params, the model {len(keys)}")
    if not (worst <= bound and share < 0.25 and rel < 0.5):
        raise AssertionError(f"[main] {name}: params outside the tolerance "
                             "of the one-process run")


#: each mesh path's rank logs, for the phases that read them again
MESH_LOGS = {}
#: the module check of the model axis: each arch's smoke config in f32 on
#: a 1x2 mesh against the same arch's one-rank run on the card, and
#: granite-moe at full width cut to 2 layers, whose specs shard no leaf
#: (its 'replicate' attention, 40 experts, vocab 49,155): the compute is
#: replicated and nothing is reduced, so it must be bitwise
FAMILY_TP_ARCHS = ("minitron-8b", "granite-moe-3b-a800m", "mamba2-130m",
                   "phi3-medium-14b", "qwen2-vl-2b", "dbrx-132b",
                   "whisper-medium", "minicpm-2b", "qwen2-0.5b", "zamba2-7b",
                   "granite-moe-3b-a800m@full2")
#: the loss's relative and each gradient leaf's tolerance (of its largest
#: entry) against one rank, f32 activations: JAX's one-device tolerance in
#: tests/test_torch_imports.py (the CPU run is within 3e-6)
FAMILY_TP_RTOL, FAMILY_TP_LEAF = 1e-5, 1e-4


def family_tp_config(arch):
    from repro_torch.configs import get_config, get_smoke_config

    name, _, cut = arch.partition("@full")
    cfg = dataclasses.replace(get_config(name), n_layers=int(cut)) if cut \
        else get_smoke_config(name)
    return dataclasses.replace(cfg, activation_dtype="float32")


def mesh_families_child(outdir):
    """The ``mesh_families`` check on this rank of the mesh_mamba2 launch
    (a new group of both ranks, one worker of two model ranks): for each
    FAMILY_TP_ARCHS config, JAX's weights (``init(random.key(0))``) and
    one batch of 2 x 64 tokens with the family's extras, the loss and the
    logical gradients gathered from this rank's shards; rank 0 also runs
    the one-rank loss and gradients on the same card and prints how far
    apart they are; every rank prints a checksum of its replicated
    leaves' gradients.  Launch counts are reset just before and read just
    after."""
    import os

    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.distributed.aggregate import ModelShards, WorkerGroup
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import family_batch_extras
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import value_and_grad

    t0 = time.perf_counter()
    world = int(os.environ["WORLD_SIZE"])
    reset_launches()
    group = WorkerGroup.join(1, backend="gloo", device="cuda:0",
                             init_method=f"file://{outdir}/families",
                             model_size=world)
    tp = group.model
    try:
        for arch in FAMILY_TP_ARCHS:
            cfg = family_tp_config(arch)
            model = build_model(cfg)
            params = model.init(random.key(0), device="cuda")
            raw = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                              n_workers=1, seed=3).batch(0)
            raw.update(family_batch_extras(cfg, 2, 0))
            batch = {k: torch.as_tensor(v).cuda() for k, v in raw.items()}
            shards = ModelShards.of(tp, model.param_specs(),
                                    model.init_abstract())
            calls = tp.stats["model_calls"]
            loss, g = value_and_grad(
                lambda p, b: model.loss(p, b, tp=tp),
                shards.shard_tree(params), batch)
            calls = tp.stats["model_calls"] - calls
            whole = shards.gather_tree(g)
            rep = [x for x, d in zip(T.leaves(g), shards.dims) if d is None]
            out = {"arch": arch, "loss": float(loss).hex(),
                   "replicated": params_checksum(rep),
                   "sharded": sum(d is not None for d in shards.dims),
                   "leaves": len(shards.dims), "collectives": calls}
            if tp.rank == 0:
                one_loss, one = value_and_grad(model.loss, params, batch)
                out["one_loss"] = float(one_loss).hex()
                worst, bitwise = 0.0, bool(torch.equal(loss, one_loss))
                for a, b in zip(T.leaves(whole), T.leaves(one)):
                    scale = float(b.abs().max()) or 1.0
                    worst = max(worst, float((a - b).abs().max()) / scale)
                    bitwise = bitwise and bool(torch.equal(a, b))
                out.update(leaf_rel=worst, bitwise=bitwise)
            print(f"[mesh-families] {json.dumps(out)}", flush=True)
            del params, g, whole, shards
    finally:
        group.close()
    torch.cuda.synchronize()
    print(f"[mesh-families] launches {json.dumps(dict(LAUNCHES))}")
    print(f"[mesh-families] seconds {time.perf_counter() - t0:.1f}")


def phase_mesh_families():
    """The ``mesh_families`` check, from the mesh_mamba2 launch's logs:
    every arch's loss on both ranks, the same on each, within
    FAMILY_TP_RTOL of its one-rank loss and each logical gradient leaf
    within FAMILY_TP_LEAF of its largest entry (an M-fold gradient fails);
    granite-moe at full width, whose leaves are all replicated, bitwise;
    the replicated leaves' gradients bitwise the same on both ranks.
    Returns the launches (the inits' draws) summed over the ranks."""
    logs = MESH_LOGS["mesh_two"]
    rows = [[json.loads(x) for x in re.findall(
        r"\[mesh-families\] (\{\"arch.*)", log)] for log in logs]
    if [len(r) for r in rows] != [len(FAMILY_TP_ARCHS)] * len(logs):
        raise AssertionError(f"[mesh-families] rows {[len(r) for r in rows]}")
    for arch, *per_rank in zip(FAMILY_TP_ARCHS, *rows):
        r0 = per_rank[0]
        loss, one = float.fromhex(r0["loss"]), float.fromhex(r0["one_loss"])
        same = all(r["loss"] == r0["loss"] and
                   r["replicated"] == r0["replicated"] for r in per_rank)
        want_bitwise = r0["sharded"] == 0
        print(f"[mesh-families] {arch}: loss {loss!r} on both ranks "
              f"{'(equal)' if same else '(DIFFERENT)'}, one rank {one!r}, "
              f"relative {abs(loss - one) / abs(one):.3e} (limit "
              f"{FAMILY_TP_RTOL:g}); gradients gathered from the shards "
              f"within {r0['leaf_rel']:.3e} of one rank's largest entry a "
              f"leaf (limit {FAMILY_TP_LEAF:g}); bitwise "
              f"{r0['bitwise']}; {r0['sharded']} of {r0['leaves']} leaves "
              f"sharded, {r0['collectives']} model-axis collectives in the "
              f"step; on {SMI}")
        if not same or abs(loss - one) > FAMILY_TP_RTOL * abs(one) or \
                r0["leaf_rel"] > FAMILY_TP_LEAF or \
                (want_bitwise and not r0["bitwise"]):
            raise AssertionError(f"[mesh-families] {arch}: outside the "
                                 "tolerance of one rank")
    total = {}
    for r, log in enumerate(logs):
        launches = json.loads(re.search(
            r"\[mesh-families\] launches (.*)", log)[1])
        secs = re.search(r"\[mesh-families\] seconds (\S+)", log)[1]
        print(f"[mesh-families] rank {r}: launches {launches} in {secs} s")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    if not total.get("threefry_uniform"):
        raise AssertionError("[mesh-families] the inits drew nothing")
    return total


def phase_mesh_specs():
    """The four committed 2x2 specs at smoke size on four gloo ranks
    (and the fsdp specs at 4x1 and made 2x2, ``FSDP_SPECS_2X2``):
    each exits 0 (the launch), prints the file's fingerprint, its exact
    bits and four finite losses, and launches its kernels as MESH_SPECS
    says on every rank.  Returns the launches summed over the ranks and
    specs."""
    from repro_torch.core import ExperimentSpec

    # run in the mesh paths' four-rank launch, after them
    logs = [log.split("[dist] end mesh_heads\n")[1]
            for log in MESH_LOGS["mesh_four"]]
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
    for name, want in ZOO_SPECS.items():
        spec = ExperimentSpec.from_json(
            (ROOT / "examples" / "specs" / f"{name}.json").read_text())
        for r, log in enumerate(logs):
            seg = log.split(f"[mesh-specs] begin {name}")[1].split(
                f"[mesh-specs] end {name}")[0]
            launches = json.loads(re.search(
                rf"\[mesh-specs\] launches {name} (.*)", seg)[1])
            expect = {**dict.fromkeys(launches, 0), **want["launches"]}
            if launches != expect:
                raise AssertionError(f"[fsdp-specs] {name} rank {r}: "
                                     f"launches {launches}, want {expect}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            if r:
                continue
            fps = re.findall(r"spec fingerprint=([0-9a-f]{16})", seg)
            got = [int(x) for x in re.search(
                r"wire: up=(\d+) down=(\d+) total=(\d+) bits/round",
                seg).groups()]
            ratio = re.search(r"\((\d\.\d+)x dense both ways\)", seg)[1]
            losses = [float(x) for x in re.findall(
                r"step\s+\d+ loss=(\S+)", seg)]
            evals = [float(x) for x in re.findall(r"eval @ \d+: loss=(\S+)",
                                                  seg)]
            secs = re.search(rf"\[mesh-specs\] seconds {name} (\S+)", seg)[1]
            print(f"[fsdp-specs] {name}: fingerprint {fps} (file "
                  f"{spec.fingerprint()}, pinned {want['fingerprint']}) "
                  f"bits up/down/total {got} ({ratio}x dense both ways) "
                  f"losses {losses} eval {evals} launches per rank "
                  f"{launches}; {secs} s on four ranks")
            if fps != [want["fingerprint"]] or \
                    spec.fingerprint() != want["fingerprint"] or \
                    got != want["bits"] or len(losses) != ZOO_STEPS_FSDP \
                    or len(evals) != 1 or \
                    not all(map(math.isfinite, losses + evals)):
                raise AssertionError(f"[fsdp-specs] {name}: wrong output")
    for name, want in FSDP_SPECS_2X2.items():
        label = f"{name}_2x2"
        spec = ExperimentSpec.from_json(
            fsdp_spec_2x2_path(name).read_text())
        for r, log in enumerate(logs):
            seg = log.split(f"[mesh-specs] begin {label}")[1].split(
                f"[mesh-specs] end {label}")[0]
            launches = json.loads(re.search(
                rf"\[mesh-specs\] launches {label} (.*)", seg)[1])
            expect = {**dict.fromkeys(launches, 0), **want["launches"]}
            if launches != expect:
                raise AssertionError(f"[fsdp-specs] {label} rank {r}: "
                                     f"launches {launches}, want {expect}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            experts = re.search(rf"\[mesh-specs\] experts {label} (.*)",
                                seg)
            if experts:
                e = json.loads(experts[1])
                print(f"[fsdp-specs] {label} rank {r} (worker {r // 2}): "
                      f"{e['idle_slabs']} of {e['slabs']} expert slabs "
                      "never routed to; h's nonzero entries there "
                      f"{e['nonzero_idle']}, in the routed ones "
                      f"{e['nonzero_active']}")
                if any(e["nonzero_idle"].values()):
                    raise AssertionError(f"[fsdp-specs] {label} rank {r}: "
                                         "an idle expert's slab of h moved")
            elif spec.problem.startswith("granite-moe"):
                raise AssertionError(f"[fsdp-specs] {label}: no expert "
                                     "check")
            if r:
                continue
            fps = re.findall(r"spec fingerprint=([0-9a-f]{16})", seg)
            got = [int(x) for x in re.search(
                r"wire: up=(\d+) down=(\d+) total=(\d+) bits/round",
                seg).groups()]
            losses = [float(x) for x in re.findall(
                r"step\s+\d+ loss=(\S+)", seg)]
            evals = [float(x) for x in re.findall(r"eval @ \d+: loss=(\S+)",
                                                  seg)]
            secs = re.search(rf"\[mesh-specs\] seconds {label} (\S+)",
                             seg)[1]
            print(f"[fsdp-specs] {label}: mesh {spec.mesh}, fingerprint "
                  f"{fps} (file {spec.fingerprint()}, pinned "
                  f"{want['fingerprint']}) bits up/down/total {got} losses "
                  f"{losses} eval {evals} launches per rank {launches}; "
                  f"{secs} s on four ranks (2 processes x 2)")
            if fps != [want["fingerprint"]] or \
                    spec.fingerprint() != want["fingerprint"] or \
                    got != want["bits"] or len(losses) != ZOO_STEPS_FSDP \
                    or len(evals) != 1 or \
                    not all(map(math.isfinite, losses + evals)):
                raise AssertionError(f"[fsdp-specs] {label}: wrong output")
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
    """Where a full-width step's time goes, on from the state, step
    function and batches of the path's run (``phase_main``, which keeps
    them in PROFILE_RUNS): after a warm-up step, one step
    timed on the host clock (for rand-k with its shuffles between CUDA
    events, ``timed_choices``) and one traced with torch.profiler, the
    device's activity only (device time by kernel, and the device's busy
    share of the untraced step).  A
    trace whose rows cannot be read is reported, not failed; a failure of
    the steps themselves fails the phase.  Then where its memory goes
    (``phase_peaks``, and for the QSGD path ``memory_probes``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random
    from repro_torch import tree as T

    path = PATHS.get(name, {})
    secs, t_lap = {}, time.perf_counter()

    def lap(label):
        nonlocal t_lap
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t_lap
        t_lap = time.perf_counter()

    state, step_fn, data = PROFILE_RUNS.pop(name)
    collect(f"[profile] {name}")
    lap("collect")
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
    batch_extras_ms(name, data, untraced)
    t0 = time.perf_counter()
    # the device's activity alone: a trace of the step's tens of thousands
    # of CPU ops took seconds to read (and their rows would count every
    # kernel a second time)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, data.batch(2), random.fold_in(key, 2))
        loss = float(m["loss"])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    lap("steps")
    if not math.isfinite(loss):
        raise AssertionError(f"[profile] {name}: traced step loss {loss}")
    try:
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    except Exception as e:  # reading the trace, not the port: report it
        print(f"[profile] {name}: not measured: {e!r}")
        rows = None
    busy = None
    if rows is not None:
        busy = print_profile(name, rows, untraced, wall)
    lap("trace_rows")
    if name == "randk":
        print(f"[profile] randk: the shuffles of the untraced step "
              f"({choices} random.choice calls between CUDA events) "
              f"ms={shuffle_ms:.2f}, {shuffle_ms / untraced:.3f} of it")
    if path.get("op"):
        state = op_share(name, path, state, step_fn, data, busy)
        lap("op_share")
    # the holder is the only reference to the state, as the launcher's loop
    # variable is: a second one would keep a stale state alive in the steps
    holder = {"state": state}
    del state, prof
    phase_peaks(name, holder, step_fn, data)
    lap("peaks")
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
    lap("probes")
    print(f"[profile] {name}: seconds " + " ".join(
        f"{k}={v:.1f}" for k, v in secs.items()))


def batch_extras_ms(name, data, untraced):
    """The encdec's frames or the vlm's vision embeddings of the untraced
    step (``train.family_batch_extras``, numpy's standard normals), drawn
    on the host and copied to the card on their own, as the trainer copies
    a batch (``torch.as_tensor`` from pageable memory); nothing for the
    other families."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    extras = train.family_batch_extras(data.cfg, data.global_batch, 1)
    if not extras:
        return
    draw = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = {k: torch.as_tensor(v, device="cuda")
               for k, v in extras.items()}
    torch.cuda.synchronize()
    copy = (time.perf_counter() - t0) * 1e3
    del on_card
    mb = sum(v.nbytes for v in extras.values()) / 1e6
    print(f"[profile] {name}: batch extras ({', '.join(extras)}, "
          f"{mb:.1f} MB) host draw_ms={draw:.2f} copy_to_card_ms="
          f"{copy:.2f}, {(draw + copy) / untraced:.3f} of the untraced step")


def print_profile(name, rows, untraced, wall):
    """Device time by kernel of the traced step, and its busy share;
    returns the step's device kernel ms."""
    kernels = PATHS[name]["profile"] if name in PATHS else FINETUNE_PROFILE
    busy = sum(r[0] for r in rows)
    print(f"[profile] {name}: traced step wall_ms={wall:.2f} (profiler "
          f"overhead included) device_kernel_ms={busy:.2f}; busy share of "
          f"the untraced step {busy / untraced:.3f}")
    for kernel in kernels:
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
    return busy


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


PHASES = ("value_aux_and_grad", "compress_local", "exchange",
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


# ---------------------------------------------------------------------------
# serving: the decode step, the push protocol and the replica fleet
# ---------------------------------------------------------------------------

SERVE_DELTA_SPEC = ROOT / "examples" / "specs" / "serve_delta.json"
#: JAX's ``run_fleet`` of the committed spec (``BENCH_bits.json``'s
#: ``serve_delta`` row), written here
SERVE_DELTA_JAX = {"fingerprint": "7d408c73e1bcf250",
                   "delta_bits_per_push": 2_734_560,
                   "checkpoint_bits_per_push": 10_935_936,
                   "push_ratio": "0.250053", "requests": 8}
#: the committed spec with ``smoke: false``: mamba2-130m whole (15 leaves)
SERVE_DELTA_FULL_BITS = (1_031_868_512, 4_127_471_744)
SERVE_FLEET_SPEC = ROOT / "build" / "spec" / "serve_fleet.json"
SERVE_FLEET_SERVE = "replicas:2,slots:4,prompt:16,gen:16,max_len:64,pushes:3"
#: qwen2-0.5b at full width, qsgd:16: a push (header + one broadcast) and
#: a full f32 copy under the same header
SERVE_FLEET_BITS = (3_952_262_720, 15_809_048_704)
SERVE_CKPT = ROOT / "build" / "ckpt" / "serve_delta"
#: one decode per family at smoke size, card against CPU
SERVE_FAMILIES = ("qwen2-0.5b", "granite-moe-3b-a800m", "mamba2-130m",
                  "zamba2-7b", "whisper-medium", "qwen2-vl-2b")
#: a top-2 logit gap at or below this may flip the greedy token between
#: the card and the CPU (f32 activations: the CPU tests' atol)
SERVE_GAP = 3e-5


def serve_launches(spec, init_draws, leaves):
    """The threefry launches of one fleet run: the init's draws, a
    uniform draw a leaf a push (QSGD's stochastic rounding) and a normal
    draw a leaf a push (the simulated training move), and two word draws
    a prompt (``random.randint``); no other kernel."""
    sv = spec.serve_spec()
    prompts = sv.replicas * 2 * sv.slots
    return {"threefry_uniform": init_draws + 2 * sv.pushes * leaves
            + 2 * prompts}


def recording_threefry_shapes():
    """Wrap ``threefry.threefry_fill`` so that every call on the card
    notes (n, as_float).  Returns (the notes, a function that restores
    the wrapper)."""
    from repro_torch.kernels import threefry

    seen, fill = set(), threefry.threefry_fill

    def noted(key, n, device, as_float):
        if device.type == "cuda":
            seen.add((int(n), bool(as_float)))
        return fill(key, n, device, as_float)

    def restore():
        threefry.threefry_fill = fill

    threefry.threefry_fill = noted
    return seen, restore


def check_threefry_shapes(label, seen):
    """Each (n, as_float) a serving path drew on the card, held bitwise
    against the plain version on the card under a fresh key."""
    from repro_torch import random
    from repro_torch.kernels import ref, threefry

    dev = torch.device("cuda")
    key = random.fold_in(random.key(0), 28)
    for n, as_float in sorted(seen):
        k = threefry.threefry_fill(key, n, dev, as_float)
        p = ref.threefry_ref(key, n, dev, as_float)
        if not same_bits(k, p):
            raise AssertionError(f"[{label}] threefry n={n} as_float="
                                 f"{as_float}: kernel != plain")
        del k, p
    torch.cuda.empty_cache()
    print(f"[{label}] threefry at the path's own shapes (n, as_float), each "
          f"bitwise == plain on the card: {sorted(seen)}")


def run_serve_cli(label, argv):
    """``repro_torch.launch.train.main(["serve", ...])`` on the card, its
    output printed; launch counts reset just before and read just after.
    Returns (its metrics, its output, the launches, the threefry shapes,
    seconds)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    out = io.StringIO()
    seen, restore = recording_threefry_shapes()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            reset_launches()
            metrics = train.main(["serve"] + argv)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
    finally:
        restore()
        print(out.getvalue().rstrip())
    secs = time.perf_counter() - t0
    print(f"[{label}] {' '.join(argv)}: seconds={secs:.2f} metrics="
          f"{json.dumps(metrics)} launches={launches}")
    return metrics, out.getvalue(), launches, seen, secs


def check_fleet(label, metrics, spec, bits, launches, want_launches):
    """The fleet's metrics: the spec's fingerprint, the exact bits, every
    request and token served; the launches as stated."""
    sv = spec.serve_spec()
    requests = sv.replicas * 2 * sv.slots
    want = {"fingerprint": spec.fingerprint(), "replicas": sv.replicas,
            "pushes": sv.pushes, "requests": requests,
            "tokens": requests * (sv.prompt + sv.gen),
            "delta_bits_per_push": bits[0],
            "checkpoint_bits_per_push": bits[1]}
    bad = {k: (metrics[k], v) for k, v in want.items() if metrics[k] != v}
    full = {**dict.fromkeys(launches, 0), **want_launches}
    if bad or launches != full:
        raise AssertionError(f"[{label}] metrics (got, want) {bad}; "
                             f"launches {launches}, want {full}")
    print(f"[{label}] every replica's w bitwise the pusher's after each of "
          f"the {sv.pushes} pushes (asserted by run_fleet); "
          f"{metrics['delta_bits_per_push']} delta bits against "
          f"{metrics['checkpoint_bits_per_push']} checkpoint bits a push "
          f"({metrics['push_ratio']:.6f}x); {metrics['requests']} requests, "
          f"{metrics['tokens']} tokens")


def decode_profile(label, engine, params):
    """The decode step of a fleet's engine, on from its state with its
    replica's last params: every lane fed a token at position 20, one
    warm-up step, median host time of 5 synchronised steps, then one step
    under torch.profiler (the device's activity): device kernel time,
    kernel launches, busy share of the untraced step."""
    from torch.profiler import ProfilerActivity, profile

    B = engine.slots
    tok = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((B,), 20, dtype=torch.int64, device="cuda")

    def step():
        logits, _ = engine.model.decode_step(params, engine.cache, tok, pos)
        return torch.argmax(logits[:, -1], dim=-1).cpu()

    step()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    untraced = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    try:
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    except Exception as e:  # reading the trace, not the port: report it
        print(f"[{label}] decode step: trace not measured: {e!r}")
        return
    busy = sum(r[0] for r in rows)
    print(f"[{label}] decode step ({B} lanes, {engine.cfg.n_layers} layers): "
          f"untraced wall_ms={untraced:.3f} (median of 5) "
          f"device_kernel_ms={busy:.3f} kernels={sum(r[1] for r in rows)} "
          f"busy share {busy / untraced:.3f}")
    for t, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[{label}]   {t:8.3f} ms x{count:<5d} {key[:80]}")


def phase_serve_fleet():
    """The slice's main path: the replica fleet (``serve --spec``) of
    qwen2-0.5b at full width and depth from JAX's weights (seed 0),
    ``downlink: qsgd:16`` and SERVE_FLEET_SERVE, its spec written under
    ``build/``: run_fleet asserts every replica's w bitwise the pusher's
    after each of the 3 pushes; the exact bits, the requests and tokens,
    the launches (the init's 169 threefry draws and the pushes' and
    prompts'), tok/s, the largest stage and swap, the peak, and the decode
    step's device time and busy share."""
    import dataclasses as dc

    from repro_torch.core import ExperimentSpec
    from repro_torch.launch import train

    base = ExperimentSpec.from_json(SERVE_DELTA_SPEC.read_text())
    spec = dc.replace(base, problem="qwen2-0.5b", smoke=False,
                      serve=SERVE_FLEET_SERVE)
    SERVE_FLEET_SPEC.parent.mkdir(parents=True, exist_ok=True)
    SERVE_FLEET_SPEC.write_text(spec.to_json())
    print(f"[serve_fleet] wrote {SERVE_FLEET_SPEC.relative_to(ROOT)}: "
          f"fingerprint {spec.fingerprint()}")
    collect("[serve_fleet]")
    kept = {}
    step = train.DecodeEngine.step

    def keep(engine, params, **kw):
        kept["run"] = (engine, params)
        return step(engine, params, **kw)

    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train.DecodeEngine.step = keep
    try:
        metrics, _, launches, seen, _ = run_serve_cli(
            "serve_fleet", ["--spec", str(SERVE_FLEET_SPEC)])
    finally:
        train.DecodeEngine.step = step
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    check_fleet("serve_fleet", metrics, spec, SERVE_FLEET_BITS, launches,
                serve_launches(spec, INIT_DRAWS, FULL_LEAVES))
    print(f"[serve_fleet] {metrics['tok_per_s']:.1f} tok/s; stage_ms max "
          f"{metrics['stage_ms_max']:.3f}, swap_ms max "
          f"{metrics['swap_ms_max']:.4f}; peak {peak:.2f} GiB above the "
          f"{base_mem / 2**30:.2f} GiB held before; threefry_fill launches "
          f"{launches['threefry_uniform']}")
    engine, params = kept.pop("run")
    decode_profile("serve_fleet", engine, params)
    del engine, params
    check_threefry_shapes("serve_fleet", seen)
    return launches


def phase_serve_delta():
    """The committed ``serve_delta.json`` (mamba2's smoke config) through
    ``serve --spec`` on the card, JAX's fingerprint and bits; the same spec
    with ``smoke: false`` (mamba2-130m whole), its own bits; and one
    dropped push: the replica sees a gap, resyncs from the checkpoint
    directory and is bitwise the pusher's again."""
    import dataclasses as dc

    from repro_torch import random
    from repro_torch import tree as T
    from repro_torch.core import ExperimentSpec
    from repro_torch.core.efbv import Downlink
    from repro_torch.launch import train

    spec = ExperimentSpec.from_json(SERVE_DELTA_SPEC.read_text())
    total = collections.Counter()
    m, _, launches, seen, _ = run_serve_cli(
        "serve_delta", ["--spec", str(SERVE_DELTA_SPEC)])
    got = {"fingerprint": m["fingerprint"],
           "delta_bits_per_push": m["delta_bits_per_push"],
           "checkpoint_bits_per_push": m["checkpoint_bits_per_push"],
           "push_ratio": f"{m['push_ratio']:.6f}",
           "requests": m["requests"]}
    print(f"[serve_delta] committed spec: {got}; JAX's {SERVE_DELTA_JAX}")
    if got != SERVE_DELTA_JAX:
        raise AssertionError("[serve_delta] not JAX's metrics")
    check_fleet("serve_delta", m, spec, (SERVE_DELTA_JAX[
        "delta_bits_per_push"], SERVE_DELTA_JAX["checkpoint_bits_per_push"]),
        launches, serve_launches(spec, SMOKE_MAMBA2_INIT_DRAWS,
                                 MAMBA2_LEAVES))
    total.update(launches)
    full = dc.replace(spec, smoke=False)
    path = ROOT / "build" / "spec" / "serve_delta_full.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(full.to_json())
    m, _, launches, more, _ = run_serve_cli(
        "serve_delta", ["--spec", str(path)])
    check_fleet("serve_delta", m, full, SERVE_DELTA_FULL_BITS, launches,
                serve_launches(full, MAMBA2_INIT_DRAWS, MAMBA2_LEAVES))
    print(f"[serve_delta] mamba2-130m whole: fingerprint "
          f"{m['fingerprint']}, {m['delta_bits_per_push']} delta bits "
          f"against {m['checkpoint_bits_per_push']} ({m['push_ratio']:.6f}x),"
          f" {m['tok_per_s']:.1f} tok/s, stage_ms max "
          f"{m['stage_ms_max']:.3f}")
    total.update(launches)
    seen |= more
    # a dropped push: the gap resyncs from the pusher's checkpoints
    cfg = train.run_config(spec)
    params = train.build_model(cfg).init(random.key(3), device="cuda")
    dl = Downlink.parse(spec.downlink)
    if SERVE_CKPT.exists():
        for f in SERVE_CKPT.iterdir():
            f.unlink()
    pusher = train.DeltaPusher(dl, params, key=random.key(4),
                               ckpt_dir=str(SERVE_CKPT), spec=spec)
    rep = train.ServeReplica(dl, pusher.w, ckpt_dir=str(SERVE_CKPT),
                             spec=spec)
    x = params
    states = []
    for v in (1, 2, 3):
        x = train._train_move(x, random.fold_in(random.key(5), v))
        env = pusher.push(x)
        if v != 2:  # push 2 is dropped on the floor
            states.append(rep.push(env))
    train._assert_fleet_pinned(pusher, [rep])
    print(f"[serve_delta] dropped push 2: push 1 {states[0]}, push 3 "
          f"{states[1]} (a gap), {rep.resyncs} resync from "
          f"{SERVE_CKPT.relative_to(ROOT)}; the replica at version "
          f"{rep.version} bitwise the pusher's w ({len(T.leaves(rep.params))}"
          " leaves)")
    if states != ["applied", "resync"] or rep.resyncs != 1:
        raise AssertionError(f"[serve_delta] resync states {states}")
    del params, pusher, rep, x
    check_threefry_shapes("serve_delta", seen)
    return dict(total)


def greedy_tokens(model, params, prompts, gen, frames, device):
    """The fixed-batch greedy loop of ``decode_step`` on ``device``:
    (ids (B, gen), the top-2 logit gaps)."""
    B, P = prompts.shape
    cache = model.init_cache(B, 16, device)
    if frames is not None:
        cache = model.encode_cross_cache(
            params, torch.from_numpy(frames).to(device), cache)
    tok, outs, gaps = None, [], []
    for t in range(P + gen):
        inp = torch.from_numpy(prompts[:, t:t + 1]).to(device) if t < P \
            else tok
        logits, cache = model.decode_step(params, cache, inp, t)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if t >= P:
            top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            outs.append(tok[:, 0].cpu().numpy())
            gaps.append((top[:, 0] - top[:, 1]).cpu().numpy())
    import numpy as np
    return np.stack(outs, 1), np.stack(gaps, 1)


def phase_serve_families():
    """One smoke-config decode per family (dense, moe, ssm, hybrid, encdec,
    vlm; f32 activations, JAX's weights from the CPU): 3 requests of 4 + 6
    tokens, the card's fixed-batch greedy ids against the CPU's (equal up
    to the first position where the CPU's top-2 gap is within SERVE_GAP, a
    near tie), and the card's engine (2 slots: staggered lanes) equal to
    the card's fixed batch."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.launch import train
    from repro_torch.models.model import build_model

    total = collections.Counter()
    for arch in SERVE_FAMILIES:
        cfg, params = smoke_params(arch)
        model = build_model(cfg)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab, (3, 4))
        frames = (rng.standard_normal((3, cfg.encoder_frames, cfg.d_model))
                  * 0.1).astype(np.float32) \
            if cfg.family == "encdec" else None
        cpu, gaps = greedy_tokens(model, params, prompts, 6, frames, "cpu")
        card_params = T.tree_map(lambda a: a.cuda(), params)
        from repro_torch.kernels import LAUNCHES, reset_launches
        reset_launches()
        card, _ = greedy_tokens(model, card_params, prompts, 6, frames,
                                torch.device("cuda"))
        eng = train.DecodeEngine(model, slots=2, max_len=16, device="cuda")
        reqs = [eng.submit(prompts[i], 6,
                           frames=None if frames is None else frames[i])
                for i in range(3)]
        eng.run(card_params)
        torch.cuda.synchronize()
        total.update(LAUNCHES)
        engine = np.stack([r.out for r in reqs])
        compared = 0
        for i in range(3):
            for p in range(6):
                if gaps[i, p] <= SERVE_GAP:
                    break
                if card[i, p] != cpu[i, p]:
                    raise AssertionError(
                        f"[serve_families] {cfg.name}: request {i} token "
                        f"{p} card {card[i, p]} cpu {cpu[i, p]} (gap "
                        f"{gaps[i, p]:.3e})")
                compared += 1
        print(f"[serve_families] {cfg.name} ({cfg.family}): card ids "
              f"{card.tolist()}, CPU ids {cpu.tolist()}; {compared} of 18 "
              f"compared (top-2 gap above {SERVE_GAP}), equal; engine "
              f"(2 slots) {'equal to' if np.array_equal(engine, card) else 'NOT equal to'}"
              " the card's fixed batch")
        if not np.array_equal(engine, card) or compared < 9:
            raise AssertionError(f"[serve_families] {cfg.name} failed")
        del card_params, eng
    torch.cuda.empty_cache()
    return dict(total)


# ---------------------------------------------------------------------------
# 7. the tooling slice: --sanitize, the dense-free gate, the dry run
# ---------------------------------------------------------------------------

#: JAX's ``make sanitize-smoke``, its two commands on the card (the train
#: command's 2x2 mesh on four gloo ranks sharing cuda:0)
SANITIZE_TRAIN = ["--arch", "qwen2-0.5b", "--smoke", "--mesh", "2x2",
                  "--steps", "2", "--global-batch", "8", "--seq", "32",
                  "--compressor", "block_topk:256,16", "--agg",
                  "sparse_allgather", "--dist-backend", "gloo",
                  "--log-every", "1"]
SANITIZE_FINETUNE = ["finetune", "--spec",
                     str(ROOT / "examples" / "specs" / "finetune_moe.json"),
                     "--steps", "2", "--global-batch", "8", "--seq", "32",
                     "--eval-every", "2", "--log-every", "1"]


def step_losses(text):
    """The step lines' losses of a driver's output, in order."""
    return re.findall(r"step\s+\d+ loss=([0-9.]+)", text)


def one_run(fn):
    """``fn()`` with launch counts reset just before it and read just
    after: (its result as hex, its step losses, the counts); its output
    is printed too."""
    from repro_torch import kernels

    kernels.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    torch.cuda.synchronize()
    print(buf.getvalue(), end="", flush=True)
    return [float(res).hex(), step_losses(buf.getvalue()),
            dict(kernels.LAUNCHES)]


@contextlib.contextmanager
def one_process():
    """torchrun's WORLD_SIZE hidden: a driver run inside a rank runs as
    one process."""
    import os

    world = os.environ.pop("WORLD_SIZE")
    try:
        yield
    finally:
        os.environ["WORLD_SIZE"] = world


def nan_check():
    """A NaN put in a param leaf of the qwen2 smoke model: the sanitized
    step must raise FloatingPointError naming an op (its message)."""
    from repro_torch import random
    from repro_torch.core import ExperimentSpec, build
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import sanitized_step

    cfg = train.get_smoke_config("qwen2-0.5b")
    spec = ExperimentSpec(problem="qwen2-0.5b", smoke=True,
                          backend="shard_map", mesh="2x1", n=2,
                          compressor="block_topk:256,16",
                          agg="sparse_allgather", d=train.tuning_dim(cfg))
    run_ = build(spec)
    model = build_model(cfg)
    params = model.init(random.key(0), device="cuda")
    params["layers"]["mlp"]["wg"][0, 0, 0] = float("nan")
    opt = train.adamw(train.cosine(3e-4, 10, 1))
    step = sanitized_step(run_.train_step(model.loss, opt))
    rng = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (8, 32), generator=rng)
             for k in ("tokens", "labels")}
    try:
        step(run_.init_state(params, opt), batch, random.key(0))
    except FloatingPointError as e:
        return str(e).splitlines()[0]
    return "no error"


def sanitize_rank(outdir):
    """One of the four ranks of the sanitize launch: the train command on
    2x2 as is, then under ``--sanitize`` (each over its own file store);
    then, side by side, rank 1 runs the finetune command as one process
    under ``--sanitize``, rank 3 the same command as is (its sanitize mode
    switched off again first) and rank 2 the NaN check.  Prints one JSON
    line of results."""
    import os

    from repro_torch import kernels
    from repro_torch.launch import train

    rank = int(os.environ["RANK"])
    res = {}
    for tag, extra in (("plain", []), ("sanitized", ["--sanitize"])):
        res[tag] = one_run(lambda: train.main(
            SANITIZE_TRAIN + extra
            + ["--dist-init", f"file://{outdir}/store_{tag}"]))
    if rank in (1, 3):
        extra = ["--sanitize"] if rank == 1 else []
        if rank == 3:
            kernels._sanitize = False
            os.environ.pop(kernels.SANITIZE_ENV)
        with one_process():
            res["finetune"] = one_run(
                lambda: train.main(SANITIZE_FINETUNE + extra))
    if rank == 2:
        res["nan"] = nan_check()
    print("[sanitize] " + json.dumps(res), flush=True)


def phase_sanitize():
    """JAX's two ``sanitize-smoke`` commands on the card: each run as is
    and under ``--sanitize`` must end with the same losses (bitwise: the
    plain versions are the kernels' bits), the sanitized run launching no
    kernel (every wrapper on its plain version) and the unsanitized one
    launching the pack kernel; a NaN in a param leaf raises
    FloatingPointError naming an op."""
    t0 = time.perf_counter()
    logs = run_ranks("sanitize", ranks=4, timeout=300)
    recs = [json.loads(re.search(r"\[sanitize\] (\{.*)", log).group(1))
            for log in logs]
    pairs = [(f"train rank {r}", rec["plain"], rec["sanitized"])
             for r, rec in enumerate(recs)]
    pairs.append(("finetune", recs[3]["finetune"], recs[1]["finetune"]))
    for what, plain, sane in pairs:
        if plain[:2] != sane[:2] or any(sane[2].values()) \
                or not plain[2]["pack_update"]:
            raise AssertionError(f"[sanitize] {what}: {plain} then {sane}")
    if len(recs[0]["plain"][1]) != 2 or len(recs[3]["finetune"][1]) != 2:
        raise AssertionError(f"[sanitize] step lines: {recs}")
    if "invalid value (nan) encountered in aten." not in recs[2]["nan"]:
        raise AssertionError(f"[sanitize] NaN: {recs[2]['nan']}")
    ft = recs[3]["finetune"]
    print(f"[sanitize] train 2x2 (4 gloo ranks): losses "
          f"{recs[0]['plain'][1]} final {float.fromhex(recs[0]['plain'][0])!r}"
          f" with and without --sanitize, launches {recs[0]['plain'][2]} "
          f"then none; finetune losses {ft[1]} eval "
          f"{float.fromhex(ft[0])!r} both ways, launches {ft[2]} then none; "
          f"NaN -> {recs[2]['nan']}; {time.perf_counter() - t0:.1f} s")


def phase_dense_free():
    """``kernels.ops.dense_free`` of the three pack kernels: at JAX's
    cases' shapes and the full-width embed leaf, the device bytes above
    what was held before each call within the declared outputs + 1 MiB."""
    from repro_torch.kernels import ops

    for name in ops.DENSE_FREE_CASES:
        rep = ops.dense_free(name, "cuda")
        print(f"[dense_free] {name}: " + "; ".join(
            f"d={d} declared={dec} above={above} "
            f"({above - dec:+d} B)" for d, dec, above in rep.cases)
            + f" slack={rep.slack} ok={rep.ok} [{SMI}]")
        if not rep.ok:
            raise AssertionError(f"[dense_free] {name}: {rep.violations}")
        gc.collect()
        torch.cuda.empty_cache()


def sanitizer_child():
    """Child process run under compute-sanitizer: each of the nine
    kernels' wrappers once at small shapes (``--sanitizer-child all``), or
    only the kernels that use shared memory (``shared``: ``pack_update``,
    rand-k's tile kernel on its scan and bucketed plans, ``worker_sum``,
    ``block_topk`` a warp and a CTA per row, the row shuffle below and
    above 48 KB); prints the launches."""
    import numpy as np

    from repro_torch import kernels, random
    from repro_torch.kernels import ops, pack, threefry

    shared = sys.argv[2] == "shared"
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    for nb, block, kb in ((64, 256, 16), (8, 2048, 64)):
        pack.pack_update(randn(nb, block), randn(nb, block), 0.37, kb)
        pack.block_topk(randn(nb, block), kb)
    for size, k in ((4096, 16), (1 << 20, 1 << 14)):
        idx = torch.randperm(size, device="cuda",
                             generator=gen)[:k].to(torch.int32)
        pack.randk_update(randn(size), randn(size), idx, size / k, 0.37)
    for n in (4, 40):
        ops.worker_sum(randn(n, 1000), torch.full((n,), 0.5, device="cuda"),
                       randn(1000), 0.3, 0.7)
    for n, m, k in ((40, 56, 1), (3, 1626, 5), (2, 16384, 16384)):
        sub, _ = random._shuffle_keys(random.split(random.key(m), n), m,
                                      "cuda")
        threefry.shuffle_rows(sub, n, m, k)
    if not shared:
        g, h = randn(4096), randn(4096)
        norm = torch.linalg.vector_norm(g - h).reshape(1)
        pack.qsgd_pack_update(g, h, torch.rand(4096, device="cuda",
                                               generator=gen), norm, 0.37, 16)
        pack.efbv_update(randn(64, 256), randn(64, 256), 0.37, 16)
        threefry.threefry_fill(np.array([0, 42], np.uint32), 5000,
                               torch.device("cuda"), True)
        threefry.threefry_rows(torch.tensor([[0, 1], [2, 3]], device="cuda",
                                            dtype=torch.int32), 700, False)
    torch.cuda.synchronize()
    print(f"[compute-sanitizer] child launched {dict(kernels.LAUNCHES)}",
          flush=True)
    return 0


#: the control: a CUDA program without PyTorch, one in-bounds kernel, run
#: under the same tool before the kernels are
SANITIZER_CONTROL = r"""
#include <cstdio>
__global__ void fill(int *out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = i;
}
int main() {
  int *out;
  if (cudaMalloc(&out, 1000 * sizeof(int)) != cudaSuccess) return 2;
  fill<<<4, 256>>>(out, 1000);
  cudaError_t err = cudaDeviceSynchronize();
  printf("control: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 3;
}
"""

#: the tools and the child's kernels each runs: memcheck over all nine,
#: racecheck over those that use shared memory
SANITIZER_RUNS = (("memcheck", "all"), ("racecheck", "shared"))


def sanitizer_tool():
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "compute-sanitizer"
    if not tool.exists():
        raise AssertionError(f"[compute-sanitizer] not in the toolkit "
                             f"({tool})")
    return str(tool)


def run_sanitized(argv, label, timeout=600):
    """``argv`` under each tool's ``--error-exitcode 1``; fails unless the
    run exits 0 with no error in the tool's summary."""
    import os

    t0 = time.perf_counter()
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    out = subprocess.run(argv, capture_output=True, text=True,
                         timeout=timeout, env=env)
    text = out.stdout + out.stderr
    summary = [ln for ln in text.splitlines() if "ERROR SUMMARY" in ln]
    print(f"[compute-sanitizer] {label}: exit {out.returncode} "
          f"{summary[-1:] or 'no summary'} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if out.returncode != 0 or not summary \
            or "ERROR SUMMARY: 0 errors" not in summary[-1]:
        raise AssertionError(f"[compute-sanitizer] {label}: exit "
                             f"{out.returncode}\n{text[-3000:]}")


def phase_compute_sanitizer():
    """compute-sanitizer over a control program without PyTorch, then over
    ``sanitizer_child``: memcheck of the nine kernels, racecheck of those
    that use shared memory.  Not in the default run: under the tool the
    card's CUDA context fails to start on the machine this was written for
    (``python3 chip_smoke.py --compute-sanitizer`` runs it alone)."""
    from repro_torch.kernels import build

    tool = sanitizer_tool()
    version = subprocess.run([tool, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    print(f"[compute-sanitizer] {version.splitlines()[-1:]}")
    work = ROOT / "build" / "sanitizer"
    work.mkdir(parents=True, exist_ok=True)
    (work / "control.cu").write_text(SANITIZER_CONTROL)
    subprocess.run([build.nvcc_path(), "-arch=sm_90a", "-o",
                    str(work / "control"), str(work / "control.cu")],
                   check=True, timeout=300)
    subprocess.run([str(work / "control")], check=True, timeout=60)
    for tool_name, which in SANITIZER_RUNS:
        base = [tool, "--tool", tool_name, "--error-exitcode", "1"]
        run_sanitized(base + [str(work / "control")],
                      f"{tool_name} control (no PyTorch)")
        run_sanitized(base + [sys.executable, str(Path(__file__).resolve()),
                              "--sanitizer-child", which],
                      f"{tool_name} kernels ({which})")


#: the dry run's check against the card: qwen2-0.5b whole, one rank, one
#: worker, global batch 8, sequence 128
DRYRUN_CHECK = ("chip_1x1_train", 128, 8)
DRYRUN_TOLERANCE = 0.10


def phase_dryrun():
    """The dry run (``launch.train dryrun``) of qwen2-0.5b at the four
    shapes on the 16x16 mesh (rank 0 of 256 on the meta device); then its
    per-rank argument and argument + temp for a 1x1 train step at global
    batch 8, sequence 128, and the same step on the card: its
    ``max_memory_allocated`` above what was held before within 10% of
    argument + temp."""
    from repro_torch.distributed.aggregate import make_mesh
    from repro_torch.launch import train

    t0 = time.perf_counter()
    for shape in train.SHAPES:
        rec = train.dryrun_one("qwen2-0.5b", shape)
        if rec["status"] != "ok":
            raise AssertionError(f"[dryrun] {shape}: {rec}")
        m, r = rec["memory"], rec["roofline"]
        print(f"[dryrun] qwen2-0.5b {shape} 16x16: argument "
              f"{m['argument_size_in_bytes']} temp "
              f"{m['temp_size_in_bytes']} output "
              f"{m['output_size_in_bytes']} flops {r['flops_per_rank']} "
              f"bytes {r['bytes_per_rank']} collectives "
              f"{r['coll_breakdown']} bottleneck {r['bottleneck']} "
              f"host reads {rec['host_reads_skipped']}")
    name, seq, batch = DRYRUN_CHECK
    shape = train.ShapeSpec(name, seq, batch, "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    rec = train.dryrun_one("qwen2-0.5b", shape, mesh=mesh)
    m = rec["memory"]
    pred = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args, run, _, _ = train.dryrun_program("qwen2-0.5b", shape, mesh,
                                           device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del args, run
    gc.collect()
    torch.cuda.empty_cache()
    ratio = peak / pred
    print(f"[dryrun] 1x1 qwen2-0.5b train (batch {batch}, seq {seq}): "
          f"predicted argument {m['argument_size_in_bytes']} + temp "
          f"{m['temp_size_in_bytes']} = {pred} B; card: held {held} B "
          f"before the step, max_memory_allocated {peak} B above the "
          f"process's base, {ratio:.4f}x the prediction [{SMI}]; "
          f"{time.perf_counter() - t0:.1f} s")
    if abs(ratio - 1) > DRYRUN_TOLERANCE:
        raise AssertionError(f"[dryrun] card peak {peak} B not within "
                             f"{DRYRUN_TOLERANCE:.0%} of {pred} B")


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
    # under vmap, its shuffle's sorts and its worker mean are XLA's
    "threefry_rows": ("src/repro_torch/kernels/csrc/threefry.cu",
                      "src/repro/core/efbv.py:604 (jax.random under vmap "
                      "over the workers of run_reference; no Pallas "
                      "kernel)"),
    "shuffle_rows": ("src/repro_torch/kernels/csrc/threefry.cu",
                     "src/repro/core/compressors.py:206 (comp-(k, k')'s "
                     "jax.random.choice under vmap over the workers of "
                     "run_reference, src/repro/core/efbv.py:604: XLA's "
                     "sorts; no Pallas kernel)"),
    "worker_sum": ("src/repro_torch/kernels/csrc/worker_sum.cu",
                   "src/repro/core/efbv.py:608 (jnp.mean over the vmapped "
                   "workers, and :611 masked; no Pallas kernel)"),
}


#: the card's name and power limit (``nvidia-smi``), printed beside the
#: mesh paths' numbers
SMI = ""


def main():
    global SMI
    if sys.argv[1:2] == ["--randk-trap-child"]:
        return randk_trap_child()
    if sys.argv[1:2] == ["--dist-child"]:
        return dist_child()
    if sys.argv[1:2] == ["--sanitizer-child"]:
        return sanitizer_child()
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
    SMI = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")
    if sys.argv[1:2] == ["--compute-sanitizer"]:
        phase_build()
        phase_compute_sanitizer()
        return 0

    t0 = time.perf_counter()
    took = {}

    def timed(label, fn, *args):
        """``fn(*args)``, its seconds kept under ``label`` (summed)."""
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        took[label] = took.get(label, 0.0) + time.perf_counter() - t
        return out

    timed("build", phase_build)
    timing = timed("kernels", phase_kernels)
    timed("reference", phase_reference)
    timed("zoo", phase_zoo)
    timed("families", phase_families)
    timed("reference_dist", phase_reference_dist)
    launches = {}
    launches["reference"] = timed("reference_spec", phase_reference_spec)
    for name in PATHS:
        launches[name] = timed(name, phase_main, name)
        if PATHS[name]["profile"] is not None:
            timed(name, phase_profile, name)
    launches["cli_smoke"] = timed("cli_smoke", phase_cli_smoke)
    launches["finetune"] = timed("finetune", phase_finetune)
    timed("finetune", phase_profile, "finetune")
    for name in DIST_PATHS:
        launches[name] = timed(name, phase_dist, name)
    # mesh's launch also runs mesh_heads and mesh_specs, mesh_mamba2's
    # the mesh_families check: each phase reads its part of the logs
    for name in MESH_PATHS:
        launches[name] = timed(name, phase_mesh, name)
    launches["mesh_families"] = timed("mesh_mamba2", phase_mesh_families)
    MAIN_PARAMS.clear()
    launches["mesh_specs"] = timed("mesh_specs", phase_mesh_specs)
    MESH_LOGS.clear()
    launches["compressor_bench"] = timed("compressor_bench", phase_bench)
    launches["serve_fleet"] = timed("serve_fleet", phase_serve_fleet)
    launches["serve_delta"] = timed("serve_delta", phase_serve_delta)
    launches["serve_families"] = timed("serve_families",
                                       phase_serve_families)
    timed("sanitize", phase_sanitize)
    timed("dense_free", phase_dense_free)
    timed("dryrun", phase_dryrun)
    print("[env] seconds by phase (a path's profile with it): "
          + " ".join(f"{k}={v:.1f}" for k, v in took.items()))
    print(f"[env] phases took {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # summed over the main paths, and by path
            "launches": sum(run.get(name, 0) for run in launches.values()),
            "launches_by_path": {p: run[name] for p, run in launches.items()
                                 if run.get(name)},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            # the row shuffle's: several calls and not bit-equal, so not
            # its library_ms
            **{k: t[k] for k in ("yardstick_ms", "device_us") if k in t}})
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
