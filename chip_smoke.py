#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final ``{"ok": true, ...}``
line is printed only when every phase passed):

1. build   -- compile every CUDA source of the port with nvcc (sm_90a).
2. kernels -- each kernel against its plain PyTorch version on the card,
              bitwise, at the main path's shapes and edge cases; times each
              (CUDA events, median of 20) beside its plain version and its
              memory/compute bound.
3. reference -- a small input (the qwen2 smoke config, f32 activations):
              three 2-worker EF-BV steps on the GPU (kernel path) against
              the same steps on the CPU (plain path) from the same params.
4. main path -- ``repro_torch.launch.train.main`` at the full width and
              depth of qwen2-0.5b: 2 workers, 3 steps, block-top-k
              (256, 16) over the sparse all-gather wire.  Checks a finite
              loss at every step, the exact printed wire bits, and that
              every kernel of the path launched (launch counts are reset
              just before this phase and read just after).
5. profile -- the same configuration, one step on the host clock and one
              under torch.profiler: device time by kernel, busy share.

The last lines are a JSON object per kernel (times, bound, launches), the
card's name and power limit, and the result line.  Needs one CUDA GPU and
the CUDA toolkit; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
FULL_BITS = 1_976_131_584        # qwen2-0.5b, block_topk:256,16, per worker
FULL_LEAVES, WORKERS, STEPS = 14, 2, 3
REPS = 20


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
    payload (bytes); or kb selection passes over each row (f32 ops)."""
    nb = -(-size // block)
    nbytes = 3 * 4 * size + 2 * 4 * nb * kb
    ops = nb * block * (3 + kb)
    return max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S) * 1e3, \
        ("bytes" if nbytes / H100_BYTES_PER_S >= ops / H100_F32_OPS_PER_S
         else "operations")


def same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.compile_sources(["pack_update"])
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"[build] {name}.cu:\n{log.strip()}")
    print(f"[build] seconds={secs:.2f} built={sorted(logs)}")
    build.load("pack_update")


def pack_case(name, g, h, block, kb, lam=0.37, timing=True):
    """Kernel vs plain version on (g, h) flat f32 CUDA tensors; returns
    (kernel ms, plain ms, bound ms, max |diff|)."""
    from repro_torch.kernels import ops, pack, ref

    def rows(x):
        return ops.to_rows(x, block)

    g2, h2 = rows(g), rows(h)
    kv, ki, kh = pack.pack_update(g2, h2, lam, kb)
    pv, pi, ph = ref.pack_update_ref(g2, h2, lam, kb)
    torch.cuda.synchronize()
    err = max(float((kv - pv).abs().max()), float((kh - ph).abs().max()))
    ok = same_bits(kv, pv) and same_bits(ki, pi) and same_bits(kh, ph)
    if not ok:
        raise AssertionError(f"[kernels] {name}: kernel != plain version "
                             f"(max |diff| {err})")
    bound, by = pack_bound_ms(g.numel(), block, kb)
    k_ms = p_ms = float("nan")
    if timing:
        k_ms = timed_ms(lambda: pack.pack_update(g2, h2, lam, kb))
        p_ms = timed_ms(lambda: ref.pack_update_ref(g2, h2, lam, kb))
    print(f"[kernels] {name}: size={g.numel()} block={block} kb={kb} "
          f"bitwise=ok kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"bound_ms={bound:.4f} ({by})")
    return k_ms, p_ms, bound, err


def phase_kernels():
    """Edge cases bitwise; then one worker's full round of main-path leaf
    shapes, timed."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch import tree as T

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(n):
        return torch.randn(n, generator=gen, device="cuda")

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
    # ties: integers in [-3, 3]; every 7th row of delta all zero; some -0.0
    n = 256 * 4096
    gi = torch.randint(-3, 4, (n,), generator=gen, device="cuda").float()
    hi = torch.randint(-3, 4, (n,), generator=gen, device="cuda").float()
    rows = gi.view(-1, 256)
    rows[::7] = hi.view(-1, 256)[::7]
    zero_h = hi == 0
    gi[zero_h & (torch.arange(n, device="cuda") % 5 == 0)] = -0.0
    max_err = max(max_err, pack_case("ties_int", gi, hi, 256, 16)[3])
    # NaN in a row's delta (a diverged gradient): that row selects nothing
    # and sends (0.0, 0) in every slot, as the Pallas kernel does.  Row 0 is
    # all NaN, row 3 has one NaN, and every 5th row from row 10 one more.
    n = 256 * 64
    gn, hn = randn(n), randn(n)
    gn[:256] = float("nan")
    gn[3 * 256 + 100] = float("nan")
    gn[10 * 256 + 7::5 * 256 + 1] = float("nan")
    max_err = max(max_err, pack_case("nan_rows", gn, hn, 256, 16)[3])

    # a block the kernel is not built for raises on the card: no fallback
    from repro_torch.distributed import wire
    for block in (100, 384):
        lw = wire.LeafWire(shape=(768,), size=768, block=block, kb=4)
        try:
            wire.fused_pack(lw, randn(768), randn(768), 0.37)
        except ValueError as e:
            print(f"[kernels] block={block} raises on the card: {e}")
        else:
            raise AssertionError(f"[kernels] block={block} ran on the card")

    # one worker's round at the full-width qwen2-0.5b leaf shapes
    abstract = build_model(get_config("qwen2-0.5b")).init_abstract()
    k_tot = p_tot = b_tot = 0.0
    for path, leaf in T.flatten_with_path(abstract):
        size = leaf.numel()
        k_ms, p_ms, b_ms, err = pack_case(
            "qwen2:" + "/".join(path), randn(size), randn(size), 256, 16)
        k_tot, p_tot, b_tot = k_tot + k_ms, p_tot + p_ms, b_tot + b_ms
        by = pack_bound_ms(size, 256, 16)[1]
        max_err = max(max_err, err)
        torch.cuda.empty_cache()
    print(f"[kernels] qwen2-0.5b round (14 leaves, one worker): "
          f"kernel_ms={k_tot:.4f} plain_ms={p_tot:.4f} bound_ms={b_tot:.4f}")
    return {"ms": k_tot, "plain_ms": p_tot, "bound_ms": b_tot,
            "bound_by": by, "max_abs_err": max_err}


def run_steps(params, cfg, steps=3, n=2):
    from repro_torch.core.compressors import BlockTopK
    from repro_torch.core.efbv import EFBV
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine
    from repro_torch.train.trainer import init_train_state, make_train_step

    model = build_model(cfg)
    opt = adamw(cosine(3e-4, total_steps=steps, warmup_steps=1),
                weight_decay=0.01)
    algo = EFBV.make(BlockTopK(256, 16), d=cfg.d_model * cfg.d_ff, n=n)
    state = init_train_state(params, opt, n_workers=n)
    step_fn = make_train_step(model.loss, opt, algo, n_workers=n,
                              agg_mode="sparse_allgather")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8,
                       n_workers=n, seed=0)
    losses = []
    for s in range(steps):
        state, m = step_fn(state, data.batch(s))
        losses.append(float(m["loss"]))
    return losses


def phase_reference():
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch import tree as T

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              activation_dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    cpu = run_steps(params, cfg)
    gpu = run_steps(T.tree_map(lambda p: p.cuda(), params), cfg)
    print(f"[reference] smoke f32 losses cpu={cpu} gpu={gpu}")
    for a, b in zip(cpu, gpu):
        # f32 matmuls sum in another order on the card; the block-top-k
        # selection can then differ on near-ties, so 1e-3 relative
        if not (math.isfinite(b) and abs(a - b) <= 1e-3 * abs(a)):
            raise AssertionError(f"[reference] GPU loss {b} vs CPU {a}")


MAIN_ARGV = ["--arch", "qwen2-0.5b", "--workers", str(WORKERS),
             "--steps", str(STEPS), "--global-batch", "8", "--seq", "128",
             "--compressor", "block_topk:256,16", "--algo", "efbv",
             "--agg", "sparse_allgather", "--log-every", "1"]


def phase_main():
    from repro_torch.kernels import pack
    from repro_torch.launch import train

    argv = MAIN_ARGV
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pack.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            train.main(argv)
        torch.cuda.synchronize()
    finally:
        print(out.getvalue().rstrip())
    secs = time.perf_counter() - t0
    launches = dict(pack.LAUNCHES)
    text = out.getvalue()
    losses = [float(x) for x in re.findall(r"step\s+\d+ loss=(\S+)", text)]
    bits = [int(x) for x in re.findall(r"(\d+) bits/round/worker", text)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] seconds={secs:.2f} peak_mem_gib={peak:.2f} "
          f"losses={losses} bits={bits} launches={launches}")
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[main] expected {STEPS} finite losses")
    # random init with small embeddings: the first loss is close to ln(V)
    if abs(losses[0] - math.log(151936)) > 1.0:
        raise AssertionError(f"[main] first loss {losses[0]} far from ln V")
    if bits != [FULL_BITS]:
        raise AssertionError(f"[main] printed bits {bits} != {FULL_BITS}")
    want = FULL_LEAVES * WORKERS * STEPS
    if launches["pack_update"] != want:
        raise AssertionError(f"[main] pack_update launched "
                             f"{launches['pack_update']} times, want {want}")
    return launches


def phase_profile():
    """Where a full-width step's time goes: after a warm-up step, one step
    timed on the host clock and one traced with torch.profiler (device
    time by kernel, and the device's busy share of the traced step).  A
    trace whose rows cannot be read is reported, not failed; a failure of
    the steps themselves fails the phase."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    with contextlib.redirect_stdout(io.StringIO()):
        state, step_fn, data = train.setup(train.parse_args(MAIN_ARGV))
    state, m = step_fn(state, data.batch(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step_fn(state, data.batch(1))
    loss = float(m["loss"])
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(loss):
        raise AssertionError(f"[profile] untraced step loss {loss}")
    print(f"[profile] untraced step wall_ms={untraced:.2f}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, data.batch(2))
        loss = float(m["loss"])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(loss):
        raise AssertionError(f"[profile] traced step loss {loss}")
    try:
        # device kernels only: CPU ops also carry the device time of the
        # kernels they launched, which would count every kernel twice
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    except Exception as e:  # reading the trace, not the port: report it
        print(f"[profile] not measured: {e!r}")
        return
    busy = sum(r[0] for r in rows)
    print(f"[profile] traced step wall_ms={wall:.2f} (profiler overhead "
          f"included) device_kernel_ms={busy:.2f}; busy share of the "
          f"untraced step {busy / untraced:.3f}")
    pack_ms = sum(r[0] for r in rows if "pack_update" in r[2])
    print(f"[profile] pack_update device_ms={pack_ms:.3f}")
    for t, count, key in sorted(rows, reverse=True)[:15]:
        print(f"[profile] {t:9.3f} ms x{count:<5d} {key[:100]}")


def main():
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

    phase_build()
    timing = phase_kernels()
    torch.cuda.empty_cache()
    phase_reference()
    launches = phase_main()
    torch.cuda.empty_cache()
    phase_profile()
    kernels = [{
        "name": "pack_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pack_update.cu",
        "replaces": "src/repro/kernels/pack.py:78",
        "launches": launches["pack_update"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
    }]
    print(f"[kernels] launches on the main path: {launches}")
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
