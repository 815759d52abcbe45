#!/usr/bin/env python3
"""Time the reference round's worker sum and the threefry draws of one
source tree on the card.

    python3 tools/ab_reference_kernels.py ROOT

ROOT is a checkout of this repository (for example a ``git archive`` of
another commit unpacked under ``build/``); its kernels build into
``ROOT/build/kernels``.  Prints one line, ``[ab] ROOT {json}``:

* ``worker_sum``: at (1000, 112), the reference round's call (plain order
  of XLA's windows, the master update fused), the median of 20 CUDA-event
  timings of one wrapper call, its kernel's device time (torch.profiler,
  the mean over 50 calls) and ``torch.sum(dim=0)``'s median; at (16,
  2**20) and (1000, 2**20) the wrapper's median, plain and fused (with the
  scale 56 contracted at 16 workers, as the round calls it);
* ``threefry_fill``: one worker's round of uniforms over the 14 full-width
  qwen2-0.5b leaves (the sum of each leaf's median of 20), ``torch.rand``
  over the same sizes, the round's device time (torch.profiler), and the
  SASS of the draw's loop per value: all instructions, those of the
  integer pipe, the IMADs, and by opcode;
* ``threefry_rows``: the (1000, 56) word draw's median and ``torch.rand``'s;
* ``host_us``: the host microseconds of one call (2000 back to back, then
  a synchronize) of each wrapper, of its PyTorch counterpart and of their
  parts (an allocation, the stream, the C entry points alone);
* ``reference_round``: a round of the reference backend, ms between
  synchronisations (``chip_smoke.reference_case``) of the committed logreg
  spec at n = 16 and of Figure 2's EF-BV at n = 1000, and the latter's
  kernel launches and host-to-device copies a round under the profiler
  (``chip_smoke.profile_reference_round``), with the tree's own code.

Run two trees in turns in one call (A, B, B, A) to compare them on one
card.
"""

import json
import statistics
import sys
import time
from pathlib import Path

root = sys.argv[1]
sys.path.insert(0, root + "/src")

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import random  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, threefry  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

# after the tree's own package: chip_smoke's SASS readers
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

dev = torch.device("cuda")


def median_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def sass(path, kernel):
    total, ints, hist, imads = chip_smoke.sass_per_value(path, kernel)
    return {"total": round(total, 3), "int_pipe": round(ints, 3),
            "imad": round(imads, 3),
            "opcodes": {o: round(c, 3) for o, c in sorted(
                hist.items(), key=lambda x: -x[1])}}


out = {"device": torch.cuda.get_device_name(0)}
gen = torch.Generator(device=dev).manual_seed(0)
d = torch.randn(1000, 112, generator=gen, device=dev)
h = torch.randn(112, generator=gen, device=dev)
main = (lambda: ops.worker_sum(d, None, h, 0.25, 0.5))
out["worker_sum_1000x112"] = {
    "wrapper_ms": median_ms(main),
    "device_us": chip_smoke.device_us(main, "worker_sum"),
    "torch_sum_ms": median_ms(lambda: torch.sum(d, dim=0))}
for n in (16, 1000):
    d = torch.randn(n, 2**20, generator=gen, device=dev)
    h = torch.randn(2**20, generator=gen, device=dev)
    w = 56.0 if n <= 32 else None
    out[f"worker_sum_{n}x2**20"] = {
        "plain_ms": median_ms(lambda: ops.worker_sum(d)),
        "fused_ms": median_ms(lambda: ops.worker_sum(d, w, h, 0.25, 0.5))}
    del d, h
    torch.cuda.empty_cache()

sizes = [leaf.numel() for leaf in T.leaves(
    build_model(get_config("qwen2-0.5b")).init_abstract())]
key = random.fold_in(random.fold_in(random.key(0), 1), 13)


def round_ms(fill):
    return sum(median_ms(lambda: fill(n)) for n in sizes)


out["threefry_fill"] = {
    "round_ms": round_ms(lambda n: threefry.threefry_fill(key, n, dev,
                                                          True)),
    "torch_rand_ms": round_ms(lambda n: torch.rand(n, device=dev)),
    "sass": sass("threefry", "threefry_fill_kernel")}
kt = random.key_tensor(random.split(random.key(1000), 1000), dev)
out["threefry_rows_1000x56"] = {
    "ms": median_ms(lambda: threefry.threefry_rows(kt, 56, False)),
    "torch_rand_ms": median_ms(lambda: torch.rand(1000, 56, device=dev))}


def round_device_ms(fill, rounds=3, name="threefry"):
    """Device time of one round's kernels whose name holds ``name``
    (torch.profiler)."""
    fill(sizes[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for n in sizes:
                fill(n)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.key) / rounds / 1e3


def host_us(fn, calls=2000):
    """Wall microseconds a call over ``calls`` back-to-back calls, then one
    synchronize: the host time of a call whose device work is shorter."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


# the host path of the two wrappers, and of its parts
d = torch.randn(1000, 112, generator=gen, device=dev)
h = torch.randn(112, generator=gen, device=dev)
small = torch.empty(896, device=dev)
ws = build.load("worker_sum").worker_sum_f32
tf = build.load("threefry").threefry_fill
out["host_us"] = {
    "worker_sum_1000x112_fused": host_us(
        lambda: ops.worker_sum(d, None, h, 0.25, 0.5)),
    "torch_sum_1000x112": host_us(lambda: torch.sum(d, dim=0)),
    "threefry_fill_896": host_us(
        lambda: threefry.threefry_fill(key, 896, dev, True)),
    "torch_rand_896": host_us(lambda: torch.rand(896, device=dev)),
    "torch_empty_896": host_us(lambda: torch.empty(896, device=dev)),
    "current_stream": host_us(
        lambda: torch.cuda.current_stream(dev).cuda_stream),
    "raw_stream": host_us(
        lambda: torch._C._cuda_getCurrentRawStream(small.device.index)),
    "threefry_c_call_n0": host_us(
        lambda: tf(1, 2, small.data_ptr(), 0, 1, 0)),
    "threefry_c_call_896": host_us(
        lambda: tf(1, 2, small.data_ptr(), 896, 1, 0)),
    "worker_sum_c_call_cols0": host_us(
        lambda: ws(d.data_ptr(), None, 0.0, 0, 32, None, small.data_ptr(),
                   None, 1000, 0, 0.0, 0.0, *([1, 4, 128, 28, 512]
                   if len(ws.argtypes) > 13 else []), 0))}
out["threefry_fill"]["round_device_ms"] = round_device_ms(
    lambda n: threefry.threefry_fill(key, n, dev, True))
out["threefry_fill"]["torch_rand_device_ms"] = round_device_ms(
    lambda n: torch.rand(n, device=dev), name="")


def reference_round():
    from repro_torch.core import ExperimentSpec
    from repro_torch.core import build as build_run
    from repro_torch.data.synthetic import LogReg, make_synthetic

    fig2 = chip_smoke.FIG2
    run16 = build_run(ExperimentSpec.from_json(
        chip_smoke.REFERENCE_SPEC.read_text()))
    chip_smoke.reference_case(run16, "cuda")
    ms16 = [chip_smoke.reference_case(run16, "cuda")[1] for _ in range(3)]
    A, b = make_synthetic(random.key(fig2["seed"]),
                          N=chip_smoke.FIG2_ROWS * fig2["n"], d=fig2["d"],
                          device="cuda")
    prob = LogReg.split(A, b, n=fig2["n"], mu_reg=0.1)
    frun = build_run(ExperimentSpec(mode="efbv", **fig2))
    _, _, _, f_star = chip_smoke.reference_case(frun, "cuda", prob=prob)
    ms1000 = [chip_smoke.reference_case(frun, "cuda", prob=prob)[1]
              for _ in range(3)]
    gamma = frun._tune(L=prob.L(), Ltilde=prob.L_tilde()).gamma
    launches, copies = chip_smoke.profile_reference_round(frun, prob, gamma,
                                                          f_star)
    return {"ms_n16": ms16, "ms_n1000": ms1000,
            "launches_a_round": launches, "copies_a_round": copies}


out["reference_round"] = reference_round()
print(f"[ab] {root} {json.dumps(out)}", flush=True)

