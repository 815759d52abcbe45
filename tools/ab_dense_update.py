#!/usr/bin/env python3
"""Time the port's dense block-top-k kernels of one source tree on the card.

    python3 tools/ab_dense_update.py ROOT

ROOT is a checkout of this repository (for example a ``git archive`` of
another commit unpacked under ``build/``); its kernels build into
``ROOT/build/kernels``.  Prints one line: the median of 20 CUDA-event
timings of one worker's round over the 14 full-width qwen2-0.5b leaves
(f32, block 256, kb 16) of ``ops.efbv_update`` and of ``ops.block_topk``,
after 3 warm-up rounds.  Run two trees in turns in one call (A, B, B, A)
to compare them on one card.
"""

import statistics
import sys

root = sys.argv[1]
sys.path.insert(0, root + "/src")

import torch  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

shapes = [tuple(leaf.shape) for leaf in T.leaves(
    build_model(get_config("qwen2-0.5b")).init_abstract())]
gen = torch.Generator(device="cuda").manual_seed(0)
gs = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
hs = [torch.randn(s, generator=gen, device="cuda") for s in shapes]


def median_ms(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


upd = median_ms(lambda: [ops.efbv_update(g, h, 0.37, block=256, kb=16)
                         for g, h in zip(gs, hs)])
topk = median_ms(lambda: [ops.block_topk(g, block=256, kb=16) for g in gs])
print(f"[ab] {root}: efbv_update_ms={upd:.4f} block_topk_ms={topk:.4f}",
      flush=True)
