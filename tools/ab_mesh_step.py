#!/usr/bin/env python3
"""Time the 2x2 mesh paths of one or more source trees on one card.

    python3 tools/ab_mesh_step.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example a ``git archive``
of another commit unpacked under ``build/``).  For each ROOT in turn, four
gloo ranks on cuda:0 (torchrun) run that tree's ``chip_smoke.py`` mesh
paths ``mesh`` and ``mesh_fsdp`` (qwen2-0.5b at full width cut to 4
layers, block_topk:256,16 up, qsgd:16 down) for ``STEPS`` steps, through
the tree's own ``mesh_path_child``.  Prints one line a tree and path,
``[ab] ROOT PATH {json}``: every rank's step_ms and the model axis's
collectives (calls, bytes sent, host ms) a step, and under fsdp its two
gather stages'.  Name two trees in turns (A B B A) to compare them on one
card; the first step of each path holds its warm-up.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

PATHS = ("mesh", "mesh_fsdp")
STEPS = 6
FIELDS = ("step_ms", "model_calls", "model_bytes", "model_ms", "fsdp_calls",
          "fsdp_bytes", "fsdp_ms", "fsdp_model_calls", "fsdp_model_bytes",
          "fsdp_model_ms")


def child(root, outdir):
    """One rank: ROOT's chip_smoke, its mesh launch cut to PATHS at STEPS
    steps, run by its own ``dist_child``."""
    sys.path.insert(0, root)
    import chip_smoke

    for name in PATHS:
        argv = chip_smoke.MESH_PATHS[name]["argv"]
        argv[argv.index("--steps") + 1] = str(STEPS)
    chip_smoke.MESH_LAUNCHES["ab"] = {"ranks": 4, "paths": PATHS}
    sys.argv = [sys.argv[0], "--dist-child", "ab", outdir]
    return chip_smoke.dist_child()


def run(root):
    """ROOT's four ranks; each path's records by rank."""
    outdir = Path(root, "build", "dist", "ab").resolve()
    shutil.rmtree(outdir, ignore_errors=True)
    shutil.rmtree(Path(root, "build", "ckpt"), ignore_errors=True)
    outdir.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node=4", __file__, "--child", root, str(outdir)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    logs = [(outdir / f"rank{r}.log").read_text() for r in range(4)]
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], logs[0][-3000:])
        raise SystemExit(f"[ab] {root}: torchrun exit {proc.returncode}")
    out = {}
    for name in PATHS:
        out[name] = []
        for log in logs:
            part = log.split(f"[dist] begin {name}\n")[1]
            recs = json.loads(re.search(r"\[dist\] records (.*)", part)[1])
            out[name].append({k: [a[k] for a in recs] for k in FIELDS
                              if k in recs[0]})
    return out


def main():
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2], sys.argv[3])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[ab] {smi}")
    for root in sys.argv[1:]:
        for name, ranks in run(os.path.abspath(root)).items():
            print(f"[ab] {root} {name} {json.dumps(ranks)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
