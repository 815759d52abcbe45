"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source (with the shared ``csrc/*.cuh`` headers)
compiles with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes).  Libraries are built at first use into
``build/kernels/`` at the repository root, named by a hash of the source,
the headers and the flags, so an edited source or header rebuilds and an
unchanged one loads the existing library.

Nothing here runs at import time: this module is imported on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

# argtypes of each library's C entry points: every pointer and the stream as
# c_void_p (a plain int would cut a 64-bit pointer to 32 bits)
_P = ctypes.c_void_p
_TOPK = [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
_UPDATE = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
           ctypes.c_float, ctypes.c_int, _P]
SIGNATURES = {
    "pack_update": {"pack_update_f32":
                    [_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
                    "pack_update_scratch_bytes":
                    [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]},
    "qsgd_pack_update": {"qsgd_pack_update_f32":
                         [_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_int, _P]},
    "randk_update": {"randk_update_f32":
                     [_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_float, _P]},
    "threefry": {"threefry_fill":
                 [ctypes.c_uint, ctypes.c_uint, _P, ctypes.c_longlong,
                  ctypes.c_int, _P],
                 "threefry_rows":
                 [_P, ctypes.c_longlong, ctypes.c_longlong, _P, ctypes.c_int,
                  _P]},
    "worker_sum": {"worker_sum_f32":
                   [_P, _P, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    _P, _P, _P,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
                    ctypes.c_float, _P]},
    "block_topk": {"block_topk_f32": _TOPK, "block_topk_bf16": _TOPK,
                   "efbv_update_f32": _UPDATE, "efbv_update_bf16": _UPDATE},
}
#: entry points that return something other than a cudaError_t (int)
RESTYPES = {"pack_update_scratch_bytes": ctypes.c_longlong}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    # the shared headers are part of every source: an edited header rebuilds
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def compile_sources(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source not yet built, one ``nvcc`` each, all
    started together.  Returns ``{name: compiler output}`` for the sources
    this call compiled (ptxas reports registers, shared memory and
    spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    nvcc = None
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    # wait for every nvcc before raising: none is left running
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"{name}.cu:\n{logs[name]}" for name in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its entry points'
    argtypes set (builds it first if needed)."""
    compile_sources([name])
    lib = ctypes.CDLL(str(lib_path(name)))
    for sym, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(sym, ctypes.c_int)
    return lib
