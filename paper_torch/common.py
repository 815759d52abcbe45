"""The paper's experimental setup (Appendix C) on the port: synthetic
stand-ins of its LibSVM datasets, the problem of each, one EF-BV / EF21 /
DIANA run through the port's reference backend, and the CSV rows
(``benchmarks/common.py``'s, importing none of it).

Each dataset's data come from a fixed key,
``fold_in(key(0), zlib.crc32(name) % 2**31)``.  The JAX module keys them by
``hash(name) % 2**31``, which Python salts per process, so its data change
from run to run; a CRC of the name does not.  With the same key the port
draws JAX's data (``make_synthetic``: its uniforms and normals bit for bit,
A up to ``exp`` and the matmul behind the labels, see
``repro_torch.data.synthetic``).
"""

from __future__ import annotations

import argparse
import zlib
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import random, resolve_device
from repro_torch.core import CompKK, EFBV, run_reference, tune_for
from repro_torch.data.synthetic import LogReg, make_synthetic

KEY = random.key(0)

# synthetic stand-ins for the paper's LibSVM datasets (same d; N scaled down
# as in the JAX package; the theory constants of Table 3 depend only on d,
# k, k' and n)
DATASETS = {
    "mushrooms": dict(N=2000, d=112),
    "phishing": dict(N=2000, d=68),
    "a9a": dict(N=2400, d=123),
    "w8a": dict(N=2400, d=300),
}


def dataset_key(name: str):
    """The fixed data key of a dataset (module docstring)."""
    return random.fold_in(KEY, zlib.crc32(name.encode()) % 2**31)


def make_problem(name: str, n: int, overlap: int = 1, mu: float = 0.1,
                 lam_nc: float = 0.0, device="cuda") -> LogReg:
    """The dataset's logistic regression split over n workers (shuffled
    under ``key(1)``), on ``device``."""
    spec = DATASETS[name]
    A, b = make_synthetic(dataset_key(name), N=spec["N"], d=spec["d"],
                          device=resolve_device(device))
    return LogReg.split(A, b, n=n, mu_reg=mu, overlap=overlap,
                        key=random.key(1), lam_nc=lam_nc)


def run_algorithm(prob: LogReg, mode: str, k: int, steps: int,
                  fstar: float, device="cuda") -> torch.Tensor:
    """One EF-BV / EF21 / DIANA run with the paper's parametrization (Table
    3: comp-(k, d/2), Remark 1's tuning from the problem's L and Ltilde),
    on ``device`` (the problem is moved there if it lives elsewhere);
    returns the (steps,) f(x^t) - f* trajectory."""
    dev = resolve_device(device)
    if prob.A.device != dev:
        prob = LogReg(prob.A.to(dev), prob.b.to(dev), prob.mu_reg,
                      prob.lam_nc)
    d = prob.d
    comp = CompKK(k, d // 2)
    t = tune_for(comp, d, prob.n, mode=mode, L=prob.L(),
                 Ltilde=prob.L_tilde())
    algo = EFBV(comp, lam=t.lam, nu=t.nu)
    res = run_reference(algo=algo, grad_fn=lambda _k, x: prob.grads(x),
                        x0=torch.zeros(d, device=dev), gamma=t.gamma,
                        steps=steps, key=KEY, n=prob.n,
                        record=lambda x: prob.f(x) - fstar)
    return res.metrics


def emit(rows: List[Dict]) -> None:
    for r in rows:
        print(f"{r['name']},{r.get('us_per_call', '')},"
              f"{r.get('derived', '')}")


def parse_args(argv: Optional[Sequence[str]], doc: str):
    """``--full`` (the paper's setting; the default is the fast one) and
    ``--device`` (default cuda)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="the full setting instead of the fast one")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)
