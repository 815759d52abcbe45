"""Paper Figure 3 / Appendix C.3 on the port: nonconvex logistic regression
with the regularizer lam * sum_j x_j^2 / (1 + x_j^2), EF-BV against EF21
under Theorem 3's stepsizes, n = 200 (``benchmarks/paper_fig3.py``'s rows:
the fast setting, mushrooms, 1200 rounds; ``--full``, 4 datasets x 8000).
Metric: the least squared gradient norm reached (Theorem 3 bounds
E||grad f||^2)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from paper_torch.common import KEY, emit, make_problem, parse_args
from repro_torch import resolve_device
from repro_torch.core import CompKK, EFBV, run_reference, tune_for


def run_bench(fast: bool = True, n: int = 200, device="cuda"):
    """(rows, curves): the CSV rows and every (steps,) trajectory of
    ||grad f(x^t)||^2 by (dataset, mode)."""
    dev = resolve_device(device)
    steps = 1200 if fast else 8000
    rows = []
    curves = {}
    for name in (["mushrooms"] if fast else
                 ["mushrooms", "phishing", "a9a", "w8a"]):
        prob = make_problem(name, n=n, mu=0.0, lam_nc=0.1, device=dev)
        d = prob.d
        comp = CompKK(1, d // 2)
        res = {}
        for mode in ["efbv", "ef21"]:
            t = tune_for(comp, d, prob.n, mode=mode, regime="nonconvex",
                         L=prob.L(), Ltilde=prob.L_tilde())
            algo = EFBV(comp, lam=t.lam, nu=t.nu)
            m = run_reference(algo=algo, grad_fn=lambda _k, x: prob.grads(x),
                              x0=torch.zeros(d, device=dev), gamma=t.gamma,
                              steps=steps, key=KEY, n=prob.n,
                              record=lambda x: torch.sum(prob.grad(x) ** 2)
                              ).metrics
            curves[(name, mode)] = m.cpu().numpy()
            res[mode] = float(np.min(curves[(name, mode)]))
        rows.append({
            "name": f"fig3/{name}/min_grad_norm2",
            "us_per_call": "",
            "derived": f"efbv={res['efbv']:.3e};ef21={res['ef21']:.3e};"
                       f"efbv_better={bool(res['efbv'] <= res['ef21'] * 1.05)}",
        })
    return rows, curves


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv, __doc__)
    rows, _ = run_bench(fast=not args.full, device=args.device)
    emit(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
