"""Paper Table 3 on the port: the derived parameter values (eta, omega,
omega_av, lam, nu, r, r_av, sqrt(r_av/r), s*) for comp-(k, d/2), n = 1000,
on each dataset's dimensionality (``benchmarks/paper_tab3.py``'s rows).
They depend only on (d, k, k', n), so the rows equal the JAX script's
string for string; no device is used."""

from __future__ import annotations

from typing import Optional, Sequence

from paper_torch.common import DATASETS, emit, parse_args
from repro_torch.core import CompKK, tune_for

# the paper's printed values for (dataset, k): eta, omega, lam, sqrt(r_av/r)
PAPER = {
    ("mushrooms", 1): (0.707, 55.0, 5.32e-3, 0.746),
    ("phishing", 1): (0.707, 33.0, 8.85e-3, 0.731),
    ("a9a", 1): (0.710, 60.0, 4.83e-3, 0.752),
    ("w8a", 1): (0.707, 149.0, 1.96e-3, 0.806),
    ("mushrooms", 2): (0.707, 27.0, 1.08e-2, 0.727),
}


def run(fast: bool = True, n: int = 1000):
    rows = []
    for (name, k), (eta_p, om_p, lam_p, ratio_p) in PAPER.items():
        d = DATASETS[name]["d"]
        comp = CompKK(k, d // 2)
        t = tune_for(comp, d, n, mode="efbv")
        ok = (abs(t.eta - eta_p) < 5e-3 and abs(t.omega - om_p) < 0.51
              and abs(t.lam - lam_p) / lam_p < 0.02
              and abs(t.speedup_vs_ef21 - ratio_p) < 0.01)
        rows.append({
            "name": f"tab3/{name}/k{k}",
            "us_per_call": "",
            "derived": f"eta={t.eta:.3f};omega={t.omega:.1f};"
                       f"omega_av={t.omega_av:.3f};lam={t.lam:.3e};"
                       f"nu={t.nu:.3f};"
                       f"r={t.r:.4f};r_av={t.r_av:.3f};"
                       f"sqrt_rav_r={t.speedup_vs_ef21:.3f};s={t.s:.3e};"
                       f"matches_paper={ok}",
        })
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv, __doc__)
    emit(run(fast=not args.full))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
