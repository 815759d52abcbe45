"""Paper Figure 2 on the port: f(x^t) - f* against bits sent per node,
EF-BV against EF21, comp-(k, d/2), overlap xi in {1, 2}, k in {1, 2}, n =
1000 (``benchmarks/paper_fig2.py``'s rows: the fast setting, 2 datasets x
1500 rounds at k = 1, xi = 1; ``--full``, 4 datasets x 12000 rounds at
k in {1, 2}, xi in {1, 2}).

Bits per node per round = 32 * 2k (k values and k indices), so the x-axis
is t * k as in the paper.  The headline: EF-BV (nu = nu*) reaches a
target suboptimality in fewer bits than EF21 (nu = lam)."""

from __future__ import annotations

from typing import Optional, Sequence

from paper_torch.common import emit, make_problem, parse_args, run_algorithm


def run(fast: bool = True, n: int = 1000, device="cuda"):
    """(rows, curves): the CSV rows and every (steps,) trajectory by
    (dataset, k, xi, mode)."""
    steps = 1500 if fast else 12000
    datasets = ["mushrooms", "phishing"] if fast else [
        "mushrooms", "phishing", "a9a", "w8a"]
    rows = []
    curves = {}
    for name in datasets:
        for k in ([1] if fast else [1, 2]):
            for xi in ([1] if fast else [1, 2]):
                prob = make_problem(name, n=n, overlap=xi, device=device)
                _, fstar = prob.solve()
                for mode in ["efbv", "ef21"]:
                    curves[(name, k, xi, mode)] = run_algorithm(
                        prob, mode, k, steps, fstar, device).cpu().numpy()
                f_bv = curves[(name, k, xi, "efbv")][-1]
                f_21 = curves[(name, k, xi, "ef21")][-1]
                rows.append({
                    "name": f"fig2/{name}/k{k}/xi{xi}/final_gap_ratio",
                    "us_per_call": "",
                    "derived": f"efbv={f_bv:.3e};ef21={f_21:.3e};"
                               f"efbv_better={bool(f_bv < f_21)}",
                })
    return rows, curves


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv, __doc__)
    rows, _ = run(fast=not args.full, device=args.device)
    emit(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
