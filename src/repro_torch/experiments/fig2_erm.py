"""Figure 2 reproduction: regularized ERM — Local / Centralized / ADMM / SDCA
vs the paper's BSR / BOL, across task-cluster counts C in {1, 5, 10, 50}.
The counterpart of the reference's ``benchmarks/fig2_erm.py``.

Reports per method: final population risk (exact, from the known data
distribution — tighter than the paper's 10k-sample test estimate), ERM
objective trace, and iterations to reach 1e-3 suboptimality.

    python -m repro_torch.experiments.fig2_erm [--clusters 10] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import admm, bol, bsr, centralized_solution, sdca
from repro_torch.experiments.common import (
    Timer,
    add_device_arg,
    full_f32,
    setup_problem,
    tune_local_reg,
    write_csv,
)


def iters_to_tol(trace, f_star, tol):
    """1-based index of the first iterate within ``tol`` of ``f_star``, or -1.
    ``trace`` is a tensor (any device) or an array; compared in its float32."""
    tr = trace.cpu().numpy() if hasattr(trace, "cpu") else np.asarray(trace)
    ok = np.nonzero(tr <= f_star + tol)[0]
    return int(ok[0]) + 1 if len(ok) else -1


def run(num_clusters: int, m: int, d: int, n: int, iters: int, seed=0, device=None,
        timings: dict | None = None):
    """The rows of one cluster count and f*. ``timings``, when given, gets
    each iterative method's synchronized wall seconds."""
    tasks, x, y, problem = setup_problem(num_clusters, m=m, d=d, n=n, seed=seed,
                                         device=device)
    w_cent = centralized_solution(problem, x, y)
    f_star = float(problem.erm_objective(w_cent, x, y))
    reg, local_risk = tune_local_reg(tasks, x, y)

    rows = []
    rows.append(["local", num_clusters, 0, local_risk, np.nan, 0])
    rows.append(
        ["centralized", num_clusters, 1, tasks.population_risk(w_cent), f_star, 1]
    )
    runs = {
        "bsr": lambda: bsr(problem, x, y, num_iters=iters),
        "bol": lambda: bol(problem, x, y, num_iters=iters),
        "admm": lambda: admm(problem, x, y, num_iters=iters, rho=0.05),
        "sdca": lambda: sdca(problem, x, y, num_rounds=iters),
    }
    for name, fn in runs.items():
        with Timer(x.device) as t:
            res = fn()
        if timings is not None:
            timings[name] = t.seconds
        risk = tasks.population_risk(res.w)
        it = iters_to_tol(res.objective_trace, f_star, 1e-3)
        rows.append([name, num_clusters, iters, risk,
                     float(res.objective_trace[-1]), it])
    return rows, f_star


def main(argv=None, timings: dict | None = None):
    """``timings``, when given, maps each cluster count to its methods'
    seconds (``run``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--clusters", type=int, nargs="+", default=[1, 5, 10, 50])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()

    all_rows = []
    for c in args.clusters:
        secs = None if timings is None else timings.setdefault(c, {})
        rows, f_star = run(c, args.m, args.d, args.n, args.iters, device=args.device,
                           timings=secs)
        all_rows += rows
        by = {r[0]: r for r in rows}
        print(f"\nC={c}  (f*={f_star:.5f})")
        for name, r in by.items():
            print(
                f"  {name:12s} pop_risk={r[3]:.4f} "
                f"final_obj={r[4] if r[4] == r[4] else float('nan'):.5f} "
                f"iters_to_1e-3={r[5]}"
            )
    path = write_csv(
        "fig2_erm.csv",
        ["method", "C", "iters", "pop_risk", "final_objective", "iters_to_tol"],
        all_rows,
    )
    print(f"\nwrote {path}")
    return all_rows


if __name__ == "__main__":
    main()
