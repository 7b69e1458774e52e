"""Table 1 reproduction: communication/sample/computation accounting — the
theoretical rows (from repro_torch.core.theory) side by side with MEASURED
communication rounds to reach epsilon suboptimality on the Appendix-I data.
The counterpart of the reference's ``benchmarks/table1_complexity.py``.

    python -m repro_torch.experiments.table1_complexity [--iters 400] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core import bol, bsr, centralized_solution, theory
from repro_torch.experiments.common import add_device_arg, full_f32, setup_problem, write_csv
from repro_torch.experiments.fig2_erm import iters_to_tol


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--iters", type=int, default=400)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()

    tasks, x, y, problem = setup_problem(10, m=args.m, d=args.d, n=args.n,
                                         device=args.device)
    B, S = tasks.bs_constants()
    rows_theory = theory.table1(tasks.graph, B, max(S, 1e-2), 8.0, 0.05)

    w_cent = centralized_solution(problem, x, y)
    f_star = float(problem.erm_objective(w_cent, x, y))

    def measure(res):
        return iters_to_tol(res.objective_trace, f_star, args.eps)

    meas = {
        "erm_bsr": measure(bsr(problem, x, y, num_iters=args.iters)),
        "erm_bol": measure(bol(problem, x, y, num_iters=args.iters)),
    }
    m = tasks.graph.m
    e_over_m = tasks.graph.num_edges / m

    print(f"{'method':14s} {'theory rounds':>14s} {'measured':>9s} "
          f"{'vecs/round':>11s} {'samples':>10s}")
    out = []
    for r in rows_theory:
        measured = meas.get(r.method, "")
        vecs = (
            r.vectors_per_machine / r.comm_rounds if r.comm_rounds else 0.0
        )
        print(f"{r.method:14s} {r.comm_rounds:14.1f} {str(measured):>9s} "
              f"{vecs:11.1f} {r.samples_per_machine:10.1f}")
        out.append([r.method, r.comm_rounds, measured, vecs,
                    r.samples_per_machine, r.samples_processed_per_machine])
    print(f"\n(BSR moves m={m} vectors/machine/round; "
          f"BOL moves |E|/m={e_over_m:.1f} — the graph-local discount)")
    path = write_csv(
        "table1_complexity.csv",
        ["method", "theory_rounds", "measured_rounds", "vectors_per_round",
         "samples", "samples_processed"],
        out,
    )
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
