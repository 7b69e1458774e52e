"""Appendix G / Theorem 7: delay-tolerant BOL. Measures the linear
convergence rate under bounded staleness Gamma and compares with the
theoretical contraction (1 - eta/(eta+tau))^(1/(1+Gamma)). The counterpart
of the reference's ``benchmarks/delay_bench.py``, quirk included: a row
with Gamma = 0 runs ``bol_delayed(max_delay=1, fixed_delay=False)``, i.e.
delays drawn at random from {0, 1}, and is still compared with
``theorem7_rate(eta, tau, 0)``.

    python -m repro_torch.experiments.delay_bench [--gammas 0 2 5 10] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    SQUARED,
    MultiTaskProblem,
    bol_delayed,
    centralized_solution,
    ring_graph,
    theorem7_rate,
)
from repro_torch.data.synthetic import generate_clustered_tasks
from repro_torch.experiments.common import add_device_arg, full_f32, write_csv
from repro_torch.kernels.runtime import require_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=24)
    ap.add_argument("--d", type=int, default=30)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--gammas", type=int, nargs="+", default=[0, 2, 5, 10])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()
    dev = require_device(args.device)

    rng = np.random.default_rng(0)
    tasks = generate_clustered_tasks(rng, m=args.m, d=args.d, num_clusters=4,
                                     knn=3)
    x, y = tasks.sample(rng, args.n, device=dev)
    graph = ring_graph(args.m, weight=0.5)  # doubly stochastic (Thm 7)
    eta, tau = 1.0, 2.0
    problem = MultiTaskProblem(graph, SQUARED, eta, tau)
    w_star = centralized_solution(problem, x, y)
    f_star = float(problem.erm_objective(w_star, x, y))

    rows = []
    for g in args.gammas:
        res = bol_delayed(problem, x, y, num_iters=args.iters,
                          max_delay=max(g, 1), fixed_delay=(g > 0))
        err = float(torch.linalg.norm(res.w - w_star))
        # empirical linear rate from the objective-gap decay (float32, as the
        # reference's trace minus a Python float)
        tr = np.maximum(res.objective_trace.cpu().numpy() - f_star, 1e-12)
        k0, k1 = args.iters // 4, args.iters // 2
        emp_rate = float((tr[k1] / tr[k0]) ** (1.0 / (k1 - k0))) if tr[k0] > 1e-11 else np.nan
        theo = theorem7_rate(eta, tau, g)
        rows.append([g, err, emp_rate, theo])
        print(f"Gamma={g:3d} |W-W*|={err:.2e} empirical_rate={emp_rate:.4f} "
              f"theorem7_rate={theo:.4f}")
    path = write_csv("delay_bench.csv",
                     ["gamma", "final_err", "empirical_rate", "theorem7_rate"],
                     rows)
    print(f"wrote {path}")
    return rows


if __name__ == "__main__":
    main()
