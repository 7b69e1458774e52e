"""Quickstart: the paper in 60 seconds.

Builds the Appendix-I clustered multi-task regression problem, solves it
four ways (Local / Centralized closed-form / BSR / BOL) and prints the
population risks + the paper's task-relatedness measure rho(B, S).
The counterpart of the reference's ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (
    SQUARED,
    MultiTaskProblem,
    bol,
    bsr,
    centralized_solution,
    local_solution,
    theory,
)
from repro_torch.data.synthetic import generate_clustered_tasks
from repro_torch.experiments.common import add_device_arg, full_f32
from repro_torch.kernels.runtime import require_device


def main(argv=None) -> dict:
    """Returns {"rho", "eta", "tau", "f_star", "methods": {name: (population
    risk, ERM objective)}}."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()
    dev = require_device(args.device)

    rng = np.random.default_rng(0)
    tasks = generate_clustered_tasks(rng, m=30, d=30, num_clusters=3, knn=5)
    x, y = tasks.sample(rng, 120, device=dev)

    B, S = tasks.bs_constants()
    eta, tau = theory.corollary2_parameters(tasks.graph, B, S, L=8.0, n=120)
    problem = MultiTaskProblem(tasks.graph, SQUARED, eta, tau)
    rho = theory.rho(tasks.graph, B, S)

    print(f"tasks m={tasks.m}, dim d={tasks.d}, clusters=3")
    print(f"rho(B,S) = {rho:.3f}  "
          f"(0 = consensus-like, {(tasks.m-1)/tasks.m:.2f} = unrelated)")
    print(f"Cor.2 parameters: eta={eta:.4f} tau={tau:.4f}\n")

    w_local = local_solution(x, y, reg=0.1)
    w_cent = centralized_solution(problem, x, y)
    res_bsr = bsr(problem, x, y, num_iters=200)
    res_bol = bol(problem, x, y, num_iters=200)

    f_star = float(problem.erm_objective(w_cent, x, y))
    methods = {}
    for name, w in [("local", w_local), ("centralized", w_cent),
                    ("BSR (batch, solve regularizer)", res_bsr.w),
                    ("BOL (batch, optimize loss)", res_bol.w)]:
        risk = tasks.population_risk(w)
        obj = float(problem.erm_objective(w, x, y))
        methods[name] = (risk, obj)
        print(f"{name:32s} population risk = {risk:.4f}   ERM objective = {obj:.5f}")
    print(f"\nERM optimum f* = {f_star:.5f} — both iterative methods reach it "
          f"with only graph-local (BOL) or gradient-broadcast (BSR) communication.")
    return {"rho": rho, "eta": eta, "tau": tau, "f_star": f_star, "methods": methods}


if __name__ == "__main__":
    main()
