"""Section 5 demo: one family of updates, two regimes.

The SAME averaging-based iteration solves (a) consensus learning with uniform
weights, and (b) pluralistic multi-task learning with graph-skewed weights
mu = I - alpha*eta*M — and the multi-task solution morphs into the consensus
one as tau -> inf (S -> 0). The counterpart of the reference's
``examples/consensus_vs_multitask.py``.

  PYTHONPATH=src python -m repro_torch.examples.consensus_vs_multitask [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (
    SQUARED,
    MultiTaskProblem,
    bol,
    centralized_solution,
    consensus_distance,
    consensus_sgd,
    ring_graph,
)
from repro_torch.core.consensus import mixing_limit_check
from repro_torch.data.synthetic import generate_clustered_tasks
from repro_torch.experiments.common import add_device_arg, full_f32
from repro_torch.kernels.runtime import require_device

TAUS = [0.1, 1.0, 10.0, 1000.0]
LIMIT_TAUS = [1, 100, 10000]


def main(argv=None) -> dict:
    """Returns {"consensus_spread", "spreads": [(tau, spread of the optimum,
    spread of BOL)], "limit": [(tau, ||M^-1 - 11^T/m||_F)]}."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()
    dev = require_device(args.device)

    rng = np.random.default_rng(0)
    tasks = generate_clustered_tasks(rng, m=16, d=12, num_clusters=4, knn=3)
    x, y = tasks.sample(rng, 80, device=dev)
    graph = ring_graph(16)

    print("=== uniform weights: consensus is maintained forever ===")
    problem = MultiTaskProblem(graph, SQUARED, eta=0.5, tau=1.0)
    res = consensus_sgd(problem, x, y, num_iters=150)
    consensus_spread = float(consensus_distance(res.w))
    print(f"task-spread after 150 uniform-averaging steps: "
          f"{consensus_spread:.2e} (machine-identical iterates)\n")

    print("=== graph-skewed weights: pluralism, tunable by tau ===")
    spreads = []
    for tau in TAUS:
        problem = MultiTaskProblem(graph, SQUARED, eta=0.5, tau=tau)
        w = centralized_solution(problem, x, y)
        res = bol(problem, x, y, num_iters=800)
        opt, it = float(consensus_distance(w)), float(consensus_distance(res.w))
        spreads.append((tau, opt, it))
        print(f"tau={tau:8.1f}  spread(optimum)={opt:.4f}  spread(BOL)={it:.4f}")

    print("\n=== M^{-1} -> uniform projector as tau -> inf (eq. 12) ===")
    limit = list(zip(LIMIT_TAUS, mixing_limit_check(graph, 1.0, LIMIT_TAUS)))
    for tau, dist in limit:
        print(f"tau={tau:6d}  ||M^-1 - (1/m)11^T||_F = {dist:.5f}")
    return {"consensus_spread": consensus_spread, "spreads": spreads, "limit": limit}


if __name__ == "__main__":
    main()
