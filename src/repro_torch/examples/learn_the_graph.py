"""Beyond-paper example: LEARN the task-relatedness graph instead of
assuming it (the extension Liu et al. 2017 consider; the paper fixes the
graph). Alternates the paper's BOL solver with the MTRL closed-form
relationship update, then compares against (a) the oracle 10-NN graph on the
TRUE predictors and (b) learning with no graph at all. The counterpart of
the reference's ``examples/learn_the_graph.py``.

  PYTHONPATH=src python -m repro_torch.examples.learn_the_graph [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (
    SQUARED,
    MultiTaskProblem,
    alternating_graph_learning,
    bol,
    disconnected_graph,
)
from repro_torch.data.synthetic import generate_clustered_tasks
from repro_torch.experiments.common import add_device_arg, full_f32
from repro_torch.kernels.runtime import require_device


def main(argv=None) -> dict:
    """Returns {"risks": {name: population risk}, "within", "across",
    "history"}."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()
    dev = require_device(args.device)

    rng = np.random.default_rng(0)
    tasks = generate_clustered_tasks(rng, m=20, d=15, num_clusters=3, knn=4,
                                     perturb_scale=0.02)
    x, y = tasks.sample(rng, 40, device=dev)  # scarce data: graph matters
    eta, tau = 0.5, 1.5

    # (a) oracle graph (the paper's assumption)
    oracle = MultiTaskProblem(tasks.graph, SQUARED, eta, tau)
    w_oracle = bol(oracle, x, y, num_iters=200).w

    # (b) no coupling
    lone = MultiTaskProblem(disconnected_graph(tasks.m), SQUARED, eta, 0.0)
    w_lone = bol(lone, x, y, num_iters=200).w

    # (c) learned graph (alternating)
    w_learn, g_learn, hist = alternating_graph_learning(
        x, y, eta=eta, tau=tau, num_rounds=4, solver_iters=200
    )

    risks = {}
    for name, w in [("oracle graph", w_oracle), ("no coupling", w_lone),
                    ("learned graph", w_learn)]:
        risks[name] = tasks.population_risk(w)
        print(f"{name:14s} population risk = {risks[name]:.4f}")

    a = g_learn.adjacency
    same = tasks.cluster_of[:, None] == tasks.cluster_of[None, :]
    np.fill_diagonal(same, False)
    off = ~same & ~np.eye(tasks.m, dtype=bool)
    within, across = float(a[same].mean()), float(a[off].mean())
    print(f"\nlearned affinities: within-cluster mean = {within:.3f}, "
          f"across-cluster mean = {across:.3f}")
    print("alternating history:", hist)
    return {"risks": risks, "within": within, "across": across, "history": hist}


if __name__ == "__main__":
    main()
