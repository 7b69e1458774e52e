"""Section 5: the consensus <-> multi-task connection, made executable.

Counterpart of ``repro.core.consensus``:

* ``consensus_sgd`` — uniform-weight averaging of gradients == mini-batch SGD
  on the consensus objective (all iterates stay identical across machines
  when started from a common point).
* ``consensus_limit_mixing`` — the S -> 0 (tau -> inf) limit weights (12):
  doubly-stochastic  mu = I - L / lambda_m  with the stepsize on the local
  gradient going to 0 relative to (mu - I): the Nedic-Ozdaglar regime.
* ``mixing_limit_check`` — numerical verification that  alpha M^{-1} -> (1/m) 11^T
  as tau -> inf (used by tests and the consensus example).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algorithms import RunResult
from repro_torch.core.graph import TaskGraph
from repro_torch.core.objective import MultiTaskProblem


@torch.no_grad()
def consensus_sgd(
    problem: MultiTaskProblem,
    x: torch.Tensor,
    y: torch.Tensor,
    num_iters: int,
    stepsize: float | None = None,
) -> RunResult:
    """Uniform-weight BSR == (mini-batch) gradient descent on the consensus
    objective F_hat(W) + (eta/2m)||W||_F^2. With W^0 = 0 all rows stay equal
    forever; we keep the stacked form to demonstrate exactly that."""
    m, _, d = x.shape
    eta = problem.eta
    beta_f = problem.smoothness_loss(x)
    alpha = stepsize if stepsize is not None else 1.0 / (beta_f + eta)
    uniform = torch.full((m, m), 1.0 / m, device=x.device)

    w = torch.zeros((m, d), device=x.device)
    trace = torch.empty(num_iters, device=x.device)
    for t in range(num_iters):
        g = m * problem.loss_grad(w, x, y)  # per-machine gradients
        w = (1.0 - alpha * eta) * w - alpha * (uniform @ g)
        trace[t] = problem.erm_objective(w, x, y)
    return RunResult(w, trace)


def consensus_limit_mixing(graph: TaskGraph) -> np.ndarray:
    """Eq. (12): the doubly-stochastic limit weights I - L/lambda_m."""
    return graph.consensus_mixing()


def mixing_limit_check(graph: TaskGraph, eta: float, taus: list[float]) -> list[float]:
    """|| alpha*M^{-1} - (1/m) 11^T ||_F as tau grows (alpha absorbed: we
    compare M^{-1} itself against the rank-one uniform projector since the
    leading eigenvalue of M^{-1} is exactly 1 for connected graphs)."""
    m = graph.m
    uniform = np.full((m, m), 1.0 / m)
    return [
        float(np.linalg.norm(graph.metric_inverse(eta, tau) - uniform))
        for tau in taus
    ]


def consensus_distance(w_stack: torch.Tensor) -> torch.Tensor:
    """Max pairwise distance of the task predictors — 0 iff consensus."""
    mean = torch.mean(w_stack, dim=0, keepdim=True)
    return torch.max(torch.linalg.vector_norm(w_stack - mean, dim=-1))
