"""Beyond-paper extension: LEARN the task-relatedness structure.

Counterpart of ``repro.core.graph_learning``. The paper assumes the graph is
known; Liu et al. (2017) — one of its two baselines — alternates between
predictor updates and updating a task relationship matrix. The classic MTRL
closed form in the paper's notation, and an alternating loop:

  Given W, the trace-norm-constrained optimum of
      min_{Omega >= 0, tr(Omega) = m}  tr(W^T W Omega^{-1})
  is  Omega* = m (W^T W)^{1/2} / tr((W^T W)^{1/2}).

Omega*'s off-diagonal structure is projected onto a valid Laplacian (clip
negative affinities) so the learned structure plugs straight back into the
paper's graph machinery, and alternates with any of the paper's solvers.
The relationship matrix is float64 numpy on the host, once per round.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.algorithms import bol
from repro_torch.core.graph import TaskGraph
from repro_torch.core.objective import SQUARED, MultiTaskProblem, as_float64


def mtrl_relationship(w_stack, eps: float = 1e-8) -> np.ndarray:
    """Omega* = m (W W^T)^{1/2} / tr(...) over the TASK axis (tasks stacked
    on axis 0, so the task Gram is W W^T)."""
    w = as_float64(w_stack)
    m = w.shape[0]
    gram = w @ w.T
    evals, evecs = np.linalg.eigh(gram)
    root = (evecs * np.sqrt(np.maximum(evals, eps))) @ evecs.T
    return m * root / max(np.trace(root), eps)


def laplacian_from_relationship(omega: np.ndarray) -> TaskGraph:
    """Affinities from the relationship matrix: normalize Omega to a task
    correlation and keep positive off-diagonal mass — related tasks (near-
    identical predictors) get affinity ~1, orthogonal ones ~0."""
    dg = np.sqrt(np.maximum(np.diag(omega), 1e-12))
    corr = omega / np.outer(dg, dg)
    a = np.maximum((corr + corr.T) / 2.0, 0.0)
    np.fill_diagonal(a, 0.0)
    return TaskGraph(a)


def alternating_graph_learning(
    x,
    y,
    eta: float,
    tau: float,
    num_rounds: int = 3,
    solver=None,
    solver_iters: int = 200,
    init_graph: TaskGraph | None = None,
):
    """Alternate: (1) solve the paper's ERM under the current graph; (2)
    re-estimate the graph from the predictors. Returns (W, graph, history).

    ``solver(problem, x, y, num_iters)`` defaults to accelerated BOL.
    """
    m = x.shape[0]
    graph = init_graph or TaskGraph(np.ones((m, m)) - np.eye(m))
    solver = solver or (lambda p, xx, yy, it: bol(p, xx, yy, num_iters=it))
    history = []
    w = None
    for r in range(num_rounds):
        problem = MultiTaskProblem(graph, SQUARED, eta, tau)
        res = solver(problem, x, y, solver_iters)
        w = res.w
        history.append(
            {"round": r, "objective": float(res.objective_trace[-1]),
             "edges": graph.num_edges}
        )
        graph = laplacian_from_relationship(mtrl_relationship(w))
    return w, graph, history
