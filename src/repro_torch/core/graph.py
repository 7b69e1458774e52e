"""Task-relatedness graphs, Laplacians and mixing matrices.

Counterpart of ``repro.core.graph``: a weighted graph ``A`` over the ``m``
tasks, its Laplacian ``L = diag(A 1) - A``, the induced metric matrix
``M = I + (tau/eta) L`` and the mixing-weight families of the algorithms:

* BSR / SSR ("solve the regularizer"): ``mu = alpha * M^{-1}``  (dense).
* BOL / SOL ("optimize the loss"):     ``mu = I - alpha * eta * M``
  (sparse — supported exactly on the graph edges plus the diagonal).
* consensus: the doubly-stochastic limit ``I - L / lambda_max``.

The graph and its matrices are numpy float64, computed once on the host as
in the reference; only the regularizer (``penalty``, ``penalty_grad``) acts
on torch tensors, through a float32 copy of ``L`` kept per device, so that
a solver's loop copies nothing from the host after its first iteration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TaskGraph:
    """A weighted, undirected task-relatedness graph over ``m`` tasks."""

    adjacency: np.ndarray  # (m, m) symmetric, non-negative, zero diagonal
    # device copies of the Laplacian, keyed by (device, dtype)
    _lap_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def __post_init__(self):
        a = np.asarray(self.adjacency, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if not np.allclose(a, a.T):
            raise ValueError("adjacency must be symmetric")
        if (a < 0).any():
            raise ValueError("adjacency must be non-negative")
        a = a.copy()
        np.fill_diagonal(a, 0.0)
        object.__setattr__(self, "adjacency", a)

    # ---------------------------------------------------------------- basics
    @property
    def m(self) -> int:
        return self.adjacency.shape[0]

    @property
    def num_edges(self) -> int:
        return int(np.count_nonzero(np.triu(self.adjacency, k=1)))

    def laplacian(self) -> np.ndarray:
        a = self.adjacency
        return np.diag(a.sum(axis=1)) - a

    def laplacian_eigvals(self) -> np.ndarray:
        """Eigenvalues 0 = lam_1 <= ... <= lam_m of the Laplacian."""
        return np.linalg.eigvalsh(self.laplacian())

    @property
    def lambda_max(self) -> float:
        """The largest eigenvalue of the Laplacian."""
        return float(self.laplacian_eigvals()[-1])

    def is_connected(self) -> bool:
        """Connected iff the second-smallest Laplacian eigenvalue is positive."""
        ev = self.laplacian_eigvals()
        return bool(ev[1] > 1e-10 * max(1.0, ev[-1]))

    def is_doubly_stochastic(self, atol: float = 1e-8) -> bool:
        """Row sums == 1 (symmetric, so column sums too): Appendix G's regime."""
        return bool(np.allclose(self.adjacency.sum(axis=1), 1.0, atol=atol))

    # ----------------------------------------------------------- paper terms
    def metric_matrix(self, eta: float, tau: float) -> np.ndarray:
        """``M = I + (tau/eta) L`` (positive definite for eta > 0)."""
        if eta <= 0:
            raise ValueError("eta must be positive for M to be defined")
        return np.eye(self.m) + (tau / eta) * self.laplacian()

    def metric_inverse(self, eta: float, tau: float) -> np.ndarray:
        """``M^{-1}``, computed once on the host (Section 3.1)."""
        return np.linalg.inv(self.metric_matrix(eta, tau))

    def metric_sqrt(self, eta: float, tau: float) -> np.ndarray:
        """``M^{1/2}`` through the eigendecomposition of M (float64, host)."""
        w, v = np.linalg.eigh(self.metric_matrix(eta, tau))
        return (v * np.sqrt(np.maximum(w, 0.0))) @ v.T

    def metric_inv_sqrt(self, eta: float, tau: float) -> np.ndarray:
        """``M^{-1/2}``, eigenvalues floored at 1e-30 (float64, host)."""
        w, v = np.linalg.eigh(self.metric_matrix(eta, tau))
        return (v / np.sqrt(np.maximum(w, 1e-30))) @ v.T

    # --------------------------------------------------------- mixing weights
    def bsr_mixing(self, eta: float, tau: float, alpha: float) -> np.ndarray:
        """Dense averaging weights ``mu = alpha * M^{-1}``."""
        return alpha * self.metric_inverse(eta, tau)

    def bol_mixing(self, eta: float, tau: float, alpha: float) -> np.ndarray:
        """Sparse averaging weights ``mu = I - alpha*eta*M``:
        ``mu_ii = 1 - alpha*(eta + tau*deg_i)``, ``mu_ik = alpha*tau*a_ik``."""
        return np.eye(self.m) - alpha * eta * self.metric_matrix(eta, tau)

    def consensus_mixing(self) -> np.ndarray:
        """Doubly-stochastic limit weights of eq. (12): ``I - L/lambda_m``."""
        return np.eye(self.m) - self.laplacian() / self.lambda_max

    # ------------------------------------------------------------ regularizer
    def laplacian_on(self, like: torch.Tensor) -> torch.Tensor:
        """``L`` as a tensor of ``like``'s dtype on its device, copied from
        the host once per (device, dtype)."""
        key = (like.device, like.dtype)
        if key not in self._lap_cache:
            self._lap_cache[key] = torch.as_tensor(
                self.laplacian(), dtype=like.dtype, device=like.device
            )
        return self._lap_cache[key]

    def penalty(self, w_stack: torch.Tensor, eta: float, tau: float) -> torch.Tensor:
        """``R(W) = eta/(2m) ||W||_F^2 + tau/(2m) tr(W^T L W)`` for the
        task-stacked ``w_stack`` (m, d) (row i is task i's predictor)."""
        lap = self.laplacian_on(w_stack)
        m = self.m
        sq = torch.sum(w_stack * w_stack)
        smooth = torch.sum(w_stack * (lap @ w_stack))
        return eta / (2 * m) * sq + tau / (2 * m) * smooth

    def penalty_grad(self, w_stack: torch.Tensor, eta: float, tau: float) -> torch.Tensor:
        """``grad_W R(W) = (1/m) (eta I + tau L) W`` (tasks stacked on axis 0)."""
        lap = self.laplacian_on(w_stack)
        return (eta * w_stack + tau * (lap @ w_stack)) / self.m


# ------------------------------------------------------------------ builders
def knn_graph(predictors: np.ndarray, k: int = 10) -> TaskGraph:
    """Binary k-nearest-neighbour graph on task predictors (Appendix I):
    task i is joined to the k tasks whose models are nearest (Euclidean),
    symmetrized as the union of the directed edges."""
    w = np.asarray(predictors, dtype=np.float64)
    m = w.shape[0]
    if not 1 <= k < m:
        raise ValueError(f"need 1 <= k < m, got k={k}, m={m}")
    d2 = ((w[:, None, :] - w[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    a = np.zeros((m, m))
    nbrs = np.argsort(d2, axis=1)[:, :k]
    a[np.repeat(np.arange(m), k), nbrs.ravel()] = 1.0
    return TaskGraph(np.maximum(a, a.T))


def ring_graph(m: int, weight: float = 1.0) -> TaskGraph:
    """Cycle graph."""
    a = np.zeros((m, m))
    for i in range(m):
        a[i, (i + 1) % m] = weight
        a[(i + 1) % m, i] = weight
    return TaskGraph(a)


def band_graph(m: int, bandwidth: int, weight: float = 1.0) -> TaskGraph:
    """Each task joined to its ``bandwidth`` nearest ring neighbours on
    each side."""
    a = np.zeros((m, m))
    for i in range(m):
        for off in range(1, bandwidth + 1):
            j = (i + off) % m
            a[i, j] = a[j, i] = weight
    return TaskGraph(a)


def complete_graph(m: int, weight: float = 1.0) -> TaskGraph:
    """Fully connected graph: all tasks alike (Evgeniou & Pontil, 2004)."""
    return TaskGraph(weight * (np.ones((m, m)) - np.eye(m)))


def cluster_graph(labels: np.ndarray, weight: float = 1.0) -> TaskGraph:
    """Block graph joining the tasks of each cluster."""
    labels = np.asarray(labels)
    a = weight * (labels[:, None] == labels[None, :]).astype(np.float64)
    np.fill_diagonal(a, 0.0)
    return TaskGraph(a)


def disconnected_graph(m: int) -> TaskGraph:
    """No edges: multi-task learning degenerates to local learning."""
    return TaskGraph(np.zeros((m, m)))
