"""Synthetic clustered multi-task regression data — Appendix I.

Counterpart of ``repro.data.synthetic``, drawn from numpy exactly as there,
so one ``np.random.Generator`` seed gives bit-equal predictors, graph and
samples. For task i:  y = <w_i*, x> + eps,  eps ~ N(0, noise_std^2)
(noise_std = sqrt(3), the paper's N(0, 3)),  x ~ N(0, Sigma),
Sigma_ij = 2^{-|i-j|/3}.

Tasks are grouped into C clusters; cluster reference models r_j have entries
Unif[-0.5, 0.5]; task models are r_j + xi_i with xi entries Unif[-0.05, 0.05].
The relatedness graph is the binary 10-NN graph on the *true* predictors.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.graph import TaskGraph, knn_graph
from repro_torch.core.objective import as_float64
from repro_torch.kernels.runtime import require_device


@dataclasses.dataclass(frozen=True)
class ClusteredTasks:
    true_w: np.ndarray  # (m, d)
    sigma_chol: np.ndarray  # (d, d) Cholesky of the input covariance
    noise_std: float
    graph: TaskGraph
    cluster_of: np.ndarray  # (m,)

    @property
    def m(self) -> int:
        return self.true_w.shape[0]

    @property
    def d(self) -> int:
        return self.true_w.shape[1]

    def sample(self, rng: np.random.Generator, n: int,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Draw n fresh samples per task: x (m, n, d), y (m, n), float32 on
        ``require_device(device)`` (CUDA unless told otherwise)."""
        dev = require_device(device)
        m, d = self.true_w.shape
        z = rng.standard_normal((m, n, d))
        x = z @ self.sigma_chol.T
        noise = self.noise_std * rng.standard_normal((m, n))
        y = np.einsum("mnd,md->mn", x, self.true_w) + noise
        return (torch.from_numpy(x.astype(np.float32)).to(dev),
                torch.from_numpy(y.astype(np.float32)).to(dev))

    def population_risk(self, w_stack) -> float:
        """Exact population squared-error risk (no Monte-Carlo needed):
        E(w^T x - y)^2 = (w - w*)^T Sigma (w - w*) + noise_var."""
        sigma = self.sigma_chol @ self.sigma_chol.T
        diff = as_float64(w_stack) - self.true_w
        quad = np.einsum("md,de,me->m", diff, sigma, diff)
        return float(np.mean(quad) + self.noise_std**2)

    def bs_constants(self) -> tuple[float, float]:
        """Empirical (B, S) of the true predictor stack w.r.t. the graph —
        the constraint-set radii the theory speaks about."""
        b = float(np.max(np.linalg.norm(self.true_w, axis=1)))
        lap = self.graph.laplacian()
        s2 = float(np.einsum("md,mk,kd->", self.true_w, lap, self.true_w))
        return b, math.sqrt(max(s2, 0.0))


def generate_clustered_tasks(
    rng: np.random.Generator,
    m: int = 100,
    d: int = 100,
    num_clusters: int = 10,
    knn: int = 10,
    noise_std: float = math.sqrt(3.0),
    ref_scale: float = 0.5,
    perturb_scale: float = 0.05,
) -> ClusteredTasks:
    refs = rng.uniform(-ref_scale, ref_scale, size=(num_clusters, d))
    cluster_of = rng.integers(0, num_clusters, size=m)
    perturb = rng.uniform(-perturb_scale, perturb_scale, size=(m, d))
    true_w = refs[cluster_of] + perturb

    idx = np.arange(d)
    sigma = 2.0 ** (-np.abs(idx[:, None] - idx[None, :]) / 3.0)
    chol = np.linalg.cholesky(sigma)

    graph = knn_graph(true_w, k=min(knn, m - 1))
    return ClusteredTasks(true_w, chol, noise_std, graph, cluster_of)
