"""Multi-task objectives: losses, empirical risk, and the regularized ERM.

Counterpart of ``repro.core.objective``. Tasks are stacked on the leading
axis:

    W : (m, d)        row i = task i's predictor
    X : (m, n, d)     n samples of dimension d per task
    y : (m, n)        targets

Risks are vectorized over tasks. Gradients are the losses' analytic
derivatives, exactly what ``jax.grad`` gives in the reference, so a
solver's loop builds no autograd graph. The closed-form solutions and the
smoothness constants are float64 numpy on the host, as in the reference;
they read the data once per call, never per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.graph import TaskGraph


def as_float64(a) -> np.ndarray:
    """A host float64 numpy copy of a tensor (any device) or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, dtype=np.float64)


# ------------------------------------------------------------------- losses
@dataclasses.dataclass(frozen=True)
class Loss:
    """Per-sample instantaneous loss ell(w, (x, y)) with its constants."""

    name: str
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (pred, target) -> per sample
    deriv: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # d fn / d pred

    def per_task_risk(self, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean loss of a single task: w (d,), x (n, d), y (n,)."""
        return torch.mean(self.fn(x @ w, y))

    def per_task_risks(self, w_stack: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
        """F_hat_i(w_i) for every task: (m,)."""
        pred = torch.einsum("mnd,md->mn", x, w_stack)
        return torch.mean(self.fn(pred, y), dim=-1)

    def empirical_risk(self, w_stack: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
        """F_hat(W) = (1/m) sum_i F_hat_i(w_i); shapes (m,d),(m,n,d),(m,n)."""
        return torch.mean(self.per_task_risks(w_stack, x, y))

    def risk_grad(self, w_stack: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
        """grad_W F_hat(W): row i is (1/m)(1/n) X_i^T ell'(X_i w_i, y_i)."""
        m, n, _ = x.shape
        pred = torch.einsum("mnd,md->mn", x, w_stack)
        coef = self.deriv(pred, y) / (m * n)
        return torch.einsum("mn,mnd->md", coef, x)

    def smoothness(self, x) -> float:
        """Data-dependent smoothness beta_i of F_hat_i for this loss, max over
        tasks (the paper's beta_F): 2 lam_max(X^T X / n) for the squared
        loss, lam_max(X^T X / n) / 4 for the logistic. One host copy of x."""
        x_np = as_float64(x)
        if x_np.ndim == 2:
            x_np = x_np[None]
        gram = np.swapaxes(x_np, 1, 2) @ x_np / x_np.shape[1]
        return float(np.linalg.eigvalsh(gram)[:, -1].max()) * self._curvature()

    def _curvature(self) -> float:
        if self.name == "squared":
            return 2.0
        if self.name == "logistic":
            return 0.25
        raise NotImplementedError(self.name)


def _sq(pred, target):
    return (pred - target) ** 2


def _sq_deriv(pred, target):
    return 2.0 * (pred - target)


def _logistic(pred, target):
    # target in {-1, +1}; the reference's expression (softplus differs above 20)
    return torch.log1p(torch.exp(-target * pred))


def _logistic_deriv(pred, target):
    e = torch.exp(-target * pred)
    return -target * e / (1.0 + e)


SQUARED = Loss("squared", _sq, _sq_deriv)
LOGISTIC = Loss("logistic", _logistic, _logistic_deriv)


# --------------------------------------------------------------- objectives
@dataclasses.dataclass(frozen=True)
class MultiTaskProblem:
    """The regularized ERM problem (2) plus its population counterpart."""

    graph: TaskGraph
    loss: Loss
    eta: float
    tau: float

    # ---- empirical ----
    def erm_objective(self, w_stack: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
        """F_hat(W) + R(W) — the objective of eq. (2)."""
        return self.loss.empirical_risk(w_stack, x, y) + self.graph.penalty(
            w_stack, self.eta, self.tau
        )

    def erm_grad(self, w_stack: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        return self.loss_grad(w_stack, x, y) + self.reg_grad(w_stack)

    def loss_grad(self, w_stack: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
        """grad F_hat(W) only (no regularizer)."""
        return self.loss.risk_grad(w_stack, x, y)

    def reg_grad(self, w_stack: torch.Tensor) -> torch.Tensor:
        return self.graph.penalty_grad(w_stack, self.eta, self.tau)

    # ---- exact solve (squared loss only; the 'Centralized' baseline) ----
    def closed_form_solution(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Solve (2) exactly for the squared loss via the (md x md) normal
        equations in float64 on the host, exploiting the Kronecker structure:

            (2/n) X_i^T X_i w_i + eta w_i + tau (L W)_i = (2/n) X_i^T y_i

        Returns float32 on x's device."""
        if self.loss.name != "squared":
            raise NotImplementedError("closed form only for squared loss")
        x_np, y_np = as_float64(x), as_float64(y)
        m, n, d = x_np.shape
        lap = self.graph.laplacian()
        big = np.kron(self.tau * lap, np.eye(d))
        for i in range(m):
            gram = (2.0 / n) * x_np[i].T @ x_np[i] + self.eta * np.eye(d)
            big[i * d : (i + 1) * d, i * d : (i + 1) * d] += gram
        rhs = np.concatenate([(2.0 / n) * x_np[i].T @ y_np[i] for i in range(m)])
        w = np.linalg.solve(big, rhs).reshape(m, d)
        return torch.as_tensor(w, dtype=torch.float32, device=_device_of(x))

    # ---- constants for stepsize rules ----
    def smoothness_loss(self, x) -> float:
        """beta_F = max_i beta_i — smoothness of each local empirical loss."""
        return self.loss.smoothness(x)

    def smoothness_reg(self) -> float:
        """beta_R * m = eta + tau * lambda_m — smoothness of m*R(W)."""
        return self.eta + self.tau * self.graph.lambda_max


def _device_of(a) -> torch.device:
    return a.device if isinstance(a, torch.Tensor) else torch.device("cpu")


def local_ridge_solution(x: torch.Tensor, y: torch.Tensor, reg: float) -> torch.Tensor:
    """The 'Local' baseline: per-task ridge regression, no communication.

    min_w (1/n)||X_i w - y_i||^2 + (reg/2)||w||^2, solved in closed form in
    float64 on the host; float32 on x's device.
    """
    x_np, y_np = as_float64(x), as_float64(y)
    m, n, d = x_np.shape
    out = np.zeros((m, d))
    for i in range(m):
        gram = (2.0 / n) * x_np[i].T @ x_np[i] + reg * np.eye(d)
        out[i] = np.linalg.solve(gram, (2.0 / n) * x_np[i].T @ y_np[i])
    return torch.as_tensor(out, dtype=torch.float32, device=_device_of(x))
