"""Batch (ERM) algorithms of Section 3.

Counterpart of ``repro.core.algorithms``:

* ``bsr`` — "directly solving the regularizer" (Section 3.1, eq. (6)/(7)):
  gradient descent in the U = W M^{1/2} space; dense (broadcast) mixing of
  per-machine *gradients* with weights ``mu = alpha M^{-1}``.
* ``bol`` — "directly optimizing the loss" (Section 3.2, eq. (8)/(9)):
  linearize only the regularizer; neighbor-mix the *iterates* with the sparse
  weights ``mu = I - alpha eta M`` and then solve a local prox subproblem with
  the non-linearized local empirical loss.
* ``gd`` — plain gradient descent on the whole objective.

Both come in plain and Nesterov-accelerated flavours (Appendix C). Each
``lax.scan`` of the reference is a Python loop here that writes the
objective into a preallocated tensor on the inputs' device, so an
iteration never waits for the device. The mixing matrices are float64 on
the host, cast to float32 and copied to the device once per call; the
(d, d) systems of the exact prox are factored once per call and solved
without the error check that would synchronize with the host.

Conventions: tasks stacked on axis 0; per-machine gradients are the gradients
of the *local* empirical risks F_hat_i (i.e. ``m *`` the gradient of
F_hat = (1/m) sum_i F_hat_i).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.objective import MultiTaskProblem


def device_matrix(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host float64 matrix as float32 on ``device`` (one upload)."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


# --------------------------------------------------------------------- prox
class SquaredProx:
    """The exact prox of the local squared-loss empirical risks, with its
    (d, d) systems factored once for reuse over many centers:

        argmin_u 1/(2 alpha) ||u - v||^2 + (1/n) ||X u - y||^2
        => (I/alpha + (2/n) X^T X) u = v/alpha + (2/n) X^T y

    x: (m, n, d), y: (m, n); a center v is (m, d)."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, alpha: float):
        m, n, d = x.shape
        self.alpha = alpha
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        a_mat = eye / alpha + (2.0 / n) * (x.transpose(1, 2) @ x)
        self.xty = (2.0 / n) * torch.einsum("mnd,mn->md", x, y)
        self.lu, self.piv, _ = torch.linalg.lu_factor_ex(a_mat, check_errors=False)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        b = v / self.alpha + self.xty
        return torch.linalg.lu_solve(self.lu, self.piv, b.unsqueeze(-1)).squeeze(-1)


def prox_squared_loss(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Exact prox of the local squared-loss empirical risk, over all tasks.
    v: (m, d), x: (m, n, d), y: (m, n)."""
    return SquaredProx(x, y, alpha)(v)


def prox_gd(
    v: torch.Tensor,
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    alpha: float,
    beta_local: float,
    num_steps: int = 50,
) -> torch.Tensor:
    """Generic inexact prox via fixed-budget gradient descent.

    Minimizes 1/(2 alpha)||u - v||^2 + F_hat_i(u) for all tasks at once;
    ``grad_fn`` maps the (m, d) stack to the stack of local-risk gradients.
    Warm start at the prox center (Appendix F, Lemma 6).
    """
    step = 1.0 / (1.0 / alpha + beta_local)
    u = v
    for _ in range(num_steps):
        u = u - step * ((u - v) / alpha + grad_fn(u))
    return u


# ---------------------------------------------------------------- BSR (3.1)
class RunResult(NamedTuple):
    w: torch.Tensor  # (m, d) final iterate
    objective_trace: torch.Tensor  # (T,) ERM objective per iteration
    w_trace: torch.Tensor | None = None  # optional (T, m, d)


def _trace_runner(step_fn, state, w_of, objective_fn, num_iters, keep_iterates):
    w = w_of(state)
    trace = torch.empty(num_iters, dtype=w.dtype, device=w.device)
    ws = torch.empty((num_iters,) + tuple(w.shape), dtype=w.dtype, device=w.device) \
        if keep_iterates else None
    for t in range(num_iters):
        state = step_fn(state, t)
        w = w_of(state)
        trace[t] = objective_fn(w)
        if ws is not None:
            ws[t] = w
    return RunResult(w_of(state), trace, ws)


def nesterov_momentum(kappa: float) -> float:
    """Nesterov's momentum (sqrt(kappa) - 1) / (sqrt(kappa) + 1) for condition number kappa."""
    return float((np.sqrt(kappa) - 1.0) / (np.sqrt(kappa) + 1.0))


@torch.no_grad()
def bsr(
    problem: MultiTaskProblem,
    x: torch.Tensor,
    y: torch.Tensor,
    num_iters: int,
    stepsize: float | None = None,
    accelerated: bool = True,
    w0: torch.Tensor | None = None,
    keep_iterates: bool = False,
) -> RunResult:
    """Batch "solve the regularizer" (eq. (6)): W <- (1-a eta)W - a M^{-1} G(W).

    G rows are the per-machine gradients grad F_hat_k(w_k). Dense mixing with
    ``M^{-1}`` (computed offline, as the paper prescribes). Accelerated via
    Nesterov momentum in the U-space, where the objective is
    (beta_F + eta)/m-smooth and (eta/m)-strongly convex.
    """
    m, _, d = x.shape
    eta, tau = problem.eta, problem.tau
    beta_f = problem.smoothness_loss(x)
    alpha = stepsize if stepsize is not None else 1.0 / (beta_f + eta)
    m_inv = device_matrix(problem.graph.metric_inverse(eta, tau), x.device)
    momentum = nesterov_momentum((beta_f + eta) / eta) if accelerated else 0.0

    def step(state, _):
        w, w_prev = state
        yv = w + momentum * (w - w_prev)
        g = m * problem.loss_grad(yv, x, y)  # per-machine gradients
        return ((1.0 - alpha * eta) * yv - alpha * (m_inv @ g), w)

    w_init = torch.zeros((m, d), device=x.device) if w0 is None else w0
    return _trace_runner(step, (w_init, w_init), lambda s: s[0],
                         lambda w: problem.erm_objective(w, x, y), num_iters, keep_iterates)


# ---------------------------------------------------------------- BOL (3.2)
@torch.no_grad()
def bol(
    problem: MultiTaskProblem,
    x: torch.Tensor,
    y: torch.Tensor,
    num_iters: int,
    stepsize: float | None = None,
    accelerated: bool = True,
    exact_prox: bool = True,
    inner_steps: int = 50,
    w0: torch.Tensor | None = None,
    keep_iterates: bool = False,
) -> RunResult:
    """Batch "optimize the loss" (eq. (8)/(9)).

    Per iteration: one round of *neighbor-only* communication producing the
    mixed iterate  w~_i = sum_k mu_ki w_k  with  mu = I - alpha eta M,  then a
    purely local prox against the non-linearized empirical loss.

    Default stepsize 1/(m alpha) = beta_R = (eta + tau lam_m)/m, i.e.
    alpha = 1/(eta + tau lam_m) — the smoothness constant of R.
    """
    m, _, d = x.shape
    eta, tau = problem.eta, problem.tau
    lam_max = problem.graph.lambda_max
    alpha = stepsize if stepsize is not None else 1.0 / (eta + tau * lam_max)
    mix = device_matrix(problem.graph.bol_mixing(eta, tau, alpha), x.device)
    # accelerated prox-gradient on g = R (smooth, strongly convex) with
    # h = F_hat handled by the prox: kappa = beta_R / mu_R
    momentum = nesterov_momentum((eta + tau * lam_max) / eta) if accelerated else 0.0

    if exact_prox and problem.loss.name == "squared":
        local_prox = SquaredProx(x, y, alpha)
    else:
        beta_local = problem.smoothness_loss(x)

        def local_prox(v):
            grad_fn = lambda u: m * problem.loss_grad(u, x, y)  # noqa: E731
            return prox_gd(v, grad_fn, alpha, beta_local, inner_steps)

    def step(state, _):
        w, w_prev = state
        yv = w + momentum * (w - w_prev)
        return (local_prox(mix @ yv), w)  # mix: the ONLY communication

    w_init = torch.zeros((m, d), device=x.device) if w0 is None else w0
    return _trace_runner(step, (w_init, w_init), lambda s: s[0],
                         lambda w: problem.erm_objective(w, x, y), num_iters, keep_iterates)


# ----------------------------------------------------- plain GD on (2), (3)
@torch.no_grad()
def gd(
    problem: MultiTaskProblem,
    x: torch.Tensor,
    y: torch.Tensor,
    num_iters: int,
    stepsize: float | None = None,
    w0: torch.Tensor | None = None,
    keep_iterates: bool = False,
) -> RunResult:
    """Vanilla gradient descent on the full objective, eq. (3)/(4): both the
    loss and the regularizer linearized. Included because the paper uses it to
    motivate that *plain* consensus-style updates already solve MTL."""
    m, _, d = x.shape
    eta, tau = problem.eta, problem.tau
    beta = problem.smoothness_loss(x) + eta + tau * problem.graph.lambda_max
    alpha = stepsize if stepsize is not None else 1.0 / beta
    mix = device_matrix(problem.graph.bol_mixing(eta, tau, alpha), x.device)

    def step(w, _):
        return mix @ w - alpha * (m * problem.loss_grad(w, x, y))

    w_init = torch.zeros((m, d), device=x.device) if w0 is None else w0
    return _trace_runner(step, w_init, lambda s: s,
                         lambda w: problem.erm_objective(w, x, y), num_iters, keep_iterates)
