"""Stochastic algorithms of Section 4 (fresh minibatch per iteration).

Counterpart of ``repro.core.stochastic``:

* ``ssr`` — accelerated minibatch SGD in U-space (Algorithm 2 / AC-SA of
  Lan 2012), Theorem 3 stepsizes.
* ``sol`` — stochastic "optimize the loss" (eq. (11)): neighbor mixing +
  local prox on a fresh minibatch, optionally Nesterov-accelerated.
* ``minibatch_prox`` — the sample-efficient Algorithm 3 (Appendix E):
  outer minibatch-prox in U-space, inner accelerated prox-gradient with
  warm starts (Appendix F).

A *sampler* is a callable ``sample_fn(generator, b) -> (x, y)`` with shapes
(m, b, d), (m, b) — either fresh draws from the population (true stochastic
setting) or uniform draws from a fixed training set (the SSR/SOL curves of
the ERM experiment). A run takes one ``torch.Generator`` and passes it to
every draw in turn (the reference splits a key per iteration); the run's
device is the generator's.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.algorithms import (
    RunResult,
    SquaredProx,
    device_matrix,
    nesterov_momentum,
    prox_gd,
)
from repro_torch.core.objective import MultiTaskProblem

Sampler = Callable[[torch.Generator, int], tuple[torch.Tensor, torch.Tensor]]


def minibatch_sampler(x: torch.Tensor, y: torch.Tensor) -> Sampler:
    """Uniform-with-replacement sampler over a fixed training set. Draws on
    the generator's device, which must be the data's."""
    m, n, d = x.shape

    def sample(generator: torch.Generator, b: int):
        # randint(0, n) indices are in bounds by construction
        idx = torch.randint(0, n, (m, b), generator=generator, device=generator.device)
        xb = torch.gather(x, 1, idx[:, :, None].expand(m, b, d))
        return xb, torch.gather(y, 1, idx)

    return sample


def _dim(sample_fn: Sampler, generator: torch.Generator, d: int | None) -> int:
    """d as given, or from one draw on a copy of the generator, so that the
    run's own draws are the same either way. (A sampler that keeps its own
    state instead of drawing from the generator needs ``d`` given.)"""
    if d is not None:
        return d
    probe = torch.Generator(device=generator.device)
    probe.set_state(generator.get_state())
    return sample_fn(probe, 1)[0].shape[-1]


# ------------------------------------------------------------ SSR (Alg. 2)
@torch.no_grad()
def ssr(
    problem: MultiTaskProblem,
    sample_fn: Sampler,
    batch_size: int,
    num_iters: int,
    generator: torch.Generator,
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
    beta_f: float,
    B: float,
    sigma: float | None = None,
    w0: torch.Tensor | None = None,
    d: int | None = None,
) -> RunResult:
    """Accelerated minibatch SGD (AC-SA), Algorithm 2, W-space form.

    W_md  = th^{-1} W + (1-th^{-1}) W_ag
    W    <- W - a^{t+1} * M^{-1} G^{t+1}(W_md)     (per-machine grads G)
    W_ag  = th^{-1} W + (1-th^{-1}) W_ag
    with th^{t+1} = (t+1)/2 and alpha from Theorem 3.
    """
    m = problem.graph.m
    eta, tau = problem.eta, problem.tau
    dev = generator.device
    if sigma is None:
        # Lemma 4 bound, scaled to per-machine gradients (the m* convention)
        sigma = m * np.sqrt(theory.gradient_variance_bound(problem.graph, B, 1.0, 1.0))
        sigma = max(float(sigma), 1e-6)
    m_inv = device_matrix(problem.graph.metric_inverse(eta, tau), dev)
    theta, alpha = theory.theorem3_stepsizes(num_iters, m, B, beta_f, sigma)
    # float32 schedules as in the reference; the Theorem-3 alpha is stated for
    # the U-space (1/m-scaled) gradient, G is the per-machine stack: rescale
    th_inv = np.float32(1.0) / theta.astype(np.float32)
    alpha = alpha.astype(np.float32) / np.float32(m)

    d = _dim(sample_fn, generator, d)
    w = torch.zeros((m, d), device=dev) if w0 is None else w0
    w_ag = w
    trace = torch.empty(num_iters, device=dev)
    for t in range(num_iters):
        ti, a_t = float(th_inv[t]), float(alpha[t])
        tc = float(np.float32(1.0) - th_inv[t])
        w_md = ti * w + tc * w_ag
        xb, yb = sample_fn(generator, batch_size)
        g = m * problem.loss_grad(w_md, xb, yb)
        w = w - a_t * (m_inv @ g)
        w_ag = ti * w + tc * w_ag
        trace[t] = eval_fn(w_ag)
    return RunResult(w_ag, trace)


# --------------------------------------------------------------- SOL (4.2)
@torch.no_grad()
def sol(
    problem: MultiTaskProblem,
    sample_fn: Sampler,
    batch_size: int,
    num_iters: int,
    generator: torch.Generator,
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
    stepsize: float | None = None,
    accelerated: bool = True,
    inner_steps: int = 30,
    beta_local: float | None = None,
    w0: torch.Tensor | None = None,
    d: int | None = None,
) -> RunResult:
    """Stochastic "optimize the loss", eq. (11): per iteration one round of
    neighbor-only communication, then a local prox on a *fresh* minibatch."""
    m = problem.graph.m
    eta, tau = problem.eta, problem.tau
    dev = generator.device
    lam_max = problem.graph.lambda_max
    alpha = stepsize if stepsize is not None else 1.0 / (eta + tau * lam_max)
    mix = device_matrix(problem.graph.bol_mixing(eta, tau, alpha), dev)
    momentum = nesterov_momentum((eta + tau * lam_max) / eta) if accelerated else 0.0

    def local_prox(v, xb, yb):
        if problem.loss.name == "squared":
            return SquaredProx(xb, yb, alpha)(v)
        grad_fn = lambda u: m * problem.loss_grad(u, xb, yb)  # noqa: E731
        bl = beta_local if beta_local is not None else 1.0
        return prox_gd(v, grad_fn, alpha, bl, inner_steps)

    d = _dim(sample_fn, generator, d)
    w = torch.zeros((m, d), device=dev) if w0 is None else w0
    w_prev = w
    trace = torch.empty(num_iters, device=dev)
    for t in range(num_iters):
        yv = w + momentum * (w - w_prev)
        mixed = mix @ yv
        xb, yb = sample_fn(generator, batch_size)
        w, w_prev = local_prox(mixed, xb, yb), w
        trace[t] = eval_fn(w)
    return RunResult(w, trace)


# ------------------------------------------------- minibatch-prox (Alg. 3)
@torch.no_grad()
def minibatch_prox(
    problem: MultiTaskProblem,
    sample_fn: Sampler,
    batch_size: int,
    num_outer: int,
    generator: torch.Generator,
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
    B: float,
    S: float,
    L: float,
    inner_iters: int = 20,
    gamma: float | None = None,
    d: int | None = None,
) -> RunResult:
    """Algorithm 3: distributed minibatch prox.

    Outer: W^{t+1} ~ argmin (gamma/2) tr((W-W^t) M (W-W^t)^T) + F_hat^{t+1}(W)
    Inner: accelerated prox-gradient ProxGrad(g = gamma-quadratic, h = local
    loss) with warm start at W^t (Appendix F). Output = average of outer
    iterates.
    """
    graph = problem.graph
    m = graph.m
    dev = generator.device
    if gamma is None:
        r = theory.rho(graph, B, S)
        gamma = (
            2.0
            * np.sqrt(num_outer / batch_size)
            * L
            * np.sqrt(1.0 + m * r)
            / (m**1.5 * B)
        )
        gamma = float(max(gamma, 1e-8))
    # M with the Cor.2 ratio tau/eta = m B^2 / S^2 (Appendix D/E convention)
    m_mat = device_matrix(np.eye(m) + (m * B**2 / S**2) * graph.laplacian(), dev)
    lam_max = graph.lambda_max
    beta_inner = gamma * (1.0 + m * B**2 / S**2 * lam_max)  # smoothness of g
    mom = float((np.sqrt(beta_inner) - np.sqrt(gamma))
                / (np.sqrt(beta_inner) + np.sqrt(gamma)))

    def inner_solve(w_t, xb, yb):
        """Accelerated prox-grad on f(W) = g(W) + h(W), prox-step on h."""
        if problem.loss.name == "squared":
            # prox of h = F_hat = (1/m) sum_i (1/b)||X_i u - y_i||^2 at
            # parameter beta: per machine (beta/2)||u-v||^2 + (1/m)(1/b)||.||^2
            # => prox_squared_loss alpha = 1/(m * beta); one factorization
            # serves every inner step of this minibatch
            prox = SquaredProx(xb, yb, 1.0 / (m * beta_inner))
        else:
            grad_fn = lambda z: problem.loss_grad(z, xb, yb)  # noqa: E731
            prox = lambda v: prox_gd(v, grad_fn, 1.0 / beta_inner, 1.0, 10)  # noqa: E731
        u = u_prev = w_t
        for _ in range(inner_iters):
            yv = u + mom * (u - u_prev)
            g_grad = gamma * (m_mat @ (yv - w_t))  # task-axis mixing, (m,m)@(m,d)
            u, u_prev = prox(yv - g_grad / beta_inner), u
        return u

    d = _dim(sample_fn, generator, d)
    w = torch.zeros((m, d), device=dev)
    w_sum = torch.zeros_like(w)
    trace = torch.empty(num_outer, device=dev)
    for t in range(num_outer):
        xb, yb = sample_fn(generator, batch_size)
        w = inner_solve(w, xb, yb)
        w_sum = w_sum + w
        trace[t] = eval_fn(w)
    return RunResult(w_sum / num_outer, trace)
