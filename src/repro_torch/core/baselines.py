"""Baselines the paper compares against (Section 6 / Appendix H).

Counterpart of ``repro.core.baselines``:

* ``admm``      — synchronized decentralized ADMM of Vanhaesebrouck et al.
                  (2017) on the reformulation (22): each machine keeps copies
                  of its neighbors' predictors, edge constraints tie copies to
                  originals, Jacobi-synchronous primal/dual updates.
* ``sdca``      — distributed SDCA of Liu et al. (2017) with a *fixed* task
                  relationship matrix (CoCoA-style safe Jacobi aggregation,
                  Ma et al. 2015), squared loss.
* ``local_solution`` / ``centralized_solution`` — closed-form references.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algorithms import RunResult, device_matrix
from repro_torch.core.objective import MultiTaskProblem, local_ridge_solution


# -------------------------------------------------------------------- ADMM
@torch.no_grad()
def admm(
    problem: MultiTaskProblem,
    x: torch.Tensor,
    y: torch.Tensor,
    num_iters: int,
    rho: float = 1.0,
) -> RunResult:
    """Synchronized ADMM on the copy-consensus reformulation (22).

    Machine i's variables: predictor w_i plus a copy c[i, k] of every neighbor
    k's predictor; constraints c[i, k] = w_k carry scaled duals u[i, k]. Dense
    masked (m, m, d) layout for the copies (zero off-graph), so the synchronous
    update is one batched (d, d) solve per machine per iteration; the (d, d)
    systems do not change, so they are factored once.

    Proper 2-block ADMM (fixed point == the ERM optimum for any rho > 0):
      block 1 (all machines in parallel): minimize over w_i with (c, u) fixed
              -> one (d, d) ridge solve per machine;
      block 2: copies in closed form
              c[i,k] = (s_ik w_i + rho w_k - u[i,k]) / (s_ik + rho),
              s_ik = tau a_ik / (2 m);
      dual:   u[i,k] += rho (c[i,k] - w_k).
    Squared loss only.
    """
    if problem.loss.name != "squared":
        raise NotImplementedError("ADMM baseline implemented for squared loss")
    m, n, d = x.shape
    eta, tau = problem.eta, problem.tau
    a_adj = device_matrix(problem.graph.adjacency, x.device)  # (m, m)
    mask = (a_adj > 0).to(torch.float32)
    deg = mask.sum(dim=1)  # |N_i|
    s = tau * a_adj / (2.0 * m)

    xtx = (2.0 / (m * n)) * (x.transpose(1, 2) @ x)  # (m, d, d)
    xty = (2.0 / (m * n)) * torch.einsum("mnd,mn->md", x, y)  # (m, d)
    eye = torch.eye(d, device=x.device)
    quad_scalar = eta / m + s.sum(dim=1) + rho * deg
    lu, piv, _ = torch.linalg.lu_factor_ex(xtx + quad_scalar[:, None, None] * eye[None],
                                           check_errors=False)
    on_edge = mask[:, :, None] > 0
    mask_t = mask.T[:, :, None]

    w = torch.zeros((m, d), device=x.device)
    c = torch.zeros((m, m, d), device=x.device)
    u = torch.zeros((m, m, d), device=x.device)
    trace = torch.empty(num_iters, device=x.device)
    for t in range(num_iters):
        # --- block 1: w_i solve with copies/duals fixed ---
        #  (xtx + (eta/m + sum_k s_ik + rho deg_i) I) w_i
        #    = xty + sum_k s_ik c[i,k] + sum_k u[k,i] + rho sum_k c[k,i]
        lin = (
            xty
            + torch.einsum("ik,ikd->id", s, c)
            + (u * mask_t).sum(dim=0)
            + rho * (c * mask_t).sum(dim=0)
        )
        w = torch.linalg.lu_solve(lu, piv, lin.unsqueeze(-1)).squeeze(-1)
        # --- block 2: copies in closed form from the fresh w's ---
        c = torch.where(
            on_edge,
            (s[:, :, None] * w[:, None, :] + rho * w[None, :, :] - u)
            / (s + rho)[:, :, None],
            0.0,
        )
        # --- dual ascent ---
        u = u + rho * mask[:, :, None] * (c - w[None, :, :])
        trace[t] = problem.erm_objective(w, x, y)
    return RunResult(w, trace)


# -------------------------------------------------------------------- SDCA
@torch.no_grad()
def sdca(
    problem: MultiTaskProblem,
    x: torch.Tensor,
    y: torch.Tensor,
    num_rounds: int,
    local_epochs: int = 1,
    sigma_prime: float | None = None,
    generator: torch.Generator | None = None,
) -> RunResult:
    """Distributed SDCA with fixed relationship matrix (Liu et al. 2017).

    Primal (== objective (2), squared loss):
        P(W) = (1/(m n)) sum_ij (w_i^T x_ij - y_ij)^2 + (1/(2m)) <W, Q W>,
        Q = eta I + tau L,  K = Q^{-1}.
    Duality: phi(p) = (p-y)^2 has phi*(a) = a^2/4 + a y; stationarity gives
        (Q W)_i = -(1/n) sum_j a_ij x_ij  =>  W = -K V,  v_i = (1/n) X_i^T a_i.
    Coordinate ascent step for dual variable a_ij (all machines in Jacobi
    parallel, CoCoA-style safe curvature sigma' * K_ii):
        delta = (w_i^T x_ij - a_ij/2 - y_ij) / (1/2 + sigma' K_ii |x_ij|^2 / n)
    followed by the local primal correction w_i -= K_ii delta x_ij / n; one
    global communication round per outer round recomputes W = -K V exactly.

    Each machine's pass visits its n samples in an order drawn from
    ``generator`` (default: seeded 0 on x's device). The pass is n
    sequential steps of a few small operations each.
    """
    if problem.loss.name != "squared":
        raise NotImplementedError("SDCA baseline implemented for squared loss")
    m, n, d = x.shape
    eta, tau = problem.eta, problem.tau
    k_mat = device_matrix(
        np.linalg.inv(eta * np.eye(m) + tau * problem.graph.laplacian()), x.device
    )
    k_diag = torch.diagonal(k_mat)  # (m,)
    if sigma_prime is None:
        sigma_prime = float(m)  # safe (adding) aggregation bound of Ma et al.
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    rows = torch.arange(m, device=x.device)

    def w_of(a_dual):
        v = torch.einsum("inj,in->ij", x, a_dual) / n  # (m, d)
        return -(k_mat @ v)

    def local_pass(a_dual, w_loc):
        # one independent permutation of [0, n) per machine
        perm = torch.argsort(torch.rand((m, n), generator=generator, device=x.device), dim=1)
        xp = torch.gather(x, 1, perm[:, :, None].expand(m, n, d))
        yp = torch.gather(y, 1, perm)
        a_dual = a_dual.clone()  # written in place below; nothing else holds it
        for j in range(n):
            j_idx = perm[:, j]
            xj, yj = xp[:, j], yp[:, j]
            aj = a_dual[rows, j_idx]
            pred = torch.sum(w_loc * xj, dim=-1)
            xj_sq = torch.sum(xj * xj, dim=-1)
            denom = 0.5 + sigma_prime * k_diag * xj_sq / n
            delta = (pred - aj / 2.0 - yj) / denom
            a_dual[rows, j_idx] = aj + delta
            # sigma'-scaled local model: the whole local quadratic (including
            # within-machine cross terms tracked through w_loc) is inflated by
            # sigma', per the CoCoA+ safe local subproblem
            w_loc = w_loc - sigma_prime * k_diag[:, None] * delta[:, None] * xj / n
        return a_dual

    a_dual = torch.zeros((m, n), device=x.device)
    trace = torch.empty(num_rounds, device=x.device)
    for r in range(num_rounds):
        w = w_of(a_dual)  # the communication round
        for _ in range(local_epochs):
            a_dual = local_pass(a_dual, w)
        trace[r] = problem.erm_objective(w_of(a_dual), x, y)
    return RunResult(w_of(a_dual), trace)


def local_solution(x: torch.Tensor, y: torch.Tensor, reg: float) -> torch.Tensor:
    return local_ridge_solution(x, y, reg)


def centralized_solution(problem: MultiTaskProblem, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    return problem.closed_form_solution(x, y)
