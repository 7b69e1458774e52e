"""Delay-tolerant BOL (Appendix G, Theorem 7).

Counterpart of ``repro.core.delayed``. Each machine performs the
proximal-gradient step (20) against *stale* copies of its neighbors'
iterates: machine i sees w_k^{t - d_ik(t)} with delays bounded by Gamma.
Theorem 7 (for doubly-stochastic adjacency) shows linear convergence at the
degraded rate (1 - eta/(eta+tau))^(t/(1+Gamma)).

``bol_delayed`` simulates the delays with a history ring of the last
(Gamma+1) stacked iterates and a per-(i,k) delay schedule (fixed or drawn
per step); ``per_source_stale`` is serving's coarsening of that schedule
(one delay per source task); ``theorem7_rate`` is the theorem's
contraction factor.
"""
from __future__ import annotations

import torch

from repro_torch.core.algorithms import RunResult, SquaredProx, device_matrix
from repro_torch.core.objective import MultiTaskProblem


@torch.no_grad()
def bol_delayed(
    problem: MultiTaskProblem,
    x: torch.Tensor,
    y: torch.Tensor,
    num_iters: int,
    max_delay: int,
    generator: torch.Generator | None = None,
    fixed_delay: bool = False,
) -> RunResult:
    """BOL with stale neighbor iterates, eq. (20).

    Inverse stepsize beta = (eta + tau)/m per Theorem 7 (requires the
    doubly-stochastic normalization of A; callers should pass a graph whose
    rows sum to 1 for the theorem's rate to apply — the method itself runs on
    any graph). Random delays are drawn from ``generator`` (default: seeded
    0 on x's device); ``fixed_delay`` uses Gamma on every edge.
    """
    if problem.loss.name != "squared":
        raise NotImplementedError("delayed BOL implemented for squared loss")
    m, n, d = x.shape
    eta, tau = problem.eta, problem.tau
    dev = x.device
    a_adj = device_matrix(problem.graph.adjacency, x.device)
    deg = a_adj.sum(dim=1)
    beta = (eta + tau) / m  # Theorem 7 stepsize (note: tau*max row sum = tau)
    prox = SquaredProx(x, y, 1.0 / (beta * m))  # the local subproblem's prox
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cols = torch.arange(m, device=dev)[None, :]

    w = torch.zeros((m, d), device=dev)
    hist = torch.zeros((max_delay + 1, m, d), device=dev)  # hist[0] = newest
    trace = torch.empty(num_iters, device=dev)
    for t in range(num_iters):
        if fixed_delay:
            delays = torch.full((m, m), min(max_delay, t), dtype=torch.long, device=dev)
        else:
            delays = torch.randint(0, max_delay + 1, (m, m), generator=generator,
                                   device=dev).clamp_(max=t)  # can't look before t=0
        # stale neighbor view: for each (i, k) pick hist[delays[i,k]][k]
        stale = hist[delays, cols, :]  # (m, m, d)
        # noisy regularizer gradient (eq. in Appendix G)
        grad_r = (
            eta * w + tau * (deg[:, None] * w - torch.einsum("ik,ikd->id", a_adj, stale))
        ) / m
        w = prox(w - grad_r / beta)
        # the ring rolls into a new tensor: no read of the old ring sees a half shift
        hist = torch.cat([w[None], hist[:-1]], dim=0)
        trace[t] = problem.erm_objective(w, x, y)
    return RunResult(w, trace)


def per_source_stale(hist: torch.Tensor, delays: torch.Tensor) -> torch.Tensor:
    """One stale iterate per SOURCE task from a history ring.

    ``hist`` is ``(H, m, ...)`` with ``hist[0]`` the newest stacked iterate;
    ``delays`` is ``(m,)`` with ``0 <= delays[k] < H``. Returns ``(m, ...)``
    where row ``k`` is ``hist[delays[k], k]`` — the view every reader gets
    of task k's parameters: one delay per source instead of per (reader,
    source) pair, still bounded by Gamma, so Theorem 7's rate applies."""
    m = hist.shape[1]
    idx = torch.as_tensor(delays, device=hist.device).long()
    return hist[idx, torch.arange(m, device=hist.device)]


def theorem7_rate(eta: float, tau: float, gamma: int) -> float:
    """Per-iteration contraction factor (1 - eta/(eta+tau))^(1/(1+Gamma))."""
    return float((1.0 - eta / (eta + tau)) ** (1.0 / (1.0 + gamma)))
