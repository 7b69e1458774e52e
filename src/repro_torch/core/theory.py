"""The paper's statistical theory, made executable.

Counterpart of ``repro.core.theory`` (numpy only, the same arithmetic, so
every function returns exactly the reference's value).

Implements:
* rho(B, S)                       — task-relatedness measure (Corollary 2)
* corollary2_parameters           — the (eta, tau) prescription
* lemma1_bound                    — generalization gap bound of Lemma 1
* corollary2_bound                — excess-risk bound of Corollary 2
* sample complexities n_L / n_C   — Section 2
* table1                          — the full complexity accounting of Table 1
* theorem3_stepsizes / b_star     — AC-SA stepsizes + max sample-efficient b
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.graph import TaskGraph


def rho(graph: TaskGraph, B: float, S: float) -> float:
    """rho(B,S) = (1/m) sum_{i=2}^m 1 / (1 + lambda_i m B^2 / S^2).

    Ranges over [0, (m-1)/m]: -> 0 for strongly-related tasks (consensus),
    -> (m-1)/m for unrelated tasks (local learning).
    """
    lam = graph.laplacian_eigvals()
    m = graph.m
    if S <= 0:
        return 0.0
    return float(np.sum(1.0 / (1.0 + lam[1:] * m * B**2 / S**2)) / m)


def corollary2_parameters(
    graph: TaskGraph, B: float, S: float, L: float, n: int
) -> tuple[float, float]:
    """The (eta, tau) of Corollary 2 minimizing the excess-risk bound."""
    m = graph.m
    r = rho(graph, B, S)
    eps = 2 * L * B * math.sqrt((1 + m * r) / (m * n))
    eta = eps / B**2
    tau = eps / (S**2 / m)
    return eta, tau


def lemma1_bound(graph: TaskGraph, eta: float, tau: float, L: float, n: int) -> float:
    """E[F(W_hat) - F_hat(W_hat)] <= (4 L^2 / (m n)) sum_i 1/(eta + tau lam_i)."""
    lam = graph.laplacian_eigvals()
    m = graph.m
    return float(4 * L**2 / (m * n) * np.sum(1.0 / (eta + tau * lam)))


def corollary2_bound(graph: TaskGraph, B: float, S: float, L: float, n: int) -> float:
    """E[F(W_hat) - F(W*)] <= 4 L B sqrt((1 + m rho)/(m n))."""
    m = graph.m
    return 4 * L * B * math.sqrt((1 + m * rho(graph, B, S)) / (m * n))


def n_local(L: float, B: float, eps: float) -> float:
    """Per-machine sample complexity of purely local learning: O(L^2B^2/eps^2)."""
    return (L * B / eps) ** 2


def n_coupled(graph: TaskGraph, B: float, S: float, L: float, eps: float) -> float:
    """Per-machine sample complexity with graph coupling:
    n_C = (1/m + rho) * n_L."""
    return (1.0 / graph.m + rho(graph, B, S)) * n_local(L, B, eps)


def theorem3_stepsizes(
    T: int, m: int, B: float, beta_f: float, sigma: float
) -> tuple[np.ndarray, np.ndarray]:
    """AC-SA stepsize schedules of Theorem 3.

    theta^{t+1} = (t+1)/2,
    alpha^{t+1} = ((t+1)/2) * min(m/(2 beta_f), sqrt(12 m B^2)/((T+2)^{3/2} sigma)).
    """
    t = np.arange(1, T + 1, dtype=np.float64)
    theta = t / 2.0
    base = min(
        m / (2.0 * beta_f),
        math.sqrt(12.0 * m * B**2) / ((T + 2) ** 1.5 * max(sigma, 1e-30)),
    )
    alpha = t / 2.0 * base
    return theta, alpha


def gradient_variance_bound(graph: TaskGraph, B: float, S: float, L: float) -> float:
    """Lemma 4: sigma^2 = (4 L^2 / m^2) (1 + m rho(B,S)) — U-space variance."""
    m = graph.m
    return 4 * L**2 / m**2 * (1 + m * rho(graph, B, S))


def b_star(graph: TaskGraph, B: float, S: float, L: float, beta_f: float, n: int) -> int:
    """Largest sample-efficient minibatch size for SSR (Section 4.1):
    b* = O(n sqrt(eps(m,n) / (beta_F B^2))) with eps(m,n) the Cor. 2 rate."""
    m = graph.m
    eps = 4 * L * B * math.sqrt((1 + m * rho(graph, B, S)) / (m * n))
    return max(1, int(n * math.sqrt(eps / (beta_f * B**2))))


@dataclasses.dataclass(frozen=True)
class ComplexityRow:
    method: str
    comm_rounds: float
    vectors_per_machine: float
    samples_per_machine: float
    samples_processed_per_machine: float


def table1(
    graph: TaskGraph, B: float, S: float, L: float, eps: float
) -> list[ComplexityRow]:
    """The complexity accounting of Table 1 (up to constants/log factors)."""
    m = graph.m
    r = rho(graph, B, S)
    nl = n_local(L, B, eps)
    nc = (1.0 / m + r) * nl
    lam_m = graph.lambda_max
    e_over_m = graph.num_edges / m

    sr_rounds = math.sqrt(B**2 / eps)
    ol_rounds = math.sqrt(max(lam_m, 0.0) * m * B**2 / max(S, 1e-30) ** 2)

    return [
        ComplexityRow("local", 0, 0, nl, nl),
        ComplexityRow("centralized", 1, nc, nc, m * nc),
        ComplexityRow("erm_bsr", sr_rounds, m * sr_rounds, nc, nc * sr_rounds),
        ComplexityRow("erm_bol", ol_rounds, e_over_m * ol_rounds, nc, nc * ol_rounds),
        ComplexityRow("stoch_ssr", sr_rounds, m * sr_rounds, nc, nc),
        ComplexityRow("stoch_sol", ol_rounds, e_over_m * ol_rounds, nc, nc),
    ]
