"""The task graph's mixing weights and the adapter store's fixed-delay stale
mix, worked out afresh in float64 from the graph's definition.

A store's iterate k is ``M_k x0`` for a matrix ``M_k`` over the tasks: each
update mixes the iterate ``bound`` updates back, ``bound = min(max_delay,
updates so far)`` for every source task alike (``fixed_delay``), with the
weights' transpose, and serves ``mu^T`` times its newest iterate. With no
gradients pushed the step adds nothing, so ``M_k`` is a function of k alone.
"""
from __future__ import annotations

import numpy as np


def band_adjacency(m: int, bandwidth: int) -> np.ndarray:
    a = np.zeros((m, m))
    for i in range(m):
        for off in range(1, bandwidth + 1):
            a[i, (i + off) % m] = a[(i + off) % m, i] = 1.0
    return a


def laplacian(a: np.ndarray) -> np.ndarray:
    return np.diag(a.sum(axis=1)) - a


def bsr(a, eta, tau, alpha) -> np.ndarray:
    """mu = alpha (I + tau/eta L)^{-1}."""
    return alpha * np.linalg.inv(np.eye(len(a)) + tau / eta * laplacian(a))


def bol(a, eta, tau, alpha=None) -> np.ndarray:
    """mu = I - alpha (eta I + tau L), alpha = 1 / (eta + tau lambda_max) by
    default."""
    lap = laplacian(a)
    if alpha is None:
        alpha = 1.0 / (eta + tau * np.linalg.eigvalsh(lap)[-1])
    return np.eye(len(a)) - alpha * (eta * np.eye(len(a)) + tau * lap)


def mixing(store: dict) -> np.ndarray:
    a = band_adjacency(store["num_tasks"], store["bandwidth"])
    if store["mixing"] == "bsr":
        return bsr(a, store["eta"], store["tau"], store["alpha"])
    return bol(a, store["eta"], store["tau"], store.get("alpha"))


def served_coefficients(mu: np.ndarray, max_delay: int, wanted, served: bool = True) -> dict:
    """{k: mu^T M_k} for each update count k in ``wanted``: row t gives task
    t's served adapters as a combination of the first iterate's rows
    (``served=False``: the iterate ``M_k`` itself, unmixed)."""
    wanted = set(int(k) for k in wanted)
    out = {}
    hist = [np.eye(len(mu))]
    k = 0
    while True:
        if k in wanted:
            out[k] = mu.T @ hist[0] if served else hist[0]
        if k >= max(wanted, default=0):
            return out
        bound = min(max_delay, len(hist) - 1)
        hist = [mu.T @ hist[bound]] + hist[:max_delay]
        k += 1
