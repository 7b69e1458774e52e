"""Stale-iterate helpers of delay-tolerant BOL (Appendix G, Theorem 7).

Counterpart of the serving half of ``repro.core.delayed``:
``per_source_stale`` picks one bounded-delay iterate per source task from a
history ring, and ``theorem7_rate`` is the theorem's contraction factor.
``bol_delayed`` itself waits for the port of the paper's solvers.
"""
from __future__ import annotations

import torch


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
