"""The paper's mixed update integrated into training: the single-process
part of ``repro.core.distributed``.

``GraphMultiTask`` partitions a model's parameters into shared and per-task
(personalized) ones, the personalized ones carrying a leading task axis,
and applies the paper's communication round inside the train step:

    theta_i <- sum_k mu_ki theta_k            (then  - alpha * g_i, eq. (3))

with ``mu = I - alpha*eta*M`` over the task graph; the shared backbone
follows plain data-parallel SGD/Adam. A complete uniform graph recovers
consensus (fully shared) training, Section 5's limit.
``mixing_spec_for_band_graph`` reads a band graph's mixing as (self weight,
neighbour weights). The collectives over a device mesh (``mix_all_gather``,
``mix_ring``) are not ported yet.

Parameter trees are dicts of tensors (``dict(model.named_parameters())``, or
nested as the JAX tree); the predicate ``is_task_param(path, leaf)`` sees a
leaf's path, "task.head_bias" for a port parameter name, and the default
``"task" in path`` selects the same leaves as the reference's does on
"task/head_bias".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core.graph import TaskGraph

PyTree = Any


def mixing_spec_for_band_graph(
    graph: TaskGraph, eta: float, tau: float, alpha: float
) -> tuple[float, tuple[float, ...]] | None:
    """If the graph is a uniform band graph, return (self_weight,
    neighbor_weights) for the BOL mixing mu = I - alpha*eta*M; else None."""
    a = graph.adjacency
    m = graph.m
    first = a[0]
    # detect band: a[i, j] depends only on ring distance
    for i in range(m):
        rolled = np.roll(a[i], -i)
        if not np.allclose(rolled, first):
            return None
    weights = []
    for off in range(1, m // 2 + 1):
        if first[off] > 0:
            weights.append(float(alpha * tau * first[off]))
        elif any(first[o] > 0 for o in range(off + 1, m // 2 + 1)):
            return None  # holes in the band
        else:
            break
    deg = float(a[0].sum())
    self_w = 1.0 - alpha * (eta + tau * deg)
    return self_w, tuple(weights)


@dataclasses.dataclass(frozen=True)
class GraphMultiTask:
    """Graph-regularized per-task personalization.

    * ``graph``: relatedness graph over the ``m`` tasks.
    * ``eta, tau``: the paper's regularization strengths.
    * ``alpha``: mixing stepsize (default 1/(eta + tau*lambda_max), the BOL
      smoothness rule).
    * ``is_task_param``: predicate on (path, leaf) choosing the personalized
      leaves; they carry a leading task axis of length m.
    """

    graph: TaskGraph
    eta: float
    tau: float
    alpha: float | None = None
    is_task_param: Callable[[str, Any], bool] = lambda p, x: "task" in p

    @property
    def m(self) -> int:
        return self.graph.m

    def _alpha(self) -> float:
        if self.alpha is not None:
            return self.alpha
        return 1.0 / (self.eta + self.tau * self.graph.lambda_max)

    def mixing_matrix(self) -> np.ndarray:
        """BOL weights mu = I - alpha*eta*M = I - alpha*(eta I + tau L)
        (float64, host). eta == tau == 0 degenerates to the identity
        (purely local learning)."""
        if self.eta == 0.0 and self.tau == 0.0:
            return np.eye(self.m)
        if self.eta == 0.0:
            lap = self.graph.laplacian()
            alpha = self.alpha if self.alpha is not None else 1.0 / max(
                self.tau * self.graph.lambda_max, 1e-12
            )
            return np.eye(self.m) - alpha * self.tau * lap
        return self.graph.bol_mixing(self.eta, self.tau, self._alpha())

    def mix_tensor(self, device) -> torch.Tensor:
        """mu^T as a float32 (m, m) tensor on ``device``: one upload, which
        a train step makes once (``make_train_step``), not per step."""
        return torch.as_tensor(self.mixing_matrix().T, dtype=torch.float32, device=device)

    # ---- parameter-tree surgery ----
    def partition(self, params: PyTree) -> tuple[PyTree, PyTree]:
        """Split params into (shared, task) trees (None-filled complements)."""
        shared = tree_lib.map_with_path(
            lambda p, x: None if self.is_task_param(p, x) else x, params)
        task = tree_lib.map_with_path(
            lambda p, x: x if self.is_task_param(p, x) else None, params)
        return shared, task

    def replicate_task_params(self, params: PyTree) -> PyTree:
        """Give every personalized leaf a leading task axis (m, ...): a
        broadcast view of the leaf."""

        def rep(path, leaf):
            if self.is_task_param(path, leaf):
                return leaf[None].expand((self.m,) + tuple(leaf.shape))
            return leaf

        return tree_lib.map_with_path(rep, params)

    # ---- the update ----
    def mix_task_params(self, params: PyTree, mix: torch.Tensor | None = None) -> PyTree:
        """theta <- mu^T theta along each personalized leaf's leading task
        axis: one float32 product per leaf, cast back to the leaf's dtype;
        new tensors for those leaves, the shared leaves as they are.
        ``mix``: mu^T from ``mix_tensor`` on the leaves' device (made here
        when not given)."""

        def go(path, leaf):
            if not self.is_task_param(path, leaf):
                return leaf
            mt = mix if mix is not None else self.mix_tensor(leaf.device)
            flat = leaf.reshape(self.m, -1)
            return (mt @ flat.float()).to(leaf.dtype).reshape(leaf.shape)

        return tree_lib.map_with_path(go, params)

    def graph_penalty(self, params: PyTree) -> torch.Tensor:
        """R(theta) over all personalized leaves, for loss-side
        regularization (the 'centralized' flavor; the mixed update is the
        distributed one)."""
        total = None
        for path, leaf in tree_lib.paths(params):
            if self.is_task_param(path, leaf):
                term = self.graph.penalty(leaf.reshape(self.m, -1).float(), self.eta, self.tau)
                total = term if total is None else total + term
        return torch.zeros(()) if total is None else total
