"""Distributed implementations of the paper's updates: the port of
``repro.core.distributed``. Two layers:

1. **Collective primitives** (``mix_all_gather``, ``mix_ring``): the
   neighbour averaging  w~_i = sum_k mu_ki w_k  over a ``torch.distributed``
   process group, rank ``i`` holding task ``i``. Dense mixing (BSR,
   arbitrary graphs) is one all-gather and a contraction with this rank's
   column of mu; band graphs (BOL's peer-to-peer regime) take one
   bidirectional hop per band offset (``dist.batch_isend_irecv``), so each
   rank's traffic is proportional to its degree, as in Table 1. They run
   on NCCL for CUDA tensors and on gloo for CPU tensors, whatever group the
   caller made; ``repro_torch.core.runners`` runs the paper's solvers on
   them.

2. **``GraphMultiTask``**: the mixed update of the LM trainer. It
   partitions a model's parameters into shared and per-task (personalized)
   ones, the personalized ones carrying a leading task axis, and applies
   the paper's communication round inside the train step:

       theta_i <- sum_k mu_ki theta_k            (then  - alpha * g_i, eq. (3))

   with ``mu = I - alpha*eta*M`` over the task graph; the shared backbone
   follows plain data-parallel SGD/Adam. A complete uniform graph recovers
   consensus (fully shared) training, Section 5's limit. The personalized
   leaves may be DTensors (``repro_torch.sharding``): the contraction over
   the task axis then lowers to the mixing collective, as under the
   reference's pjit.

``mixing_spec_for_band_graph`` reads a band graph's mixing as (self weight,
neighbour weights).

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
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.core.graph import TaskGraph

PyTree = Any


# ------------------------------------------------------- collective mixing
# the process-group backend of each device type: collectives never fall
# back from NCCL to gloo, nor from CUDA to the CPU
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _group_size_rank(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def mix_all_gather(theta: torch.Tensor, mix_row_weights: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Dense mixing: each rank holds its own task's theta (leading axis 1);
    all-gather over ``group`` (the default group when None) into (m, ...),
    then contract with this rank's column of the mixing matrix.

    theta: (1, ...) local block; mix_row_weights: (m,) = mu[:, i] for my
    rank i. Returns (1, ...) = (mu^T theta)_i."""
    world, _ = _group_size_rank(group)
    gathered = theta.new_empty((world,) + tuple(theta.shape[1:]))
    dist.all_gather(list(gathered.unbind(0)), theta[0].contiguous(), group=group)
    w = mix_row_weights.reshape((-1,) + (1,) * (gathered.ndim - 1))
    return (w * gathered).sum(dim=0, keepdim=True)


def _hop(t: torch.Tensor, shift: int, group) -> torch.Tensor:
    """One ring hop: rank i sends ``t`` to rank i + shift and returns what
    rank i - shift sent (ranks mod the group's size)."""
    world, rank = _group_size_rank(group)
    if world == 1:  # a one-device ppermute is the identity; torch refuses a send to self
        return t

    def peer(r):
        r %= world
        return r if group is None else dist.get_global_rank(group, r)

    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, peer(rank + shift), group),
           dist.P2POp(dist.irecv, out, peer(rank - shift), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def mix_ring(theta: torch.Tensor, self_weight: float,
             neighbor_weights: tuple[float, ...], group=None) -> torch.Tensor:
    """Band-graph mixing by ring hops (peer to peer): mu^T theta for the
    band mixing of ``mixing_spec_for_band_graph``,

        new_i = self_weight * theta_i
                + sum_{o=1..bw} nw[o-1] * (theta_{i-o} + theta_{i+o}),

    where the antipodal neighbour of an even ring (2 o == m: theta_{i-o} is
    theta_{i+o}) is one neighbour and counted once. Each offset is one
    bidirectional hop that forwards the previous hop's values, as the
    reference's ``ppermute`` chain does (one hop, forward only, at the
    antipodal offset). theta: (1, ...) local block of rank i."""
    world, _ = _group_size_rank(group)
    out = self_weight * theta
    fwd = bwd = theta
    for off, wgt in enumerate(neighbor_weights, start=1):
        fwd = _hop(fwd, 1, group)  # theta_{i-off}
        if 2 * off == world:
            out = out + wgt * fwd
            continue
        bwd = _hop(bwd, -1, group)  # theta_{i+off}
        out = out + wgt * (fwd + bwd)
    return out


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
        when not given). The product contracts the task axis in place (no
        flattening of the other axes), so a DTensor leaf (``repro_torch.
        sharding``) keeps its sharded trailing axes: mu^T goes in as a
        replicated DTensor on the leaf's mesh, and the result comes back in
        the leaf's placements."""

        def go(path, leaf):
            if not self.is_task_param(path, leaf):
                return leaf
            mt = mix if mix is not None else self.mix_tensor(leaf.device)
            mesh = getattr(leaf, "device_mesh", None)
            if mesh is not None:  # a DTensor leaf
                from torch.distributed.tensor import DTensor, Replicate

                mt = DTensor.from_local(mt, mesh, [Replicate()] * mesh.ndim, run_check=False)
            out = torch.tensordot(mt, leaf.float(), dims=1).to(leaf.dtype)
            if mesh is not None:
                out = out.redistribute(mesh, leaf.placements)
            return out

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
