"""The paper's algorithms as distributed programs over ``torch.distributed``,
one task per rank: the port of ``repro.core.runners``.

``bol_sharded`` / ``bsr_sharded`` are the math of
``repro_torch.core.algorithms.bol/bsr`` (plain, not accelerated) with every
cross-task contraction an explicit collective:

  * BOL: iterate mixing via ``mix_ring`` (ring hops, band graphs only) or
    ``mix_all_gather`` (any graph), then a purely LOCAL prox;
  * BSR: per-machine gradients all-gathered and contracted with this
    rank's column of M^{-1}.

Rank ``i`` of the group takes task ``i``: ``x[i]`` and ``y[i]`` of the full
(m, n, d) / (m, n) data every rank is given, and the group's size must be
m (the reference's shard_map would silently compute with the first task of
a multi-task block; here that raises). Each call returns the full (m, d)
iterate on every rank, as JAX returns the global array.

The calls run on the card unless ``device="cpu"`` is given (``require_
device``): CUDA tensors on ``cuda:<current device>`` over an NCCL group
(one rank per card), CPU tensors over gloo; a group of another backend
raises, nothing falls back. The caller makes the group
(``repro_torch.launch.mesh.init_distributed``). The iteration loop makes
no host sync: the prox's (d, d) system is factored once per call without
the error check, and the collectives are enqueued on the device's stream.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.algorithms import SquaredProx, device_matrix
from repro_torch.core.distributed import (
    BACKENDS,
    mix_all_gather,
    mix_ring,
    mixing_spec_for_band_graph,
)
from repro_torch.core.objective import MultiTaskProblem
from repro_torch.kernels.runtime import require_device


def _setup(problem: MultiTaskProblem, x, y, group, device, what: str):
    """Check the loss, the group's size and backend. Returns the full x on
    the device (for beta_F), this rank's task data (1, n, d) / (1, n), and
    the rank."""
    if problem.loss.name != "squared":
        raise NotImplementedError(f"sharded {what} implemented for squared loss")
    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if dev.type not in BACKENDS or BACKENDS[dev.type] != backend:
        raise ValueError(f"{what}_sharded on {dev} needs a {BACKENDS.get(dev.type)!r} "
                         f"group, got {backend!r}")
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[0] != world:
        raise ValueError(f"{what}_sharded takes one task per rank: {x.shape[0]} tasks over "
                         f"a group of {world} ranks")
    return x, x[rank:rank + 1], y[rank:rank + 1], rank


def _gather_rows(w_loc: torch.Tensor, group) -> torch.Tensor:
    """The (m, d) iterate from each rank's (1, d) row."""
    out = w_loc.new_empty((dist.get_world_size(group),) + tuple(w_loc.shape[1:]))
    dist.all_gather(list(out.unbind(0)), w_loc[0].contiguous(), group=group)
    return out


@torch.no_grad()
def bol_sharded(
    problem: MultiTaskProblem,
    x,
    y,
    num_iters: int,
    group=None,
    stepsize: float | None = None,
    use_ring: bool | None = None,
    device=None,
) -> torch.Tensor:
    """Distributed BOL, one task per rank of ``group`` (the default group
    when None). Communication per iteration: ONE neighbour exchange (ring:
    a hop per band offset) or one all-gather of the iterate — exactly the
    paper's Table-1 BOL row. ``use_ring`` defaults to the ring when the
    graph is a band graph."""
    _, x_loc, y_loc, rank = _setup(problem, x, y, group, device, "bol")
    eta, tau = problem.eta, problem.tau
    alpha = stepsize if stepsize is not None else 1.0 / (eta + tau * problem.graph.lambda_max)
    band = mixing_spec_for_band_graph(problem.graph, eta, tau, alpha)
    if use_ring is None:
        use_ring = band is not None
    if use_ring and band is None:
        raise ValueError("bol_sharded: use_ring needs a band graph")
    mu_col = device_matrix(problem.graph.bol_mixing(eta, tau, alpha), x_loc.device)[:, rank]
    prox = SquaredProx(x_loc, y_loc, alpha)  # this rank's task, factored once
    w = x_loc.new_zeros((1, x_loc.shape[2]))
    for _ in range(num_iters):
        if use_ring:
            mixed = mix_ring(w, band[0], band[1], group)
        else:
            mixed = mix_all_gather(w, mu_col, group)
        w = prox(mixed)
    return _gather_rows(w, group)


@torch.no_grad()
def bsr_sharded(
    problem: MultiTaskProblem,
    x,
    y,
    num_iters: int,
    group=None,
    stepsize: float | None = None,
    device=None,
) -> torch.Tensor:
    """Distributed BSR: per-machine GRADIENTS are all-gathered (the paper's
    broadcast channel) and contracted with this rank's M^{-1} column."""
    x_all, x_loc, y_loc, rank = _setup(problem, x, y, group, device, "bsr")
    n = x_loc.shape[1]
    eta, tau = problem.eta, problem.tau
    beta_f = problem.smoothness_loss(x_all)
    alpha = stepsize if stepsize is not None else 1.0 / (beta_f + eta)
    minv_col = device_matrix(problem.graph.metric_inverse(eta, tau), x_loc.device)[:, rank]
    xl, yl = x_loc[0], y_loc[0]
    w = x_loc.new_zeros((1, x_loc.shape[2]))
    for _ in range(num_iters):
        # local gradient of F_hat_i (per-machine convention)
        grad = ((2.0 / n) * torch.einsum("nd,n->d", xl, xl @ w[0] - yl))[None]
        w = (1.0 - alpha * eta) * w - alpha * mix_all_gather(grad, minv_col, group)
    return _gather_rows(w, group)
