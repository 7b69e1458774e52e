"""Training step with the paper's graph-multi-task update as a first-class
feature: the port of ``repro.train.trainer``.

Per step (eq. (3) of the paper, generalized to deep nets):
  1. grads of the task loss (+ optional explicit graph penalty) at the
     current parameters theta;
  2. task-personalized leaves are neighbor-MIXED with mu = I - alpha*eta*M
     along their leading task axis (the communication round);
  3. optimizer update of the MIXED parameters with the grads of step 1
     (shared leaves: plain data-parallel step; task leaves: a local step on
     the mixed iterate, exactly  w <- sum_k mu_ki w_k - a g_i).

The step is eager (the reference jits it). It updates the model's own
parameters in place, so each keeps its ``data_ptr``: a serving CUDA graph
captured before training reads the trained weights. mu^T goes to the device
once per ``make_train_step``, the step counter is a Python int and metrics
stay on the device until a caller reads them, so a step makes no host sync
(its batch comes up through pinned memory, ``batch_to_device``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch import tree as tree_lib
from repro_torch.core.distributed import GraphMultiTask
from repro_torch.models.model import TransformerLM
from repro_torch.optim.optimizers import Optimizer

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree  # dict(model.named_parameters()): the model's own tensors
    opt_state: PyTree
    step: int


def batch_to_device(batch: dict, device) -> dict:
    """A host batch (numpy or tensors) as tensors on ``device``; to CUDA
    through pinned memory with non-blocking copies, so the upload makes no
    host sync."""
    device = torch.device(device)
    out = {}
    with tracing.span("train.upload"):
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            if device.type == "cuda" and t.device.type == "cpu":
                t = t.contiguous().pin_memory().to(device, non_blocking=True)
            out[k] = t.to(device)
    return out


def make_train_step(
    model: TransformerLM,
    optimizer: Optimizer,
    multitask: GraphMultiTask | None = None,
    aux_weight: float = 0.01,
    graph_penalty_weight: float = 0.0,
    microbatches: int = 1,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``microbatches > 1`` splits the global batch and accumulates the
    gradients in float32: activation memory scales down by the microbatch
    count while the optimizer/communication schedule is unchanged (one
    graph-mix round per step). A batch whose size the count does not
    divide runs whole, as in the reference."""
    mix = None if multitask is None else multitask.mix_tensor(model.device)

    def grads_of(params, batch):
        with tracing.span("train.grads"):
            loss, metrics = model.loss_fn(batch, aux_weight=aux_weight)
            if multitask is not None and graph_penalty_weight > 0.0:
                loss = loss + graph_penalty_weight * multitask.graph_penalty(params)
            grads = torch.autograd.grad(loss, tree_lib.leaves(params), allow_unused=True,
                                        materialize_grads=True)
            return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), list(grads)

    def accumulate(params, batch):
        b = tree_lib.leaves(batch)[0].shape[0]
        k = microbatches
        if k <= 1 or b % k != 0:
            return grads_of(params, batch)
        # strided split (microbatch j takes global rows j::k) so every
        # microbatch covers every task evenly
        micro = [{key: v[j::k] for key, v in batch.items()} for j in range(k)]
        (loss, metrics), grads = grads_of(params, micro[0])
        grads = [g.float() for g in grads]
        for mb in micro[1:]:
            (l_j, m_j), g_j = grads_of(params, mb)
            for acc, g in zip(grads, g_j):
                acc.add_(g)
            loss = loss + l_j
            metrics = {name: metrics[name] + m_j[name] for name in metrics}
        inv = 1.0 / k
        grads = [g * inv for g in grads]
        metrics = {name: v * inv for name, v in metrics.items()}
        return (loss * inv, metrics), grads

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        with tracing.span("train.step"):
            (loss, metrics), grads = accumulate(state.params, batch)
            params = state.params
            if multitask is not None:
                # the paper's communication round: theta <- mu^T theta, in place
                with tracing.span("train.mix"), torch.no_grad():
                    mixed = multitask.mix_task_params(params, mix)
                    for p, new in zip(tree_lib.leaves(params), tree_lib.leaves(mixed)):
                        if new is not p:
                            p.copy_(new)
            with tracing.span("train.optimizer"):
                params, opt_state = optimizer.update(
                    tree_lib.unflatten(params, grads), state.opt_state, params, state.step
                )
            metrics = dict(metrics, loss=loss)
            return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def init_state(model: TransformerLM, optimizer: Optimizer) -> TrainState:
    """The model's own parameters (already initialized: the port's model is
    built from a seed or loaded through ``repro_torch.convert``), the
    optimizer's fresh state, step 0."""
    params = dict(model.named_parameters())
    return TrainState(params, optimizer.init(params), 0)


def train_loop(
    model: TransformerLM,
    optimizer: Optimizer,
    data_iter,
    num_steps: int,
    multitask: GraphMultiTask | None = None,
    log_every: int = 10,
):
    """``num_steps`` steps over host batches from ``data_iter``; every
    ``log_every`` steps and at the last the metrics are read to the host
    into ``history`` (``{'nll', 'aux', 'loss', 'step'}``)."""
    state = init_state(model, optimizer)
    step_fn = make_train_step(model, optimizer, multitask)
    history = []
    for i, batch in enumerate(data_iter):
        if i >= num_steps:
            break
        state, metrics = step_fn(state, batch_to_device(batch, model.device))
        if i % log_every == 0 or i == num_steps - 1:
            history.append({k: float(v) for k, v in metrics.items()} | {"step": i})
    return state, history
