"""Minimal optax-style optimizers over trees of tensors, updated in place.

Counterpart of ``repro.optim.optimizers``. ``Optimizer`` bundles
``init(params) -> state`` and ``update(grads, state, params, step) ->
(params, state)``; ``params`` and ``grads`` are trees of the same structure
(dicts of tensors: ``TransformerLM.named_parameters()`` in the trainer).

Where the JAX functions return new arrays, ``update`` writes the new values
INTO ``params`` and the state tensors under ``torch.no_grad()`` and returns
them: every parameter keeps its storage (its ``data_ptr``), so a CUDA graph
captured before a step reads the stepped weights. The arithmetic follows
the reference op for op. AdamW keeps its moments in float32 whatever the
parameters' dtype (``torch.optim.AdamW`` keeps bf16 moments for bf16
parameters). ``step`` is a Python int, so a schedule's rate is a host
number and an update makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, int], tuple[PyTree, PyTree]]
    # update(grads, state, params, step) -> (params, state), both updated in place


def _f32(x) -> float:
    return float(np.float32(x))


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable[[int], float]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; evaluated in float32 like the reference."""

    def lr(step):
        step = np.float32(step)
        if step < warmup:
            return _f32(np.float32(base_lr) * step / np.float32(max(warmup, 1)))
        prog = np.clip((step - np.float32(warmup)) / np.float32(max(total - warmup, 1)),
                       np.float32(0.0), np.float32(1.0))
        cos = np.float32(1.0) + np.cos(np.float32(math.pi) * prog)
        return _f32(np.float32(0.5 * base_lr) * cos)

    return lr


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_lib.map_(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        step_lr = lr_fn(step)
        # each new value computed in float32 and rounded once to the leaf's
        # dtype (bf16 leaves may then differ from eager JAX by an ulp)
        if momentum == 0.0:
            for p, g in zip(tree_lib.leaves(params), tree_lib.leaves(grads)):
                p.copy_(p.float() - step_lr * g.float())
            return params, ()
        for p, m, g in zip(tree_lib.leaves(params), tree_lib.leaves(state),
                           tree_lib.leaves(grads)):
            m.copy_(momentum * m.float() + g.float())
            p.copy_(p.float() - step_lr * m.float())
        return params, state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: PyTree
    nu: PyTree


def adamw(
    lr: float | Callable = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamState(tree_lib.map_(f32, params), tree_lib.map_(f32, params))

    @torch.no_grad()
    def update(grads, state, params, step):
        t = np.float32(step) + np.float32(1.0)
        step_lr = lr_fn(step)
        bc1 = _f32(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = _f32(np.float32(1.0) - np.float32(b2) ** t)
        for p, m, v, g in zip(tree_lib.leaves(params), tree_lib.leaves(state.mu),
                              tree_lib.leaves(state.nu), tree_lib.leaves(grads)):
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            upd = (m / bc1).mul_(step_lr).div_((v / bc2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(p.float() * (step_lr * weight_decay))
            if p.dtype == torch.float32:
                p.sub_(upd)
            else:
                p.copy_(p.float() - upd)
        return params, state

    return Optimizer(init, update)
