"""The reference's side of a training check: the first steps of the graph-
regularized multi-task step in plain PyTorch. Each step takes the mean
cross-entropy's gradients at the current weights (accumulated over blocks of
rows, so that it fits beside nothing else), mixes the per-task leaves
(``task.*``, task axis first) with ``mu^T`` of the BOL weights, then takes an
AdamW step (bias-corrected moments, no weight decay) on the mixed leaves
with those gradients.

Returns per step the loss, the gradient norm of every leaf at the first
step, and the norm of every leaf's change after the last.
"""
from __future__ import annotations

import numpy as np
import torch

from h100bench.lib import weights
from h100bench.reference import decoder, mixing


def loss(c: dict, params: dict, batch: dict, tf32=False):
    tokens, labels, tasks = batch["tokens"], batch["labels"], batch["task_ids"]
    x = params["embed"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(c["num_layers"]):
        x = decoder.block(c, params, i, x, pos, tf32)
    lg = decoder.logits(c, params, x, tasks, tf32)
    return torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))


def initial(c: dict, seed: int, device) -> dict:
    p = dict(weights.top(c, seed, device))
    for i in range(c["num_layers"]):
        p.update(weights.layer(c, seed, i, device))
    return {k: v.clone() for k, v in p.items()}


def run(c: dict, opt: dict, seed: int, device, batches, rows_per_block: int,
        tf32=False, rows=None) -> dict:
    """``len(batches)`` reference steps from the seed's weights. ``rows``
    keeps only those rows of every batch (a fault of the step under
    test, read as a control)."""
    params = initial(c, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    mu = torch.tensor(mixing.mixing(opt["graph"]).T, dtype=torch.float32, device=device)
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    losses, grad_norms = [], None
    for step, batch in enumerate(batches):
        batch = {k: torch.as_tensor(np.asarray(v), device=device).long() for k, v in batch.items()}
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        n = batch["tokens"].shape[0]
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for r0 in range(0, n, rows_per_block):
            part = {k: v[r0:r0 + rows_per_block] for k, v in batch.items()}
            frac = part["tokens"].shape[0] / n
            lv = loss(c, params, part, tf32) * frac
            for k, g in zip(params, torch.autograd.grad(lv, list(params.values()))):
                grads[k] += g
            total += float(lv.detach())
        losses.append(total)
        if step == 0:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        t = step + 1
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        with torch.no_grad():
            for k, p in params.items():
                if k.startswith("task."):
                    p.copy_(torch.tensordot(mu, p, dims=1))
                g = grads[k]
                m1[k].mul_(b1).add_(g * (1 - b1))
                m2[k].mul_(b2).add_(g.square() * (1 - b2))
                p.sub_(lr * (m1[k] / bc1) / ((m2[k] / bc2).sqrt() + eps))
    change = {k: float((params[k].detach() - start[k]).norm()) for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
