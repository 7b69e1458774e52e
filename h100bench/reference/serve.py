"""The reference's side of a serving check: each sampled request's prompt
with its served tokens, run once through the plain decoder, layer by layer
(each layer's weights drawn again from the seed), and the gap by which each
served token's logit lies below the reference's best at its position.

With adapters, each position runs under the store's state that served it:
``states[p]`` is the update count at the dispatch that computed position p,
and the adapter rows of (task, count) are the served coefficients of
``mixing.served_coefficients`` applied to the first iterate, drawn again
from the seed.

``store_gap`` holds the store's served tree after the window to
``mu^T M_K x0`` at its final update count K, worked out in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from h100bench.lib import weights
from h100bench.reference import decoder, mixing


def _segments(states: np.ndarray):
    """(start, end, state) runs of equal states."""
    cut = np.flatnonzero(np.diff(states)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(states)]])
    return [(int(s), int(e), int(states[s])) for s, e in zip(starts, ends)]


def adapter_rows(c: dict, store: dict, seed: int, device, pairs) -> dict:
    """{(task, count): {leaf: row}} for each (task, update count) pair."""
    pairs = sorted(set(pairs))
    coef = mixing.served_coefficients(mixing.mixing(store), store["max_delay"],
                                      {k for _, k in pairs})
    cmat = torch.tensor(np.stack([coef[k][t] for t, k in pairs]), dtype=torch.float32,
                        device=device)
    rows = {p: {} for p in pairs}
    for name, x0 in weights.adapters(c, store, seed, device).items():
        mixed = torch.matmul(cmat, x0.reshape(x0.shape[0], -1))
        for j, p in enumerate(pairs):
            rows[p][name] = mixed[j].reshape(x0.shape[1:])
    return rows


@torch.no_grad()
def gaps(c: dict, seed: int, device, requests, store=None, tf32_control=False) -> dict:
    """requests: dicts with "prompt" (S0,), "out" (n,) served tokens,
    "task", and under a store "states" (n,) the update count at the
    dispatch that produced each token. Returns {"logit_gap": widest gap
    of a served token below the reference's best, "tokens": compared} and,
    with ``tf32_control``, "control_gap": the widest gap of the tokens the
    TF32 control puts first at the same positions."""
    seqs, want, segs, tasks = [], [], [], []
    for r in requests:
        prompt, out = np.asarray(r["prompt"]), np.asarray(r["out"])
        full = np.concatenate([prompt, out[:-1]])
        seqs.append(torch.tensor(full, dtype=torch.long, device=device))
        want.append(np.arange(len(prompt) - 1, len(full)))
        tasks.append(int(r["task"]))
        if store is not None:
            st = np.asarray(r["states"])
            # the prompt's positions ran under the first token's state,
            # position S0 - 1 + i under the state of token i
            per_pos = np.concatenate([np.full(len(prompt), st[0]), st[1:]])
            segs.append(_segments(per_pos))
    rows = None
    if store is not None:
        rows = adapter_rows(c, store, seed, device,
                         [(t, k) for t, sg in zip(tasks, segs) for _, _, k in sg])
    variants = [False, True] if tf32_control else [False]
    res = {v: _logits(c, seed, device, seqs, want, tasks, segs, rows, v) for v in variants}
    gap, ctl, n = 0.0, 0.0, 0
    for j, r in enumerate(requests):
        ref = res[False][j]
        served = torch.tensor(np.asarray(r["out"]), dtype=torch.long, device=device)
        best = ref.max(dim=-1).values
        gap = max(gap, float((best - ref.gather(1, served[:, None])[:, 0]).max()))
        n += len(served)
        if tf32_control:
            pick = res[True][j].argmax(dim=-1)
            ctl = max(ctl, float((best - ref.gather(1, pick[:, None])[:, 0]).max()))
    out = {"logit_gap": gap, "tokens": n}
    if tf32_control:
        out["control_gap"] = ctl
    return out


def _logits(c, seed, device, seqs, want, tasks, segs, rows, tf32):
    """(len(want_j), V) reference logits at the wanted positions of each
    sequence."""
    top = weights.top(c, seed, device)
    xs = [top["embed"][s][None] for s in seqs]
    for i in range(c["num_layers"]):
        w = weights.layer(c, seed, i, device)
        for j, s in enumerate(seqs):
            lora = None
            if rows is not None:
                lora = _lora(segs[j], rows, tasks[j], tf32)
            pos = torch.arange(len(s), device=device)
            xs[j] = decoder.block(c, w, i, xs[j], pos, tf32, lora)
        del w
    out = []
    for j, x in enumerate(xs):
        idx = torch.as_tensor(want[j], device=device)
        gain = bias = None
        if rows is not None:
            per_pos = np.zeros(x.shape[1], np.int64)
            for s, e, k in segs[j]:
                per_pos[s:e] = k
            ks = per_pos[want[j]]
            if "final_gain" in rows[(tasks[j], int(ks[0]))]:
                gain = torch.stack([rows[(tasks[j], int(k))]["final_gain"] for k in ks])[None]
            bias = torch.stack([rows[(tasks[j], int(k))]["head_bias"] for k in ks])[None]
        tid = torch.tensor([tasks[j]], device=device)
        out.append(decoder.logits(c, top, x[:, idx], tid, tf32, gain, bias)[0])
    return out


def _lora(seg, rows, task, tf32):
    def delta(branch, i, h):
        out = torch.zeros_like(h)
        for s, e, k in seg:
            r = rows[(task, k)]
            out[:, s:e] = decoder.mm(decoder.mm(h[:, s:e], r[f"{branch}.a"][i], tf32),
                                     r[f"{branch}.b"][i], tf32)
        return out
    return delta


@torch.no_grad()
def store_gap(c: dict, store: dict, seed: int, device, served: dict, count: int,
              control: bool = False) -> dict:
    """The worst leaf's ``||served - ref|| / ||ref||`` of the store's served
    rows ``served`` ({leaf: (m, ...)}, any device) at update count
    ``count``, against ``ref = mu^T M_count x0`` in float64. With
    ``control``, also the readings of the TF32 control (the reference's
    product with both operands rounded to TF32) and of two faults the
    reference plays: ``stale`` (a ring one iterate longer: the mix reads
    ``max_delay + 1`` updates back) and ``unmixed`` (``M_count x0`` served
    without the mix by ``mu^T``)."""
    mu = mixing.mixing(store)
    coef = {"store_rel": mixing.served_coefficients(mu, store["max_delay"], {count})[count]}
    if control:
        coef["fault_stale_store_rel"] = mixing.served_coefficients(
            mu, store["max_delay"] + 1, {count})[count]
        coef["fault_unmixed_store_rel"] = mixing.served_coefficients(
            mu, store["max_delay"], {count}, served=False)[count]
    mats = {k: torch.tensor(v, dtype=torch.float64, device=device) for k, v in coef.items()}
    ref_c = mats["store_rel"]
    worst = {k: 0.0 for k in mats}
    if control:
        worst["control_store_rel"] = 0.0
    for name, x0 in weights.adapters(c, store, seed, device).items():
        m = x0.shape[0]
        x = x0.reshape(m, -1)
        ref = torch.matmul(ref_c, x.double())
        norm = float(torch.linalg.vector_norm(ref))
        prog = served[name].to(device).reshape(m, -1).double()
        worst["store_rel"] = max(worst["store_rel"],
                                 float(torch.linalg.vector_norm(prog - ref)) / norm)
        del prog
        if control:
            for k, mat in mats.items():
                if k != "store_rel":
                    got = torch.matmul(mat, x.double())
                    worst[k] = max(worst[k], float(torch.linalg.vector_norm(got - ref)) / norm)
            got = torch.matmul(decoder.round_tf32(ref_c.float()).double(),
                               decoder.round_tf32(x).double())
            worst["control_store_rel"] = max(worst["control_store_rel"],
                                             float(torch.linalg.vector_norm(got - ref)) / norm)
        del ref, x, x0
    return worst
