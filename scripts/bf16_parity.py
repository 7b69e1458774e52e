"""Greedy bfloat16 parity of the port with the JAX package, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_parity.py

For the olmo_1b, qwen2_5_14b and multitask_lm smoke configs at bfloat16
(JAX weights from PRNGKey(0), carried across by repro_torch.convert), for
the port's SiLU as it is (``layers.silu``) and with ``F.silu`` patched in
(the form before the bf16 repair), and for JAX evaluated op by op
(``jax.disable_jit``, the reference of tests/test_torch_bf16.py) and
jitted (XLA's fusion, with ``--xla_allow_excess_precision`` as XLA_FLAGS
sets it; on by default), prints: the largest and mean absolute difference
of the ``forward`` logits (batch 4 x 32), and for 16 greedy tokens on each
of 4 prompts of 8 tokens (4 slots, prefill chunk 4) the tokens equal
position for position, and the JAX top-2 logit margin at each row's first
split. Takes about two minutes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro.configs import get as jax_get
from repro.models import TransformerLM as JaxLM
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import get
from repro_torch.convert import load_numpy_params
from repro_torch.models import TransformerLM
from repro_torch.models import layers
from repro_torch.serve import ContinuousBatcher, Request

ARCHS = ("olmo_1b", "qwen2_5_14b", "multitask_lm")
ROWS, PROMPT, NEW = 4, 8, 16


def models(arch):
    """(JAX model, bf16 params, the port's bf16 model with the same weights)."""
    jm = JaxLM(jax_get(arch, smoke=True), dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get(arch, smoke=True), attn_backend="plain")
    tm = TransformerLM(cfg, device="cpu", dtype=torch.bfloat16)
    return jm, params, load_numpy_params(tm, jax.tree.map(np.asarray, params))


def prompts(cfg):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (ROWS, PROMPT)).astype(np.int32)


def greedy(batcher_cls, req_cls, toks, num_tasks, *args):
    """Greedy tokens and each step's logits row: ({uid: tokens}, {(uid, step): row})."""
    rows = {}

    def keep(req, row):
        rows[(req.uid, len(req.out))] = np.asarray(row, np.float32).copy()
        return int(np.argmax(row))

    bt = batcher_cls(*args, num_slots=ROWS, max_seq=PROMPT + NEW, prefill_chunk=4,
                     sample_fn=keep)
    for i, t in enumerate(toks):
        bt.submit(req_cls(uid=i, tokens=t, max_new=NEW, task_id=i % num_tasks))
    return {r.uid: [int(x) for x in r.out] for r in bt.run()}, rows


def first_splits(want, got, rows):
    """Per row: (step of the first split or None, JAX's top-2 margin there)."""
    out = []
    for uid in sorted(want):
        split = next((t for t, (a, b) in enumerate(zip(want[uid], got[uid])) if a != b), None)
        margin = None
        if split is not None:
            top2 = np.sort(rows[(uid, split)])[-2:]
            margin = float(top2[1] - top2[0])
        out.append((split, margin))
    return out


def measure(arch, eager):
    jm, params, tm = models(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32),
             "task_ids": np.arange(4, dtype=np.int32) % cfg.num_tasks}
    toks = prompts(cfg)
    with jax.disable_jit() if eager else contextlib.nullcontext():
        jl, _ = jax.jit(jm.forward)(params, {k: jnp.asarray(v) for k, v in batch.items()})
        want, jrows = greedy(JaxBatcher, JaxRequest, toks, cfg.num_tasks, jm, params)
    with torch.no_grad():
        tl, _ = tm.forward({k: torch.from_numpy(v) for k, v in batch.items()})
    diff = np.abs(np.asarray(jl, np.float32) - tl.numpy())
    got, _ = greedy(ContinuousBatcher, Request, toks, cfg.num_tasks, tm)
    same = sum(a == b for u in want for a, b in zip(want[u], got[u]))
    return diff.max(), diff.mean(), same, first_splits(want, got, jrows)


def main() -> int:
    repaired = layers.silu
    for label, silu in (("repaired silu", repaired), ("F.silu", F.silu)):
        layers.silu = silu
        try:
            for arch, ref in [(a, r) for r in ("JAX eager", "JAX jit") for a in ARCHS]:
                dmax, dmean, same, splits = measure(arch, ref == "JAX eager")
                print(f"{label:13s} vs {ref:9s} {arch:13s} forward logits max|diff| "
                      f"{dmax:.4f} mean {dmean:.5f}; greedy tokens equal {same}/{ROWS * NEW}; first splits "
                      + ", ".join("none" if s is None else f"step {s} (JAX margin {m:.4f})"
                                  for s, m in splits))
        finally:
            layers.silu = repaired
    return 0


if __name__ == "__main__":
    sys.exit(main())
