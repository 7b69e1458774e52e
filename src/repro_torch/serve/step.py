"""The serving step pair: one dispatch per decode tick, one per (B, C)
prefill chunk. Counterpart of ``repro.serve.step.make_serve_step``.

Both front-ends (``ServeEngine`` and ``ContinuousBatcher``) call the two
functions built here, so their numerics cannot drift.

``make_serve_step(model, prefill_mode="parallel")`` returns:

  * ``decode_tick(tokens, task_ids, caches, positions, live)`` — advance
    EVERY slot one token at its own position ``positions[b]``. Dead slots
    (``live[b] == False``) run through the math on a padding token but
    their cache rows are left untouched. Returns (greedy next token, step
    logits, caches).

  * ``prefill_chunk(tokens, task_ids, caches, positions, valid, reset)`` —
    write a whole (B, C) prompt slice. ``valid[b, i]`` marks real prompt
    tokens as a contiguous prefix per row; ``reset[b]`` (host bool array)
    zeroes a (re)admitted slot's stripes before writing. Returns (logits
    after each slot's last valid token — zeros for rows with none, caches,
    ``positions + n_valid``).

``prefill_mode``: ``"parallel"`` (``model.prefill_step``: all C tokens in
one pass) or ``"scan"`` (C sequential ``decode_step`` calls — the oracle
the parallel path is held against, as in the JAX package).

The weights live in the model, so unlike the JAX pair these take no params
argument. Caches are updated in place and returned. The attention backend
rides on ``model.cfg.attn_backend``.
"""
from __future__ import annotations

import torch


def make_serve_step(model, prefill_mode: str = "parallel"):
    if prefill_mode not in ("parallel", "scan"):
        raise ValueError(
            f"prefill_mode must be 'parallel' or 'scan', got {prefill_mode!r}"
        )

    def decode_tick(tokens, task_ids, caches, positions, live):
        logits, caches = model.decode_step(
            {"tokens": tokens[:, None], "task_ids": task_ids}, caches, positions,
            live=live,
        )
        step_logits = logits[:, 0]  # (B, V) f32
        return step_logits.argmax(dim=-1), step_logits, caches

    def prefill_chunk_parallel(tokens, task_ids, caches, positions, valid, reset):
        caches = model.reset_slot_state(caches, reset)
        logits, caches = model.prefill_step(
            {"tokens": tokens, "task_ids": task_ids}, caches, positions, valid
        )
        n_valid = valid.sum(dim=1).to(positions.dtype)  # (B,)
        # slots with no valid token in this chunk report zeros
        last = torch.where((n_valid > 0)[:, None], logits[:, 0], 0.0)
        return last, caches, positions + n_valid

    def prefill_chunk_scan(tokens, task_ids, caches, positions, valid, reset):
        caches = model.reset_slot_state(caches, reset)
        last = None
        for i in range(tokens.shape[1]):
            vld = valid[:, i]
            logits, caches = model.decode_step(
                {"tokens": tokens[:, i : i + 1], "task_ids": task_ids}, caches,
                positions, live=vld,
            )
            step = logits[:, 0]
            last = torch.zeros_like(step) if last is None else last
            last = torch.where(vld[:, None], step, last)
            positions = positions + vld.to(positions.dtype)
        return last, caches, positions

    prefill = prefill_chunk_parallel if prefill_mode == "parallel" else prefill_chunk_scan
    return decode_tick, prefill
