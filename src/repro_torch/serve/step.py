"""The serving step pair: one dispatch per decode tick, one per (B, C)
prefill chunk. Counterpart of ``repro.serve.step.make_serve_step``.

Both front-ends (``ServeEngine`` and ``ContinuousBatcher``) call the two
functions built here, so their numerics cannot drift.

``make_serve_step(model, prefill_mode="parallel", paging=None)`` returns:

  * ``decode_tick(tokens, task_ids, caches, positions, live,
    block_tables=None, adapters=None)`` — advance
    EVERY slot one token at its own position ``positions[b]``. Dead slots
    (``live[b] == False``) run through the math on a padding token but
    their cache rows are left untouched. Returns (greedy next token, step
    logits, caches).

  * ``prefill_chunk(tokens, task_ids, caches, positions, valid, reset,
    block_tables=None, adapters=None)`` — write a whole (B, C) prompt slice.
    ``valid[b, i]`` marks real prompt tokens as a contiguous prefix per
    row; ``reset[b]`` (host bool array) zeroes a (re)admitted slot's dense
    stripes before writing (paged pools need no reset). Returns (logits
    after each slot's last valid token — zeros for rows with none, caches,
    ``positions + n_valid``).

``prefill_mode``: ``"parallel"`` (``model.prefill_step``: all C tokens in
one pass) or ``"scan"`` (C sequential ``decode_step`` calls — the oracle
the parallel path is held against, as in the JAX package).

With ``paging`` (a ``repro_torch.serve.paging.PagingSpec``) the caches are
the shared pools of ``model.init_cache(..., paging=spec)`` and every call
takes the (B, max_blocks) int32 ``block_tables`` of the slots, one device
tensor per dispatch shared by every layer. ``adapters`` is the serving tree
of a ``repro_torch.serve.adapters.TaskAdapterStore`` (per-task low-rank
deltas gathered by ``task_ids``), or None.

``make_cow_copy(paging)`` returns the copy-on-write step of the prefix
cache: rows ``[0, rows)`` of block ``src`` into block ``dst`` in every pool.

The weights live in the model, so unlike the JAX pair these take no params
argument. Caches are updated in place and returned. The attention backend
rides on ``model.cfg.attn_backend``.
"""
from __future__ import annotations

import torch


def make_serve_step(model, prefill_mode: str = "parallel", paging=None):
    if prefill_mode not in ("parallel", "scan"):
        raise ValueError(
            f"prefill_mode must be 'parallel' or 'scan', got {prefill_mode!r}"
        )

    def decode_tick(tokens, task_ids, caches, positions, live, block_tables=None,
                    adapters=None):
        logits, caches = model.decode_step(
            {"tokens": tokens[:, None], "task_ids": task_ids}, caches, positions,
            live=live, block_tables=block_tables, adapters=adapters,
        )
        step_logits = logits[:, 0]  # (B, V) f32
        return step_logits.argmax(dim=-1), step_logits, caches

    def prefill_chunk_parallel(tokens, task_ids, caches, positions, valid, reset,
                               block_tables=None, adapters=None):
        caches = model.reset_slot_state(caches, reset, paging)
        logits, caches = model.prefill_step(
            {"tokens": tokens, "task_ids": task_ids}, caches, positions, valid,
            block_tables=block_tables, adapters=adapters,
        )
        n_valid = valid.sum(dim=1).to(positions.dtype)  # (B,)
        # slots with no valid token in this chunk report zeros
        last = torch.where((n_valid > 0)[:, None], logits[:, 0], 0.0)
        return last, caches, positions + n_valid

    def prefill_chunk_scan(tokens, task_ids, caches, positions, valid, reset,
                           block_tables=None, adapters=None):
        caches = model.reset_slot_state(caches, reset, paging)
        last = None
        for i in range(tokens.shape[1]):
            vld = valid[:, i]
            logits, caches = model.decode_step(
                {"tokens": tokens[:, i : i + 1], "task_ids": task_ids}, caches,
                positions, live=vld, block_tables=block_tables, adapters=adapters,
            )
            step = logits[:, 0]
            last = torch.zeros_like(step) if last is None else last
            last = torch.where(vld[:, None], step, last)
            positions = positions + vld.to(positions.dtype)
        return last, caches, positions

    prefill = prefill_chunk_parallel if prefill_mode == "parallel" else prefill_chunk_scan
    return decode_tick, prefill


def make_cow_copy(paging):
    """The copy-on-write step of the prefix cache.

    Returns ``cow_copy(caches, src, dst, rows)``: copy rows ``[0, rows)`` of
    physical block ``src`` into block ``dst`` of every pool tensor, IN
    PLACE — one slice copy per pool, no host sync, nothing else of the pool
    touched. ``src``, ``dst`` and ``rows`` are host ints (the admission
    decision). Used when a request's prompt shares only the first ``rows``
    tokens of a cached block: the new slot gets a private copy of those
    rows and writes its own tail there, never into the aliased source."""
    if paging is None:
        raise ValueError("copy-on-write requires a paged cache layout")
    nb, bs = paging.num_blocks, paging.block_size

    def cow_copy(caches, src: int, dst: int, rows: int):
        if not (0 <= src < nb and 0 <= dst < nb and src != dst and 0 <= rows <= bs):
            raise ValueError(
                f"copy-on-write of rows [0, {rows}) from block {src} to block {dst}: "
                f"want distinct blocks in [0, {nb}) and rows in [0, {bs}]"
            )
        for k_pool, v_pool in caches:
            k_pool[dst, :rows].copy_(k_pool[src, :rows])
            v_pool[dst, :rows].copy_(v_pool[src, :rows])
        return caches

    return cow_copy
