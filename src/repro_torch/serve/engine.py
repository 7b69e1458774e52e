"""Batched serving: a uniform-batch client of the serving core.

Counterpart of ``repro.serve.engine``. ``ServeEngine.generate`` takes a
batch of prompts and returns (B, num_tokens) generated ids. Each call builds
a FIFO, unchunked ``ContinuousBatcher`` (the parity-oracle configuration)
and submits one ``Request`` per row: admission prefills the prompts in
(num_slots, prefill_chunk) dispatches, then one decode dispatch per token.

``prompt_batch["tokens"]`` is a (B, S0) array, as in the JAX engine, or a
list of B 1-D prompts of different lengths (ragged batches served through
the same path).

Sampling (``temperature > 0``) draws token ``t`` of request ``uid`` with a
``torch.Generator`` seeded from ``(seed, uid, t)``: a request's stream is a
pure function of its own logits, stable under scheduler reordering and slot
placement. It does not reproduce the JAX engine's PRNG bits.

``last_stats`` holds the dispatch counts and host seconds of the last
``generate`` call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serve.batching import ContinuousBatcher, Request, refuse_unported


def _request_generator(seed: int, uid: int, token_index: int) -> torch.Generator:
    """Per-draw generator: a pure function of (seed, request id, token
    index) — independent of batch position and scheduling order."""
    state = np.random.SeedSequence([seed, uid, token_index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def sample(row: np.ndarray, generator: torch.Generator, temperature: float) -> int:
    """Draw one token from softmax(row / temperature) (greedy at 0)."""
    logits = torch.as_tensor(row, dtype=torch.float32)
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    probs = torch.softmax(logits / temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator))


@dataclasses.dataclass
class ServeEngine:
    model: torch.nn.Module
    max_seq: int
    prefill_chunk: int = 32
    # "parallel" (one dispatch computes the whole chunk) or "scan" (the
    # per-token oracle) — see repro_torch.serve.step.make_serve_step
    prefill_mode: str = "parallel"
    # None sizes the batcher at one slot per prompt row; fewer slots serve
    # the batch in admission waves
    num_slots: int | None = None
    # later slices of the port; setting any of them raises
    paging: object = None
    adapters: object = None
    prefix_cache: bool = False
    faults: object = None
    preempt: bool = False

    def __post_init__(self):
        refuse_unported(paging=self.paging is not None, prefix_cache=self.prefix_cache,
                        adapters=self.adapters is not None,
                        faults=self.faults is not None, preempt=self.preempt)
        self.last_stats = None

    def generate(self, prompt_batch: dict, num_tokens: int, seed: int = 0,
                 temperature: float = 0.0, request_ids=None, on_token=None) -> np.ndarray:
        """prompt_batch: {"tokens": (B, S0) array or list of 1-D prompts
        [, "task_ids": (B,)]}. Returns the generated ids (B, num_tokens)."""
        prompts = [np.asarray(t, np.int32) for t in prompt_batch["tokens"]]
        b = len(prompts)
        longest = max(len(p) for p in prompts)
        if longest + num_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({longest}) + num_tokens ({num_tokens}) = "
                f"{longest + num_tokens} tokens exceeds the cache capacity "
                f"max_seq={self.max_seq}; the generation would be silently "
                "truncated"
            )
        uids = list(request_ids) if request_ids is not None else list(range(b))
        if len(uids) != b or len(set(uids)) != b:
            raise ValueError(f"request_ids must be {b} distinct ids, got {uids!r}")
        task_ids = np.asarray(prompt_batch.get("task_ids", np.zeros(b, np.int32)), np.int32)
        num_tasks = self.model.cfg.num_tasks
        bad = [int(t) for t in task_ids if not 0 <= t < num_tasks]
        if bad:
            raise ValueError(
                f"task_ids {bad} outside [0, {num_tasks}) — the model would "
                "silently clamp them to another task's parameters"
            )

        sample_fn = None
        if temperature > 0.0:
            def sample_fn(req, row):
                gen = _request_generator(seed, req.uid, len(req.out))
                return sample(row, gen, temperature)

        stream = None
        if on_token is not None:
            def stream(req, tok):
                on_token(req.uid, tok)

        slots = self.num_slots if self.num_slots is not None else b
        if slots <= 0:
            raise ValueError(f"num_slots must be positive, got {slots}")
        batcher = ContinuousBatcher(
            self.model, num_slots=slots, max_seq=self.max_seq,
            prefill_chunk=self.prefill_chunk, prefill_mode=self.prefill_mode,
            on_token=stream, sample_fn=sample_fn,
        )
        for i, uid in enumerate(uids):
            batcher.submit(Request(
                uid=uid, tokens=prompts[i], max_new=num_tokens, task_id=int(task_ids[i]),
            ))
        finished = {r.uid: r for r in batcher.run()}
        self.last_stats = {
            "decode_dispatches": batcher.decode_dispatches,
            "prefill_dispatches": batcher.prefill_dispatches,
            "prefill_tokens": batcher.prefill_tokens,
            "decode_s": batcher.decode_s,
            "prefill_s": batcher.prefill_s,
        }
        return np.stack([np.asarray(finished[uid].out, np.int32) for uid in uids])
