"""Batched serving: a uniform-batch client of the serving core.

Counterpart of ``repro.serve.engine``. ``ServeEngine.generate`` takes a
batch of prompts and returns (B, num_tokens) generated ids. Each call builds
a FIFO, unchunked ``ContinuousBatcher`` (the parity-oracle configuration)
and submits one ``Request`` per row: admission prefills the prompts in
(num_slots, prefill_chunk) dispatches, then one decode dispatch per token.

``prompt_batch["tokens"]`` is a (B, S0) array, as in the JAX engine, or a
list of B 1-D prompts of different lengths (ragged batches served through
the same path); an audio model's is (B, S0, K) (or a list of (S0, K)
codebook rows) and the result (B, num_tokens, K). A VLM's batch may carry
``vision_embeds`` (B, S0, d_model) and ``vision_mask`` (B, S0) (or lists of
per-prompt arrays): each row's pair becomes its request's extras.

Pass ``paging`` (a ``repro_torch.serve.paging.PagingSpec``) to serve from
the paged block pool, and ``prefix_cache=True`` to put the radix prefix
cache in front of admission. With ``num_slots`` below the batch size the
requests run in admission waves, so later waves alias the prompt blocks
that earlier waves registered inside the same ``generate`` call;
``last_prefix_stats`` then holds that call's hit ratio, hit and lookup
tokens, ``cow_copies`` and computed ``prefill_tokens`` (None without the
prefix cache).

Sampling (``temperature > 0``) draws token ``t`` of request ``uid`` with a
``torch.Generator`` seeded from ``(seed, uid, t)``: a request's stream is a
pure function of its own logits, stable under scheduler reordering and slot
placement; an audio row draws one token per codebook from that generator.
It does not reproduce the JAX engine's PRNG bits.

``adapters`` (a ``repro_torch.serve.adapters.TaskAdapterStore``) serves
each row with its task's graph-mixed low-rank adapters; the store's
delayed updates run as the requests finish.

``cuda_graphs`` is passed to the call's batcher: ``None`` (the default)
runs each decode tick and prefill chunk as one CUDA-graph replay on a CUDA
model and eagerly on the CPU; ``False`` runs the eager step pair on any
device; ``True`` on the CPU raises. Each call captures the graphs of its
own batcher (they bind that batcher's caches) and releases them when it
returns.

``faults`` (a ``repro_torch.serve.faults.FaultPlan``) and ``preempt``
(paged only) are passed to the call's batcher: injected transient faults
retry transparently, and preemption swaps a lower-priority request out
under block pressure and restores it exactly. A request that ends failed
(a quarantined non-finite lane, or retries exhausted) makes ``generate``
raise ``RuntimeError``: a dense (B, num_tokens) array cannot hold a
partial result.

``generate(model, prompt_batch, num_tokens, max_seq, **kw)`` is the
module-level shorthand of the JAX package's: a ``ServeEngine(model,
max_seq)`` and its ``generate``. The port's weights live in the model, so
it takes no params argument.

``last_stats`` holds the dispatch counts, host seconds (``decode_s``,
``prefill_s``, and ``capture_s`` for the captures, which the other two do
not hold), graph captures, (paged) admission waits, swap-outs and
swap-ins, absorbed dispatch faults and quarantined requests of the last
``generate`` call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serve.batching import ContinuousBatcher, Request, check_adapters
from repro_torch.serve.paging import PagingSpec
from repro_torch.serve.step import use_cuda_graphs


def _request_generator(seed: int, uid: int, token_index: int) -> torch.Generator:
    """Per-draw generator: a pure function of (seed, request id, token
    index) — independent of batch position and scheduling order."""
    state = np.random.SeedSequence([seed, uid, token_index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def sample(row: np.ndarray, generator: torch.Generator, temperature: float):
    """Draw one token from softmax(row / temperature) (greedy at 0): an int
    for a (V,) row, a (K,) int32 array for an audio model's (K, V) row, one
    draw per codebook."""
    logits = torch.as_tensor(row, dtype=torch.float32)
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits / temperature, dim=-1)
        tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
        tok = tok.reshape(probs.shape[:-1])
    return int(tok) if tok.ndim == 0 else tok.numpy().astype(np.int32)


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
    paging: PagingSpec | None = None
    # paged only: serve through the radix prefix cache (refcounted block
    # sharing + copy-on-write; see repro_torch.serve.paging)
    prefix_cache: bool = False
    # optional repro_torch.serve.adapters.TaskAdapterStore: serve graph-mixed
    # per-task adapters gathered by each row's task id
    adapters: object = None
    # None: one CUDA-graph replay per step on a CUDA model, eager on the CPU
    cuda_graphs: bool | None = None
    # optional repro_torch.serve.faults.FaultPlan: inject scripted or
    # probabilistic faults at the executor's seams (None: no seam fires)
    faults: object = None
    # paged only: swap out lower-priority running requests under block
    # pressure instead of refusing admission
    preempt: bool = False

    def __post_init__(self):
        check_adapters(self.adapters, self.model)
        use_cuda_graphs(self.cuda_graphs, self.model.device)
        self.last_stats = None
        self.last_prefix_stats = None

    def generate(self, prompt_batch: dict, num_tokens: int, seed: int = 0,
                 temperature: float = 0.0, request_ids=None, on_token=None) -> np.ndarray:
        """prompt_batch: {"tokens": (B, S0) array or list of 1-D prompts
        ((B, S0, K) or (S0, K) rows for audio) [, "task_ids": (B,)] [, a
        VLM's "vision_embeds" and "vision_mask"]}. Returns the generated
        ids (B, num_tokens) ((B, num_tokens, K) for audio)."""
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
            on_token=stream, sample_fn=sample_fn, paging=self.paging,
            prefix_cache=self.prefix_cache, adapters=self.adapters,
            faults=self.faults, preempt=self.preempt, cuda_graphs=self.cuda_graphs,
        )
        vision = self.model.cfg.input_mode == "vlm" and "vision_embeds" in prompt_batch
        try:
            for i, uid in enumerate(uids):
                extras = None
                if vision:
                    extras = {
                        "vision_embeds": np.asarray(prompt_batch["vision_embeds"][i], np.float32),
                        "vision_mask": np.asarray(prompt_batch["vision_mask"][i], bool),
                    }
                batcher.submit(Request(
                    uid=uid, tokens=prompts[i], max_new=num_tokens, task_id=int(task_ids[i]),
                    extras=extras,
                ))
            finished = {r.uid: r for r in batcher.run()}
        finally:
            batcher.close()
        self.last_stats = {
            "decode_dispatches": batcher.decode_dispatches,
            "prefill_dispatches": batcher.prefill_dispatches,
            "prefill_tokens": batcher.prefill_tokens,
            "decode_s": batcher.decode_s,
            "prefill_s": batcher.prefill_s,
            "capture_s": batcher.capture_s,
            "captures": batcher.captures,
            "admission_waits": batcher.admission_waits,
            "swap_outs": batcher.swap_outs,
            "swap_ins": batcher.swap_ins,
            "dispatch_faults": batcher.dispatch_faults,
            "quarantined": batcher.quarantined,
        }
        self.last_prefix_stats = (
            {
                "hit_ratio": batcher.prefix.hit_ratio,
                "hit_tokens": batcher.prefix.hit_tokens,
                "lookup_tokens": batcher.prefix.lookup_tokens,
                "cow_copies": batcher.cow_copies,
                "prefill_tokens": batcher.prefill_tokens,
            }
            if batcher.prefix is not None
            else None
        )
        failed = [r for r in finished.values() if r.failed]
        if failed:
            # the uniform-batch contract returns a dense (B, num_tokens)
            # array, so partial failure cannot be represented
            raise RuntimeError(
                "request(s) failed during generation: "
                + "; ".join(f"uid {r.uid}: {r.error}" for r in failed)
            )
        return np.stack([np.asarray(finished[uid].out, np.int32) for uid in uids])


def generate(model, prompt_batch, num_tokens, max_seq, **kw) -> np.ndarray:
    """``ServeEngine(model, max_seq).generate(prompt_batch, num_tokens,
    **kw)``: greedy (or sampled) generation with the engine's defaults."""
    return ServeEngine(model, max_seq).generate(prompt_batch, num_tokens, **kw)
