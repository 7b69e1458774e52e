"""Serving executor: wires scheduler decisions into the serving step pair.

Counterpart of ``repro.serve.batching`` for the dense and the paged KV
cache. ``ContinuousBatcher`` is the EXECUTOR layer of the serving core:

  * ``repro_torch.serve.slots.SlotMap`` — slot/position/live bookkeeping,
  * ``repro_torch.serve.scheduler.Scheduler`` — queue, admission policies
    (fifo/sjf/priority), the per-tick prefill token budget, deadlines,
  * this module — the only layer that touches device state: the per-layer
    K/V caches, the ``BlockAllocator`` + block tables (paged mode), and the
    functions from ``repro_torch.serve.step``.

Two execution regimes, selected by ``chunk_budget``:

  * ``chunk_budget=None`` (default) — admission prefills whole prompts
    immediately in (num_slots, C) dispatches, then one decode dispatch per
    tick advances every live slot. With ``policy="fifo"`` this is the
    parity-oracle configuration ``ServeEngine`` uses.
  * ``chunk_budget=N`` — every tick issues ONE fused prefill dispatch in
    which decoding slots advance one token each (a single-valid-token
    chunk row) AND mid-prompt slots prefill at most N prompt tokens in
    total, policy-ordered.

Emission hooks: ``on_token(request, token)`` streams every generated token
the tick it is produced; ``sample_fn(request, logits_row)`` replaces greedy
argmax (a numpy f32 row). Requests can be cancelled mid-flight
(``cancel(uid)``) or expire via ``Request.timeout_s``; both free the slot
immediately and land in ``finished`` with ``cancelled`` / ``timed_out`` set
and ``done`` False.

Every dispatch goes through the batcher's ``repro_torch.serve.step.
StepExecutor``: its inputs are packed into one int32 buffer and uploaded in
one copy, the step runs, and its int32 results come back in one copy, which
waits for the device. With ``cuda_graphs`` on (``None``, the default, means
on for a CUDA model; the CPU cannot capture, and ``True`` there raises) the
step is ONE CUDA-graph replay, captured at the batcher's first decode and
first prefill dispatch; ``cuda_graphs=False`` runs the same buffers through
the eager step pair, the counterpart of ``jax.disable_jit``. A failed
capture or replay raises; nothing falls back to the eager pair.

``decode_dispatches`` / ``prefill_dispatches`` / ``mixed_dispatches`` /
``ticks`` count real step calls; ``decode_s`` / ``prefill_s`` are host
seconds spent in the decode and (unchunked) prefill dispatches, from the
packing of the inputs to the read-back of the results (the sampler's logits
rows included), and ``capture_s`` the host seconds of the graph captures
(each with its warm-up), which neither of the other two holds.

Paged mode (pass a ``repro_torch.serve.paging.PagingSpec``): admission
reserves ``ceil((len(prompt) + max_new) / block_size)`` blocks for the
request's lifetime (allocator backpressure queues requests that cannot get
them; ``admission_waits`` counts the rounds that stopped on blocks) and
every retirement path — finish, cancel, timeout — returns them. The
(num_slots, max_blocks) int32 table rides in each dispatch's one upload,
shared by every layer.

``prefix_cache=True`` (paged mode) puts a
``repro_torch.serve.paging.RadixPrefixCache`` in front of admission: a
request whose prompt shares a cached prefix aliases those blocks
(refcounted) instead of recomputing them, prefill starts at
``cached_tokens``, a partially shared boundary block is copy-on-written in
one step (``serve.step.make_cow_copy``, counted by ``cow_copies``), a
prompt's full blocks are registered once its prefill completes, and
retirement releases (decrefs) instead of freeing. Greedy outputs equal the
no-sharing path's.

``adapters`` (a ``repro_torch.serve.adapters.TaskAdapterStore`` over the
model's ``num_tasks``) serves graph-mixed per-task low-rank adapters: every
dispatch gathers each row's deltas from ``adapters.serving`` by task id
(free and dead lanes carry the null id ``num_tasks``, the tree's zero row),
and every finished request is streamed into the store's delayed-update
loop (``note_request``) after its slot's blocks are freed.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: fault injection (``faults``) and preemptive swap-out
(``preempt``) — later slices of the port.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.serve.paging import BlockAllocator, RadixPrefixCache
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.slots import SlotMap
from repro_torch.serve.step import StepExecutor, make_cow_copy

_LATER_SLICES = {
    "faults": "fault injection",
    "preempt": "preemptive swap-out",
}


def refuse_unported(**options) -> None:
    """Raise for any option of a later slice of the port that is set."""
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name}=: {_LATER_SLICES[name]} is not ported to repro_torch "
                "yet (a later slice of the port; see ROADMAP.md)"
            )


def check_adapters(adapters, model) -> None:
    """Reject an adapter store built for another task count than the
    model's (its rows would be gathered by the wrong ids)."""
    if adapters is not None and adapters.num_tasks != model.cfg.num_tasks:
        raise ValueError(
            f"adapter store serves {adapters.num_tasks} tasks but the model has "
            f"num_tasks={model.cfg.num_tasks}"
        )


class TickBudgetExceeded(RuntimeError):
    """``run(max_ticks)`` spent its budget with requests still unfinished.

    The unfinished requests are flagged ``timed_out`` and remain queued /
    in-flight; pass ``on_exhausted="flag"`` to get partial results back
    instead of this exception."""


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray  # (S0,) prompt
    max_new: int
    task_id: int = 0
    # scheduling: lower priority value runs first under policy="priority";
    # timeout_s expires the request that many seconds after submit()
    priority: int = 0
    timeout_s: float | None = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # finished before emitting max_new tokens (slot capacity hit); submit()
    # validates the budget, so this stays False through the public API
    truncated: bool = False
    # retirement flags; a flagged request is never done
    cancelled: bool = False
    timed_out: bool = False
    # bookkeeping stamped by the scheduler/executor
    submit_time: float | None = None
    prompt_done: int = 0  # prompt tokens already written to the cache
    cached_tokens: int = 0  # prompt tokens served from the prefix cache
    _arrival: int = 0

    @property
    def prefill_remaining(self) -> int:
        return len(self.tokens) - self.prompt_done


class ContinuousBatcher:
    """Slot-based continuous batching executor (one dispatch per tick)."""

    def __init__(
        self,
        model,
        num_slots: int,
        max_seq: int,
        prefill_chunk: int = 16,
        prefill_mode: str = "parallel",
        policy: str = "fifo",
        chunk_budget: int | None = None,
        now_fn=None,
        on_token=None,
        sample_fn=None,
        paging=None,
        prefix_cache: bool = False,
        adapters=None,
        faults=None,
        preempt: bool = False,
        cuda_graphs: bool | None = None,
    ):
        refuse_unported(faults=faults is not None, preempt=preempt)
        check_adapters(adapters, model)
        self.model = model
        self.adapters = adapters
        self.device = model.device
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.paging = paging
        self.on_token = on_token
        self.sample_fn = sample_fn
        # dead/free lanes carry the task id num_tasks: the adapter serving
        # tree's zero null row, and one past the model's task tables (the
        # model clamps it; those lanes' outputs are discarded)
        self._null_task = model.cfg.num_tasks
        self.scheduler = Scheduler(policy=policy, chunk_budget=chunk_budget, now_fn=now_fn)
        self.slots = SlotMap(num_slots)
        if paging is not None:
            # a slot's logical length is bounded by BOTH max_seq and its
            # block-table capacity
            self.slot_capacity = min(max_seq, paging.tokens_per_slot)
            self.allocator = BlockAllocator(paging)
            self.block_tables = np.zeros((num_slots, paging.max_blocks_per_slot), np.int32)
            self.slot_blocks: list[list[int]] = [[] for _ in range(num_slots)]
        else:
            self.slot_capacity = max_seq
        self.prefix = None
        self._cow_fn = None
        if prefix_cache:
            if paging is None:
                raise ValueError(
                    "prefix_cache=True requires a paged cache layout (pass a "
                    "PagingSpec) — dense per-slot stripes cannot alias blocks "
                    "between slots"
                )
            # the port's model is attention-only (pattern ("attn",)): no
            # recurrent state lives outside the KV blocks
            prefix = self.prefix = RadixPrefixCache(self.allocator)
            self._cow_fn = make_cow_copy(paging)
            # sjf orders by UNCACHED prompt tokens: a long prompt with a
            # resident prefix is a short job (the closure holds the cache,
            # not the batcher, so the batcher and its caches are freed
            # without waiting for the cycle collector)
            self.scheduler.cost_fn = lambda r: (
                len(r.tokens) - prefix.match(r.task_id, r.tokens).tokens
            )
        self.caches = model.init_cache(num_slots, max_seq, paging)
        self.finished: list[Request] = []
        self.ticks = 0
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.mixed_dispatches = 0  # fused prefill+decode (chunk_budget mode)
        self.cow_copies = 0  # copy-on-write steps (prefix-cache mode)
        self.admission_waits = 0  # admission rounds stopped on KV blocks (paged)
        self.prefill_tokens = 0  # prompt tokens computed
        self.decode_s = self.prefill_s = 0.0
        self._needs_reset: set[int] = set()  # fresh slots awaiting reset
        self._steps = StepExecutor(model, self.caches, num_slots, prefill_chunk,
                                   prefill_mode, paging, cuda_graphs)

    # --------------------------------------------------- bookkeeping views
    @property
    def queue(self) -> list[Request]:
        return self.scheduler.queue

    @property
    def pos(self) -> np.ndarray:
        return self.slots.pos

    @property
    def capture_s(self) -> float:
        """Host seconds spent capturing the step pair's CUDA graphs."""
        return self._steps.capture_s

    @property
    def captures(self) -> int:
        """CUDA graphs captured (each after one warm-up run of its step)."""
        return self._steps.captures

    def _block_tables(self):
        """The slots' (num_slots, max_blocks) block tables, which the
        executor writes into its static table before each dispatch, or None
        (dense)."""
        return self.block_tables if self.paging is not None else None

    def _adapter_tree(self):
        """The store's current serving tree (republished by its updates
        between dispatches), or None."""
        return self.adapters.serving if self.adapters is not None else None

    # ------------------------------------------------------------- plumbing
    def submit(self, req: Request):
        """Validate a request BEFORE it can occupy a slot: reject empty
        prompts, out-of-range task ids and prompt + max_new budgets that
        cannot fit a slot (which would otherwise be silently truncated)."""
        n = len(req.tokens)
        if n == 0:
            raise ValueError(
                f"request {req.uid}: empty prompt — at least one prompt "
                "token is required to produce the first logits"
            )
        if not 0 <= req.task_id < self.model.cfg.num_tasks:
            raise ValueError(
                f"request {req.uid}: task_id {req.task_id} outside "
                f"[0, {self.model.cfg.num_tasks}) — out-of-range ids would "
                "silently clamp to another task's parameters"
            )
        total = n + req.max_new
        if total > self.slot_capacity:
            detail = (
                f"max_seq={self.max_seq}"
                if self.paging is None
                else f"min(max_seq={self.max_seq}, {self.paging.max_blocks_per_slot} "
                f"blocks x {self.paging.block_size})"
            )
            raise ValueError(
                f"request {req.uid}: prompt ({n}) + max_new ({req.max_new}) "
                f"= {total} tokens exceeds the per-slot capacity "
                f"{self.slot_capacity} ({detail}); it would be silently truncated"
            )
        if self.paging is not None:
            needed = self.paging.blocks_for(total)
            if needed > self.paging.num_blocks - 1:
                raise ValueError(
                    f"request {req.uid}: needs {needed} KV blocks but the pool "
                    f"only has {self.paging.num_blocks - 1} allocatable blocks — "
                    "it could never be admitted"
                )
        self.scheduler.submit(req)

    # ------------------------------------------------------ paged blocks
    def _set_table(self, s: int, blocks: list[int]) -> None:
        self.slot_blocks[s] = list(blocks)
        self.block_tables[s, :] = 0
        self.block_tables[s, : len(blocks)] = blocks

    def _free_slot_blocks(self, s: int):
        if self.paging is not None and self.slot_blocks[s]:
            if self.prefix is not None:
                # decref, not free: blocks registered in the prefix trie
                # stay resident (cached-idle, LRU-evictable) for future
                # hits; unregistered ones return to the free list
                self.prefix.release(self.slot_blocks[s])
            else:
                self.allocator.free(self.slot_blocks[s])
            self.slot_blocks[s] = []
            self.block_tables[s, :] = 0

    def _register_prefix(self, s: int, req: Request):
        """Insert a COMPLETELY prefilled prompt's full blocks into the
        prefix trie (only final KV values are ever aliasable)."""
        if self.prefix is not None and req.prefill_remaining == 0:
            self.prefix.insert(req.task_id, req.tokens, self.slot_blocks[s])

    def _try_bind(self, s: int, req: Request) -> bool:
        """Scheduler placement callback: reserve the request's blocks for
        its whole lifetime and bind the slot — or report backpressure
        (False stops admission for this round)."""
        if self.paging is None:
            self.slots.bind(s, req)
            return True
        needed = self.paging.blocks_for(len(req.tokens) + req.max_new)
        if self.prefix is not None:
            bound = self._bind_prefix(s, req, needed)
        elif self.allocator.can_alloc(needed):
            self._set_table(s, self.allocator.alloc(needed))
            self.slots.bind(s, req)
            bound = True
        else:
            bound = False  # wait for finishing requests' blocks
        if not bound:
            self.admission_waits += 1
        return bound

    def _bind_prefix(self, s: int, req: Request, needed: int) -> bool:
        """Prefix-cache admission: alias the cached chain, copy-on-write
        the partially shared boundary block, bind at ``cached_tokens``."""
        admit = self.prefix.admit(req.task_id, req.tokens, needed)
        if admit is None:
            return False  # truly out of live + unreclaimable memory
        if admit.cow is not None:
            # the boundary block is only partially shared: copy the shared
            # rows into the slot's private block. The source stays pinned
            # (increfed) across the copy; the pin drops whatever happens
            src, dst, rows = admit.cow
            try:
                self.caches = self._cow_fn(self.caches, src, dst, rows)
                self.cow_copies += 1
            except BaseException:
                self.prefix.release(list(admit.blocks))
                raise
            finally:
                self.prefix.release([src])
        self._set_table(s, admit.blocks)
        # prefill resumes after the cached prefix
        req.prompt_done = admit.cached_tokens
        req.cached_tokens = admit.cached_tokens
        self.slots.bind(s, req, pos=admit.cached_tokens)
        return True

    # ------------------------------------------------------------- emission
    def _emit(self, req: Request, row=None, greedy=None):
        """Append one generated token (greedy argmax or the pluggable
        sampler) and stream it."""
        tok = int(self.sample_fn(req, row) if self.sample_fn is not None else greedy)
        req.out.append(tok)
        if self.on_token is not None:
            self.on_token(req, tok)

    def _rows(self, logits: torch.Tensor):
        """A dispatch's logits rows on the host, only when a sampler needs
        them (the greedy argmax runs on the device: first maximal index,
        like np.argmax). Read at once: the next replay overwrites them."""
        return logits.cpu().numpy() if self.sample_fn is not None else None

    def _finish_ready(self):
        for s, req in self.slots.live_items():
            # pos is the NEXT write position: the slot is exhausted only
            # when pos == capacity
            if len(req.out) >= req.max_new or self.pos[s] >= self.slot_capacity:
                req.done = True
                req.truncated = len(req.out) < req.max_new
                self.finished.append(req)
                # blocks before the binding: an unbound slot must never
                # still hold blocks
                self._free_slot_blocks(s)
                self.slots.release(s)  # state cleared on re-admission
                if self.adapters is not None:
                    # the finish feeds the store's delayed-update loop
                    # (host side, between dispatches)
                    self.adapters.note_request(req)

    # --------------------------------------------------- retirement paths
    def cancel(self, uid) -> bool:
        """Cancel a request by uid, queued or mid-flight. Frees its slot
        and paged blocks immediately; the request lands in ``finished``
        with ``cancelled=True`` and never emits another token. Returns
        False if no such request is queued or in flight."""
        req = self.scheduler.cancel(uid)
        if req is None:
            s = self.slots.slot_of(uid)
            if s is None:
                return False
            self._free_slot_blocks(s)
            req = self.slots.release(s)
        req.cancelled = True
        self.finished.append(req)
        return True

    def _retire_expired(self):
        """Release requests past their ``timeout_s`` deadline — queued or
        mid-flight — freeing slots and paged blocks."""
        if not any(
            r.timeout_s is not None
            for r in self.scheduler.queue + self.slots.reqs
            if r is not None
        ):
            return
        dead_queued, dead_live = self.scheduler.expired(
            self.scheduler.now(), self.slots.live_items()
        )
        for req in dead_queued:
            req.timed_out = True
            self.finished.append(req)
        for s, req in dead_live:
            self._free_slot_blocks(s)
            self.slots.release(s)
            req.timed_out = True
            self.finished.append(req)

    # ------------------------------------------------- legacy (gulp) prefill
    def _admit(self):
        """Fill free slots in scheduler policy order, then (unchunked mode)
        prefill ALL newly admitted prompts together in chunked dispatches.
        Paged mode reserves each request's blocks here; when they cannot
        be had, admission stops until finishing requests release blocks."""
        admitted = self.scheduler.admit(self.slots.free_slots(), self._try_bind)
        newly = [s for s, _ in admitted]
        self._needs_reset |= set(newly)
        if self.scheduler.chunk_budget is None and newly:
            self._prefill_full(sorted(newly))
        return newly

    def _prefill_full(self, targets: list[int]):
        """Run every target slot's prompt to completion in (num_slots, C)
        dispatches, emitting each request's first generated token the
        dispatch its prefill completes. Each slot prefills from its own
        cursor (``prompt_done``: 0, or ``cached_tokens`` after a prefix
        hit), so a resident prefix costs no dispatch."""
        task_ids = self.slots.task_ids(self._null_task)
        tree = self._adapter_tree()
        c = self.prefill_chunk
        while True:
            pending = [
                s for s in targets
                if self.slots.reqs[s] is not None
                and self.slots.reqs[s].prefill_remaining > 0
            ]
            if not pending:
                break
            tokens = np.zeros((self.num_slots, c), np.int32)
            valid = np.zeros((self.num_slots, c), bool)
            reset = np.zeros(self.num_slots, bool)
            for s in pending:
                req = self.slots.reqs[s]
                reset[s] = s in self._needs_reset
                d = req.prompt_done
                t = np.asarray(req.tokens, np.int32)[d : d + c]
                tokens[s, : len(t)] = t
                valid[s, : len(t)] = True
            self._steps.prepare("prefill", tree)  # capture_s, not prefill_s
            t0 = time.perf_counter()
            greedy, last, positions = self._steps.prefill(
                tokens, task_ids, self.pos, valid, reset, self._block_tables(), tree,
            )
            rows = self._rows(last)
            self.prefill_s += time.perf_counter() - t0
            self.prefill_dispatches += 1
            self.prefill_tokens += int(valid.sum())
            self._needs_reset -= set(pending)
            self.slots.set_positions(positions)
            completed = []
            for s in pending:
                req = self.slots.reqs[s]
                if req is None:  # cancelled from a streaming callback
                    continue
                req.prompt_done += int(valid[s].sum())
                if req.prefill_remaining == 0:
                    completed.append((s, req))
            # the logits after each prompt's LAST token give the first
            # generated token: emit it the dispatch it appears (prefix
            # matching is capped at len(prompt) - 1, so every completing
            # slot computed at least its last prompt token here)
            for s, req in completed:
                if self.slots.reqs[s] is not req:  # cancelled
                    continue
                self._register_prefix(s, req)
                if not req.out:
                    self._emit(req, row=None if rows is None else rows[s],
                               greedy=greedy[s])

    def tick(self):
        """Advance every live slot one token — exactly ONE decode dispatch
        regardless of how many slots are live or at which positions."""
        live = self.slots.live()
        if not live.any():
            return
        tokens = np.zeros(self.num_slots, np.int32)
        for s, req in self.slots.live_items():
            tokens[s] = req.out[-1] if req.out else np.asarray(req.tokens)[-1]
        tree = self._adapter_tree()
        self._steps.prepare("decode", tree)  # capture_s, not decode_s
        t0 = time.perf_counter()
        greedy, step_logits = self._steps.decode(
            tokens, self.slots.task_ids(self._null_task), self.pos, live,
            self._block_tables(), tree,
        )
        rows = self._rows(step_logits)
        self.decode_s += time.perf_counter() - t0
        self.ticks += 1
        self.decode_dispatches += 1
        self.slots.advance_live()
        for s, req in self.slots.live_items():
            self._emit(req, row=None if rows is None else rows[s], greedy=greedy[s])

    # ------------------------------------- SLA mode: fused prefill + decode
    def _interleaved_tick(self):
        """ONE fused dispatch: decoding slots advance one token AND
        mid-prompt slots prefill their scheduler-budgeted chunk, riding the
        same (num_slots, C) slab under per-row validity."""
        prefilling = [
            (s, r, r.prefill_remaining)
            for s, r in self.slots.live_items()
            if r.prefill_remaining > 0
        ]
        decoding = [
            (s, r) for s, r in self.slots.live_items() if r.prefill_remaining == 0
        ]
        if not prefilling and not decoding:
            return
        c = self.prefill_chunk
        plan = self.scheduler.plan_prefill(prefilling, c)
        tokens = np.zeros((self.num_slots, c), np.int32)
        valid = np.zeros((self.num_slots, c), bool)
        reset = np.zeros(self.num_slots, bool)
        for s, n in plan:
            req = self.slots.reqs[s]
            d = req.prompt_done
            tokens[s, :n] = np.asarray(req.tokens, np.int32)[d : d + n]
            valid[s, :n] = True
            reset[s] = d == 0
        for s, req in decoding:
            tokens[s, 0] = req.out[-1] if req.out else np.asarray(req.tokens)[-1]
            valid[s, 0] = True
        greedy, last, positions = self._steps.prefill(
            tokens, self.slots.task_ids(self._null_task), self.pos, valid, reset,
            self._block_tables(), self._adapter_tree(),
        )
        rows = self._rows(last)
        self.ticks += 1
        self.mixed_dispatches += 1
        self.prefill_tokens += sum(n for _, n in plan)
        self.slots.set_positions(positions)
        completed = []
        for s, n in plan:
            req = self.slots.reqs[s]
            if req is None:  # cancelled from a streaming callback mid-round
                continue
            req.prompt_done += n
            if req.prefill_remaining == 0:
                completed.append((s, req))
        for s, req in completed:
            if self.slots.reqs[s] is req:  # not cancelled mid-round
                self._register_prefix(s, req)
        for s, req in completed + decoding:
            if self.slots.reqs[s] is req:  # not cancelled mid-round
                self._emit(req, row=None if rows is None else rows[s], greedy=greedy[s])

    # ------------------------------------------------------------ driving
    def capture(self) -> None:
        """Capture both steps now, as the first decode and the first
        prefill dispatch would (no-op without CUDA graphs)."""
        tree = self._adapter_tree()
        self._steps.prepare("prefill", tree)
        self._steps.prepare("decode", tree)

    def close(self) -> None:
        """Release the step pair's CUDA graphs and their memory pool (a
        later dispatch captures again)."""
        self._steps.close()

    def step(self):
        """One scheduling round: retire expired requests, admit from the
        queue, then advance — the admit-gulp + decode tick when
        ``chunk_budget`` is None, or one fused interleaved dispatch."""
        self._retire_expired()
        self._admit()
        if self.scheduler.chunk_budget is None:
            self._finish_ready()  # prefill alone may satisfy max_new
            if self.slots.any_live():
                self.tick()
        else:
            self._interleaved_tick()
        self._finish_ready()

    def _pending(self) -> bool:
        return bool(self.scheduler.queue) or self.slots.any_live()

    def run(self, max_ticks: int = 10_000, on_exhausted: str = "raise"):
        """Drive until all submitted requests finish (or this call has spent
        ``max_ticks`` ticks). On exhaustion every unfinished request is
        flagged ``timed_out``; ``on_exhausted="raise"`` (default) raises
        ``TickBudgetExceeded``, ``"flag"`` returns the finished list."""
        if on_exhausted not in ("raise", "flag"):
            raise ValueError(
                f"on_exhausted must be 'raise' or 'flag', got {on_exhausted!r}"
            )
        start = self.ticks
        stalled = 0
        exhausted = False
        while self._pending():
            if self.ticks - start + stalled >= max_ticks:
                self._retire_expired()
                exhausted = self._pending()
                break
            before = (self.ticks, self.prefill_tokens, len(self.finished))
            self.step()
            if (self.ticks, self.prefill_tokens, len(self.finished)) == before:
                stalled += 1  # a round that advanced nothing burns budget too
        if exhausted:
            unfinished = [r for _, r in self.slots.live_items()]
            unfinished += list(self.scheduler.queue)
            for r in unfinished:
                r.timed_out = True
            if on_exhausted == "raise":
                raise TickBudgetExceeded(
                    f"run(max_ticks={max_ticks}) exhausted its tick budget "
                    f"with {len(unfinished)} unfinished request(s) "
                    f"(uids {[r.uid for r in unfinished]}); they are flagged "
                    "Request.timed_out — pass on_exhausted='flag' to get "
                    "partial results instead of this exception"
                )
        return self.finished
