"""Serving executor: wires scheduler decisions into the serving step pair.

Counterpart of ``repro.serve.batching`` for the dense KV cache.
``ContinuousBatcher`` is the EXECUTOR layer of the serving core:

  * ``repro_torch.serve.slots.SlotMap`` — slot/position/live bookkeeping,
  * ``repro_torch.serve.scheduler.Scheduler`` — queue, admission policies
    (fifo/sjf/priority), the per-tick prefill token budget, deadlines,
  * this module — the only layer that touches device state: the per-layer
    K/V caches and the two functions from ``repro_torch.serve.step``.

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

``decode_dispatches`` / ``prefill_dispatches`` / ``mixed_dispatches`` /
``ticks`` count real step calls; ``decode_s`` / ``prefill_s`` are host
seconds spent in the decode and (unchunked) prefill dispatches, each ending
in the copy of its results to the host (which waits for the device).

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: the paged cache (``paging``), the prefix cache
(``prefix_cache``), graph-mixed task adapters (``adapters``), fault
injection (``faults``) and preemptive swap-out (``preempt``) — later
slices of the port.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.slots import SlotMap
from repro_torch.serve.step import make_serve_step

_LATER_SLICES = {
    "paging": "the paged KV cache",
    "prefix_cache": "the prefix cache",
    "adapters": "graph-mixed task adapters",
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
    ):
        refuse_unported(paging=paging is not None, prefix_cache=prefix_cache,
                        adapters=adapters is not None, faults=faults is not None,
                        preempt=preempt)
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.slot_capacity = max_seq
        self.prefill_chunk = prefill_chunk
        self.on_token = on_token
        self.sample_fn = sample_fn
        # dead/free lanes carry the task id num_tasks, one past the task
        # tables; the model clamps it and their outputs are discarded
        self._null_task = model.cfg.num_tasks
        self.scheduler = Scheduler(policy=policy, chunk_budget=chunk_budget, now_fn=now_fn)
        self.slots = SlotMap(num_slots)
        self.caches = model.init_cache(num_slots, max_seq)
        self.finished: list[Request] = []
        self.ticks = 0
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.mixed_dispatches = 0  # fused prefill+decode (chunk_budget mode)
        self.prefill_tokens = 0  # prompt tokens computed
        self.decode_s = self.prefill_s = 0.0
        self._needs_reset: set[int] = set()  # fresh slots awaiting reset
        self._tick_fn, self._prefill_fn = make_serve_step(model, prefill_mode)

    # --------------------------------------------------- bookkeeping views
    @property
    def queue(self) -> list[Request]:
        return self.scheduler.queue

    @property
    def pos(self) -> np.ndarray:
        return self.slots.pos

    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

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
            raise ValueError(
                f"request {req.uid}: prompt ({n}) + max_new ({req.max_new}) "
                f"= {total} tokens exceeds the per-slot capacity "
                f"{self.slot_capacity} (max_seq={self.max_seq}); it would be "
                "silently truncated"
            )
        self.scheduler.submit(req)

    def _try_bind(self, s: int, req: Request) -> bool:
        self.slots.bind(s, req)
        return True

    # ------------------------------------------------------------- emission
    def _emit(self, req: Request, row=None, greedy=None):
        """Append one generated token (greedy argmax or the pluggable
        sampler) and stream it."""
        tok = int(self.sample_fn(req, row) if self.sample_fn is not None else greedy)
        req.out.append(tok)
        if self.on_token is not None:
            self.on_token(req, tok)

    def _host_results(self, logits: torch.Tensor):
        """(greedy tokens, logits rows or None) of a prefill dispatch on
        the host. The greedy argmax runs on the device (first maximal index,
        like np.argmax); the full rows cross only when a sampler needs them."""
        greedy = logits.argmax(dim=-1).cpu().numpy()
        rows = logits.cpu().numpy() if self.sample_fn is not None else None
        return greedy, rows

    def _finish_ready(self):
        for s, req in self.slots.live_items():
            # pos is the NEXT write position: the slot is exhausted only
            # when pos == capacity
            if len(req.out) >= req.max_new or self.pos[s] >= self.slot_capacity:
                req.done = True
                req.truncated = len(req.out) < req.max_new
                self.finished.append(req)
                self.slots.release(s)  # state cleared on re-admission

    # --------------------------------------------------- retirement paths
    def cancel(self, uid) -> bool:
        """Cancel a request by uid, queued or mid-flight. Frees its slot
        immediately; the request lands in ``finished`` with
        ``cancelled=True`` and never emits another token. Returns False if
        no such request is queued or in flight."""
        req = self.scheduler.cancel(uid)
        if req is None:
            s = self.slots.slot_of(uid)
            if s is None:
                return False
            req = self.slots.release(s)
        req.cancelled = True
        self.finished.append(req)
        return True

    def _retire_expired(self):
        """Release requests past their ``timeout_s`` deadline — queued or
        mid-flight."""
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
            self.slots.release(s)
            req.timed_out = True
            self.finished.append(req)

    # ------------------------------------------------- legacy (gulp) prefill
    def _admit(self):
        """Fill free slots in scheduler policy order, then (unchunked mode)
        prefill ALL newly admitted prompts together in chunked dispatches."""
        admitted = self.scheduler.admit(self.slots.free_slots(), self._try_bind)
        newly = [s for s, _ in admitted]
        self._needs_reset |= set(newly)
        if self.scheduler.chunk_budget is None and newly:
            self._prefill_full(sorted(newly))
        return newly

    def _prefill_full(self, targets: list[int]):
        """Run every target slot's prompt to completion in (num_slots, C)
        dispatches, emitting each request's first generated token the
        dispatch its prefill completes."""
        task_ids = self._dev(self.slots.task_ids(self._null_task))
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
            t0 = time.perf_counter()
            last, self.caches, positions = self._prefill_fn(
                self._dev(tokens), task_ids, self.caches, self._dev(self.pos),
                self._dev(valid), reset,
            )
            greedy, rows = self._host_results(last)
            positions = positions.cpu().numpy()
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
            # generated token: emit it the dispatch it appears
            for s, req in completed:
                if self.slots.reqs[s] is req and not req.out:
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
        t0 = time.perf_counter()
        next_tok, step_logits, self.caches = self._tick_fn(
            self._dev(tokens), self._dev(self.slots.task_ids(self._null_task)),
            self.caches, self._dev(self.pos), self._dev(live),
        )
        greedy = next_tok.cpu().numpy()
        rows = step_logits.cpu().numpy() if self.sample_fn is not None else None
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
        last, self.caches, positions = self._prefill_fn(
            self._dev(tokens), self._dev(self.slots.task_ids(self._null_task)),
            self.caches, self._dev(self.pos), self._dev(valid), reset,
        )
        greedy, rows = self._host_results(last)
        positions = positions.cpu().numpy()
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
        for s, req in completed + decoding:
            if self.slots.reqs[s] is req:  # not cancelled mid-round
                self._emit(req, row=None if rows is None else rows[s], greedy=greedy[s])

    # ------------------------------------------------------------ driving
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
