"""Token-budget scheduler: admission policies + chunked prefill planning.

Copy of ``repro.serve.scheduler`` (host only) for the dense serving slice.
The scheduler owns the request QUEUE and every *decision*: which queued
request is admitted to which free slot (policy-ordered), how many prompt
tokens each mid-prefill slot may compute this tick (the Sarathi-style chunk
budget that co-schedules prefill with decode), and which requests have
expired. No tensors, no model — the executor (``ContinuousBatcher``) turns
its decisions into dispatches.

Policies (``policy=``):

  * ``"fifo"``    — strict arrival order. With ``chunk_budget=None`` this
    is the parity-oracle configuration ``ServeEngine`` uses.
  * ``"sjf"``     — shortest prompt first, arrival order as tie-break.
  * ``"priority"``— lower ``Request.priority`` first (nice-style: 0 beats
    10), arrival order as tie-break.

Admission stops at the first request that cannot be placed rather than
skipping it, so under sjf/priority large jobs are not starved.

``chunk_budget`` bounds the PROMPT tokens prefilled per tick across all
slots; ``None`` disables chunk scheduling (admission prefills whole prompts
immediately).

Deadlines: a request with ``timeout_s`` set expires ``timeout_s`` seconds
after submission (wall clock via ``now_fn``, injectable for tests) whether
it is still queued or mid-flight.

Not ported yet (later slices): the prefix-cache cost hook (``cost_fn``) and
the requeue / retry-backoff paths of preemption and fault tolerance.
"""
from __future__ import annotations

import itertools
import time

POLICIES = ("fifo", "sjf", "priority")


class Scheduler:
    """Queue ownership + admission/budget/expiry decisions (host-only)."""

    def __init__(self, policy: str = "fifo", chunk_budget: int | None = None,
                 now_fn=None):
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}"
            )
        if chunk_budget is not None and chunk_budget < 1:
            raise ValueError(
                f"chunk_budget must be a positive token count or None "
                f"(None = unchunked full-prompt prefill), got {chunk_budget}"
            )
        self.policy = policy
        self.chunk_budget = chunk_budget
        self.queue: list = []
        self._now = now_fn if now_fn is not None else time.monotonic
        self._arrivals = itertools.count(1)

    def now(self) -> float:
        return self._now()

    # ----------------------------------------------------------- enqueue
    def submit(self, req) -> None:
        """Enqueue an (already validated) request, stamping arrival order
        and submit time (the deadline clock starts here, not at admission —
        time spent queued counts against ``timeout_s``)."""
        req._arrival = next(self._arrivals)
        req.submit_time = self.now()
        self.queue.append(req)

    def cancel(self, uid):
        """Remove and return a QUEUED request by uid (None if not queued —
        the executor handles in-flight cancellation)."""
        for req in self.queue:
            if req.uid == uid:
                self.queue.remove(req)
                return req
        return None

    # ---------------------------------------------------------- ordering
    def _key(self, req):
        arrival = getattr(req, "_arrival", 0)
        if self.policy == "sjf":
            return (len(req.tokens), arrival)
        if self.policy == "priority":
            return (req.priority, arrival)
        return (arrival,)

    def ordered_queue(self) -> list:
        """The queue in policy order (a view — the queue itself stays in
        arrival order so FIFO needs no re-sort)."""
        if self.policy == "fifo":
            return list(self.queue)
        return sorted(self.queue, key=self._key)

    # --------------------------------------------------------- decisions
    def admit(self, free_slots: list[int], try_bind) -> list:
        """Fill free slots in policy order. ``try_bind(slot, req)`` is the
        executor's placement callback; a False return STOPS admission
        (head-of-line backpressure in policy order). Returns the
        [(slot, request)] admitted."""
        admitted = []
        free = list(free_slots)
        for req in self.ordered_queue():
            if not free:
                break
            if not try_bind(free[0], req):
                break
            slot = free.pop(0)
            self.queue.remove(req)
            admitted.append((slot, req))
        return admitted

    def plan_prefill(self, prefilling: list, chunk: int) -> list:
        """Split this tick's prefill budget over mid-prompt slots.

        prefilling: [(slot, request, remaining_prompt_tokens)]. Returns
        [(slot, n_tokens)] with ``n <= min(chunk, remaining)`` per slot and
        ``sum(n) <= chunk_budget``, in policy order — when the budget binds,
        the policy decides whose prompt advances this tick. ``chunk`` also
        caps per-slot work because one tick dispatches one (B, chunk) slab.
        """
        budget = self.chunk_budget
        if budget is None:
            budget = len(prefilling) * chunk  # unbounded: everyone advances
        order = sorted(prefilling, key=lambda t: self._key(t[1]))
        plan = []
        for slot, _req, remaining in order:
            if budget <= 0:
                break
            n = min(remaining, chunk, budget)
            if n <= 0:
                continue
            budget -= n
            plan.append((slot, n))
        return plan

    def expired(self, now: float, live_items: list) -> tuple[list, list]:
        """Requests past their deadline: ``(queued, [(slot, req), ...])``.
        Queued expirations are removed from the queue here; in-flight ones
        are returned for the executor to release (it owns the slot)."""
        dead_queued = [
            r for r in self.queue
            if r.timeout_s is not None and r.submit_time is not None
            and now - r.submit_time >= r.timeout_s
        ]
        for r in dead_queued:
            self.queue.remove(r)
        dead_live = [
            (s, r) for s, r in live_items
            if r.timeout_s is not None and r.submit_time is not None
            and now - r.submit_time >= r.timeout_s
        ]
        return dead_queued, dead_live
