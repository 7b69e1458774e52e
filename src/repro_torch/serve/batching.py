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

``prefix_cache=True`` (paged mode, attention-only models) puts a
``repro_torch.serve.paging.RadixPrefixCache`` in front of admission: a
request whose prompt shares a cached prefix aliases those blocks
(refcounted) instead of recomputing them, prefill starts at
``cached_tokens``, a partially shared boundary block is copy-on-written in
one step (``serve.step.make_cow_copy``, counted by ``cow_copies``), a
prompt's full blocks are registered once its prefill completes, and
retirement releases (decrefs) instead of freeing. Greedy outputs equal the
no-sharing path's. The trie is keyed on token ids (an audio prompt's
codebook rows), so a VLM request whose ``vision_mask`` masks any position
in neither matches nor registers blocks: its K/V depend on its image, which
the ids do not name (the reference keys on ids alone and serves one image's
cached K/V for another). Text-only requests of a VLM still share prefixes.

Input modes: an audio model's request carries (S0, K) codebook rows and
emits a K-token row per step (``Request.out`` holds (K,) int32 arrays);
a VLM request may carry ``extras`` {"vision_embeds": (S0, d_model),
"vision_mask": (S0,) bool}, aligned with its prompt and checked by
``submit``; each prefill dispatch carries its chunk's slice of them.

``adapters`` (a ``repro_torch.serve.adapters.TaskAdapterStore`` over the
model's ``num_tasks``) serves graph-mixed per-task low-rank adapters: every
dispatch gathers each row's deltas from ``adapters.serving`` by task id
(free and dead lanes carry the null id ``num_tasks``, the tree's zero row),
and every finished request is streamed into the store's delayed-update
loop (``note_request``) after its slot's blocks are freed.

Fault tolerance, as in the reference: ``faults=`` injects a seeded
``repro_torch.serve.faults.FaultPlan`` at named seams (allocator
exhaustion, prefix pinning, dispatch exceptions, NaN lanes, adapter
failures, failed retirements, clock skew; every seam a no-op when
``faults=None``). A dispatch seam fires before the step's inputs are
packed and before its CUDA graph is captured, so a faulted dispatch leaves
no half-made capture and launches (and counts) no kernel. ``quarantine``
(on exactly when a plan is given, unless set) reads each dispatch's logits
rows to the host before the next replay overwrites them and turns a
non-finite row into a terminal ``Request.failed`` for THAT request only.
Transient faults retry with a deadline-aware backoff (``max_retries``,
``retry_backoff_s``), and exhaustion goes terminally failed: ``run()``
raises nothing but the documented ``TickBudgetExceeded`` for an injected
fault. A real error — a CUDA error, a failed capture or replay — is no
``FaultError`` and propagates. ``preempt=True`` (paged mode) swaps a
running lower-priority victim's blocks to pinned host memory under block
pressure instead of refusing admission (``serve.step.make_swap``, eager,
between replays, the pools written in place; a hybrid's recurrent states
travel as the slot's columns beside the blocks) and requeues it; its
re-admission restores the rows into fresh blocks (and the states into its
new slot) and resumes at the saved position. ``check_invariants()`` reconciles the slot map, allocator
refcounts, block tables, prefix-trie chains and the queue at any point.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.models.model import ATTN_KINDS
from repro_torch.serve.faults import FaultError
from repro_torch.serve.paging import BlockAllocator, RadixPrefixCache
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.slots import SlotMap
from repro_torch.serve.step import StepExecutor, make_cow_copy, make_swap


def check_adapters(adapters, model) -> None:
    """Reject an adapter store built for another task count than the
    model's (its rows would be gathered by the wrong ids)."""
    if adapters is not None and adapters.num_tasks != model.cfg.num_tasks:
        raise ValueError(
            f"adapter store serves {adapters.num_tasks} tasks but the model has "
            f"num_tasks={model.cfg.num_tasks}"
        )


def shares_prefix(req) -> bool:
    """Whether a request's K/V are a function of its token ids alone, so
    its prompt blocks may be matched and registered in the prefix trie:
    False for a request whose ``vision_mask`` masks any position in."""
    return req.extras is None or not np.asarray(req.extras["vision_mask"]).any()


class TickBudgetExceeded(RuntimeError):
    """``run(max_ticks)`` spent its budget with requests still unfinished.

    The unfinished requests are flagged ``timed_out`` and remain queued /
    in-flight; pass ``on_exhausted="flag"`` to get partial results back
    instead of this exception."""


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray  # (S0,) prompt, or (S0, K) for audio codebooks
    max_new: int
    task_id: int = 0
    # a VLM request's inputs, aligned with the prompt: {"vision_embeds":
    # (S0, d_model) float32, "vision_mask": (S0,) bool}; None is text only
    extras: dict | None = None
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
    # terminal failure: lane quarantine (non-finite logits) or transient-
    # fault retry exhaustion; ``error`` carries the reason
    failed: bool = False
    error: str | None = None
    # bounded retry: transient injected faults requeue with a backoff;
    # ``not_before`` gates re-admission
    retries: int = 0
    not_before: float = 0.0
    # preemptive swap-out: times this request was swapped out, and (while
    # preempted) its snapshot {"kv": (pinned pages, pinned state columns),
    # "pos": int}
    preemptions: int = 0
    _swap: dict | None = None
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
        quarantine: bool | None = None,
        max_retries: int = 3,
        retry_backoff_s: float = 0.0,
        cuda_graphs: bool | None = None,
    ):
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
            recurrent = set(model.cfg.pattern) - set(ATTN_KINDS)
            if recurrent:
                # a recurrent layer's state at position p depends on ALL
                # positions <= p and lives outside the paged KV pools, so
                # aliasing KV blocks would resume from a stale or foreign state
                raise ValueError(
                    f"prefix_cache=True requires an attention-only model; layer kinds "
                    f"{sorted(recurrent)} carry recurrent state the KV blocks do not capture"
                )
            prefix = self.prefix = RadixPrefixCache(self.allocator)
            self._cow_fn = make_cow_copy(paging)
            # sjf orders by UNCACHED prompt tokens: a long prompt with a
            # resident prefix is a short job (the closure holds the cache,
            # not the batcher, so the batcher and its caches are freed
            # without waiting for the cycle collector)
            self.scheduler.cost_fn = lambda r: len(r.tokens) - (
                prefix.match(r.task_id, r.tokens).tokens if shares_prefix(r) else 0
            )
        # ---- fault tolerance & graceful degradation ----
        self.faults = faults
        # quarantine defaults on exactly when a fault plan is present: the
        # finiteness check reads every dispatch's logits to the host, which
        # the greedy path otherwise never does
        self.quarantine = (faults is not None) if quarantine is None else quarantine
        self.preempt = preempt
        if preempt and paging is None:
            raise ValueError(
                "preempt=True requires a paged cache layout (a PagingSpec): "
                "dense per-slot stripes hold no blocks to swap out"
            )
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self._swap_out_fn = self._swap_in_fn = None
        if preempt:
            self._swap_out_fn, self._swap_in_fn = make_swap(paging, model.kinds)
        if faults is not None:
            # clock-skew seam: every deadline decision the scheduler makes
            # sees the plan's skewed time (timeout storms)
            base_now = self.scheduler._now
            self.scheduler._now = lambda: base_now() + faults.skew()
        self.caches = model.init_cache(num_slots, max_seq, paging)
        self.finished: list[Request] = []
        self.ticks = 0
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.mixed_dispatches = 0  # fused prefill+decode (chunk_budget mode)
        self.cow_copies = 0  # copy-on-write steps (prefix-cache mode)
        self.admission_waits = 0  # admission rounds stopped on KV blocks (paged)
        self.prefill_tokens = 0  # prompt tokens computed
        self.swap_outs = 0  # preemptive swap-outs
        self.swap_ins = 0  # swap-ins (restores)
        self.quarantined = 0  # requests failed by the finiteness check
        self.dispatch_faults = 0  # injected dispatch failures absorbed
        self.adapter_faults = 0  # injected adapter-update failures absorbed
        self.retire_faults = 0  # injected mid-retirement failures absorbed
        self.decode_s = self.prefill_s = 0.0
        self._consec_dispatch_faults = 0
        self._stalled_steps = 0  # no-progress rounds (count against run())
        self._pending_prefill: set[int] = set()  # gulp resume after a fault
        self._needs_reset: set[int] = set()  # fresh slots awaiting reset
        self._just_restored: set[int] = set()
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
        cfg = self.model.cfg
        want = (n, cfg.num_codebooks) if cfg.input_mode == "audio" else (n,)
        if np.shape(req.tokens) != want:
            raise ValueError(
                f"request {req.uid}: prompt of shape {np.shape(req.tokens)}; a "
                f"{cfg.input_mode!r} model takes {want}"
            )
        self._validate_extras(req, n)
        self.scheduler.submit(req)

    def _validate_extras(self, req: Request, n: int):
        """A request's extras must be what the prefill dispatch consumes:
        only a VLM takes them, and then both vision inputs, aligned with the
        prompt (the reference's rules and messages)."""
        cfg = self.model.cfg
        if req.extras is None:
            return
        if cfg.input_mode != "vlm":
            raise ValueError(
                f"request {req.uid}: extras are only supported for "
                f"input_mode='vlm' models, not {cfg.input_mode!r}"
            )
        missing = {"vision_embeds", "vision_mask"} - set(req.extras)
        if missing:
            raise ValueError(
                f"request {req.uid}: vlm extras must carry "
                f"'vision_embeds' and 'vision_mask' (missing {sorted(missing)})"
            )
        emb = np.asarray(req.extras["vision_embeds"])
        msk = np.asarray(req.extras["vision_mask"])
        if emb.shape != (n, cfg.d_model) or msk.shape != (n,):
            raise ValueError(
                f"request {req.uid}: vlm extras must be aligned with the "
                f"prompt — want vision_embeds ({n}, {cfg.d_model}) and "
                f"vision_mask ({n},), got {emb.shape} and {msk.shape}"
            )

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
        prefix trie (only final KV values are ever aliasable), unless its
        K/V depend on vision inputs the trie's keys do not hold."""
        if self.prefix is not None and req.prefill_remaining == 0 and shares_prefix(req):
            self.prefix.insert(req.task_id, req.tokens, self.slot_blocks[s])

    def _try_bind(self, s: int, req: Request) -> bool:
        """Scheduler placement callback: reserve the request's blocks for
        its whole lifetime and bind the slot — or report backpressure
        (False stops admission for this round; ``admission_waits`` counts
        it). Under ``preempt=True``, block pressure first tries to swap out
        a strictly-lower-priority running victim. A transient
        ``FaultError`` on an admission dispatch (COW, swap-in) unwinds
        every reference the attempt acquired and requeues the request with
        bounded retry."""
        if self.paging is None:
            self.slots.bind(s, req)
            return True
        needed = self.paging.blocks_for(len(req.tokens) + req.max_new)
        if self.faults is not None and self.faults.fires("alloc", uid=req.uid):
            # simulated allocator exhaustion: indistinguishable from real
            # backpressure downstream
            bound = False
        else:
            try:
                bound = self._bind_paged(s, req, needed)
            except FaultError as e:
                self._note_retry(req, str(e))
                return False
        if not bound:
            self.admission_waits += 1
        return bound

    def _bind_paged(self, s: int, req: Request, needed: int) -> bool:
        if req._swap is not None:
            return self._bind_restore(s, req, needed)
        if self.prefix is not None:
            if self.faults is not None and self.faults.fires("incref", uid=req.uid):
                return False
            return self._bind_prefix(s, req, needed)
        if not self.allocator.can_alloc(needed) and not self._preempt_for(req, needed):
            return False  # wait for finishing requests' blocks
        self._set_table(s, self.allocator.alloc(needed))
        self.slots.bind(s, req)
        return True

    def _bind_prefix(self, s: int, req: Request, needed: int) -> bool:
        """Prefix-cache admission: alias the cached chain, copy-on-write
        the partially shared boundary block, bind at ``cached_tokens``. A
        request with vision inputs takes fresh blocks and matches nothing."""
        if not shares_prefix(req):
            if not self.prefix.can_alloc(needed) and not self._preempt_for(req, needed):
                return False
            self._set_table(s, self.prefix.alloc(needed))
            self.slots.bind(s, req)
            return True
        admit = self.prefix.admit(req.task_id, req.tokens, needed)
        if admit is None and self._preempt_for(req, needed):
            admit = self.prefix.admit(req.task_id, req.tokens, needed)
        if admit is None:
            return False  # truly out of live + unreclaimable memory
        if admit.cow is not None:
            # the boundary block is only partially shared: copy the shared
            # rows into the slot's private block. The source stays pinned
            # (increfed) across the copy; the pin drops whatever happens,
            # and a failure also unwinds the chain and the fresh blocks
            src, dst, rows = admit.cow
            ok = False
            try:
                if self.faults is not None and self.faults.fires(
                    "dispatch", uid=req.uid, where="cow"
                ):
                    raise FaultError("injected copy-on-write dispatch failure")
                self.caches = self._cow_fn(self.caches, src, dst, rows)
                self.cow_copies += 1
                ok = True
            finally:
                self.prefix.release([src])
                if not ok:
                    self.prefix.release(list(admit.blocks))
        self._set_table(s, admit.blocks)
        # prefill resumes after the cached prefix
        req.prompt_done = admit.cached_tokens
        req.cached_tokens = admit.cached_tokens
        self.slots.bind(s, req, pos=admit.cached_tokens)
        return True

    def _bind_restore(self, s: int, req: Request, needed: int) -> bool:
        """Re-admit a preempted request: fresh blocks, one swap-in of its
        saved rows, bound at the saved position. The prefix trie is
        bypassed: the snapshot holds mid-generation KV that must stay
        private, so restored blocks never alias cached chains."""
        if not self._blocks_available(needed) and not self._preempt_for(req, needed):
            return False
        release = self.prefix.release if self.prefix is not None else self.allocator.free
        blocks = (self.prefix.alloc(needed) if self.prefix is not None
                  else self.allocator.alloc(needed))
        try:
            if self.faults is not None and self.faults.fires(
                "dispatch", uid=req.uid, where="swap"
            ):
                raise FaultError("injected swap-in dispatch failure")
            self._swap_in_fn(self.caches, blocks, req._swap["kv"], s)
        except FaultError:
            # unwind the fresh blocks; the snapshot stays on the request,
            # so a later retry restores from it unchanged
            release(blocks)
            raise
        self.swap_ins += 1
        self._set_table(s, blocks)
        self.slots.bind(s, req, pos=req._swap["pos"])
        req._swap = None  # the pinned snapshot goes back to torch's cache
        self._just_restored.add(s)
        return True

    # --------------------------------------------- preemptive swap-out
    def _blocks_available(self, n: int) -> bool:
        if self.prefix is not None:
            return self.prefix.can_alloc(n)
        return self.allocator.can_alloc(n)

    def _pick_victim(self, req: Request):
        """Among running slots whose priority value is STRICTLY greater
        than the incoming request's (they matter strictly less), the
        lowest-priority one, ties broken by most blocks held, then latest
        arrival. Strict dominance means a restored request is never
        re-preempted by the one it yielded to (no livelock). Only slots
        past prefill that have emitted a token are preemptable."""
        candidates = [
            (s, r) for s, r in self.slots.live_items()
            if r.priority > req.priority and r.prefill_remaining == 0 and r.out
        ]
        if not candidates:
            return None
        return max(candidates,
                   key=lambda sr: (sr[1].priority, len(self.slot_blocks[sr[0]]), sr[1]._arrival))

    def _preempt_for(self, req: Request, needed: int) -> bool:
        """Swap out victims until ``needed`` blocks are coverable (or no
        dominated victim remains). Returns whether pressure was relieved."""
        if not self.preempt:
            return False
        while not self._blocks_available(needed):
            victim = self._pick_victim(req)
            if victim is None:
                return False
            try:
                self._swap_out_slot(*victim)
            except FaultError:
                # the fault fired before the gather: the victim keeps
                # running untouched; no preemption this round
                self.dispatch_faults += 1
                return False
        return True

    def _swap_out_slot(self, s: int, req: Request) -> None:
        """Gather the slot's blocks to host memory (one swap-out), free
        them, release the slot and requeue the request at its original
        arrival position; re-admission restores it (``_bind_restore``)."""
        if self.faults is not None and self.faults.fires(
            "dispatch", uid=req.uid, where="swap"
        ):
            raise FaultError("injected swap-out dispatch failure")
        saved = self._swap_out_fn(self.caches, self.slot_blocks[s], s)
        req._swap = {"kv": saved, "pos": int(self.pos[s])}
        req.preemptions += 1
        self.swap_outs += 1
        self._free_slot_blocks(s)
        self.slots.release(s)
        self.scheduler.requeue(req)

    # ----------------------------------------------------- bounded retry
    def _backoff_delay(self, req: Request) -> float:
        """Deadline-aware exponential backoff: doubles per retry but is
        capped at half the request's remaining deadline budget, so backoff
        can never itself expire the request."""
        if self.retry_backoff_s <= 0.0:
            return 0.0
        delay = self.retry_backoff_s * (2 ** (req.retries - 1))
        if req.timeout_s is not None and req.submit_time is not None:
            remaining = req.submit_time + req.timeout_s - self.scheduler.now()
            delay = min(delay, max(0.0, 0.5 * remaining))
        return delay

    def _note_retry(self, req: Request, error: str) -> None:
        """Bounded retry for a transient admission fault: requeue with
        backoff, or — once ``max_retries`` is exhausted — retire the
        request terminally failed."""
        req.retries += 1
        if req.retries > self.max_retries:
            self.scheduler.cancel(req.uid)  # drop from the queue if queued
            s = self.slots.slot_of(req.uid)
            if s is not None:
                self._free_slot_blocks(s)
                self.slots.release(s)
            req.failed = True
            req.error = f"{error} (retries exhausted after {req.retries - 1})"
            req._swap = None
            self.finished.append(req)
            return
        req.not_before = self.scheduler.now() + self._backoff_delay(req)

    # ------------------------------------------------------------- emission
    def _emit(self, req: Request, row=None, greedy=None):
        """Append one generated token (greedy argmax or the pluggable
        sampler) and stream it: an int, or an audio model's (K,) int32 row."""
        tok = self.sample_fn(req, row) if self.sample_fn is not None else greedy
        tok = int(tok) if np.ndim(tok) == 0 else np.asarray(tok, np.int32)
        req.out.append(tok)
        if len(req.out) == 1:
            tracing.first_token(req.uid)
        if self.on_token is not None:
            self.on_token(req, tok)

    def _rows(self, logits: torch.Tensor):
        """A dispatch's logits rows on the host, only when a sampler or the
        quarantine needs them (the greedy argmax runs on the device: first
        maximal index, like np.argmax). Read at once: the next replay
        overwrites them."""
        if self.sample_fn is None and not self.quarantine:
            return None
        with tracing.span(".wait"):
            return logits.cpu().numpy()

    def _slab(self, c: int):
        """Zeroed host inputs of one (num_slots, c) prefill dispatch: tokens
        ((num_slots, c, K) for audio), valid, reset, and a VLM's (embeds,
        vision mask), else None."""
        cfg = self.model.cfg
        k = cfg.num_codebooks
        tokens = np.zeros((self.num_slots, c) + ((k,) if k > 1 else ()), np.int32)
        vision = None
        if cfg.input_mode == "vlm":
            vision = (np.zeros((self.num_slots, c, cfg.d_model), np.float32),
                      np.zeros((self.num_slots, c), bool))
        return (tokens, np.zeros((self.num_slots, c), bool), np.zeros(self.num_slots, bool),
                vision)

    @staticmethod
    def _fill_row(tokens, valid, vision, s: int, req: Request, n: int) -> None:
        """Slot ``s``'s first ``n`` lanes: the request's next ``n`` prompt
        tokens from its cursor, and their slice of its vision inputs."""
        d = req.prompt_done
        tokens[s, :n] = np.asarray(req.tokens, np.int32)[d : d + n]
        valid[s, :n] = True
        if vision is not None and req.extras is not None:
            vision[0][s, :n] = np.asarray(req.extras["vision_embeds"], np.float32)[d : d + n]
            vision[1][s, :n] = np.asarray(req.extras["vision_mask"], bool)[d : d + n]

    def _finish_ready(self):
        with tracing.span("serve.finish"):
            for s, req in self.slots.live_items():
                # pos is the NEXT write position: the slot is exhausted only
                # when pos == capacity
                if len(req.out) < req.max_new and self.pos[s] < self.slot_capacity:
                    continue
                req.done = True
                req.truncated = len(req.out) < req.max_new
                self.finished.append(req)
                tracing.finished(req.uid)
                # blocks before the binding: an unbound slot must never
                # still hold blocks
                self._free_slot_blocks(s)
                self.slots.release(s)  # state cleared on re-admission
                if self.adapters is None:
                    continue
                # the finish feeds the store's delayed-update loop (host
                # side, between dispatches). An injected update failure
                # drops THIS request's signal only
                if self.faults is not None and self.faults.fires("adapter", uid=req.uid):
                    self.adapter_faults += 1
                else:
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
        req._swap = None  # a preempted request's snapshot
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
            req._swap = None  # a preempted request's snapshot
            self.finished.append(req)
        for s, req in dead_live:
            if self.faults is not None and self.faults.fires("free", uid=req.uid):
                # injected mid-retirement fault: skip THIS retirement — the
                # slot stays bound and its blocks held, so the allocator
                # stays reconcilable, and the expiry retries next round
                self.retire_faults += 1
                continue
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
        with tracing.span("serve.admit"):
            self._just_restored = set()
            admitted = self.scheduler.admit(self.slots.free_slots(), self._try_bind)
            newly = [s for s, _ in admitted]
            # restored (swapped-in) slots must not be reset: their rows were
            # just written back
            self._needs_reset |= set(newly) - self._just_restored
            # slots whose gulp a dispatch fault interrupted resume here
            resumed = sorted(self._pending_prefill)
            self._pending_prefill = set()
        if self.scheduler.chunk_budget is None and (newly or resumed):
            self._prefill_full(sorted(set(newly) | set(resumed)))
        return newly

    def _prefill_full(self, targets: list[int]):
        """Run every target slot's prompt to completion in (num_slots, C)
        dispatches, emitting each request's first generated token the
        dispatch its prefill completes. Each slot prefills from its own
        cursor (``prompt_done``: 0, or ``cached_tokens`` after a prefix
        hit), so a resident prefix costs no dispatch; restored slots ride
        along with nothing to prefill. An injected dispatch fault aborts
        the round before the dispatch: the unfinished slots land in
        ``_pending_prefill`` and the next admission round resumes them
        from their cursors."""
        task_ids = self.slots.task_ids(self._null_task)
        tree = self._adapter_tree()
        while True:
            pending = [
                s for s in targets
                if self.slots.reqs[s] is not None
                and self.slots.reqs[s].prefill_remaining > 0
            ]
            if not pending:
                break
            if self.faults is not None and self.faults.fires("dispatch", where="prefill"):
                self._pending_prefill = set(pending)
                raise FaultError("injected prefill dispatch failure")
            with tracing.span("serve.prefill"):
                self._prefill_dispatch(pending, task_ids, tree)

    def _prefill_dispatch(self, pending: list[int], task_ids, tree) -> None:
        """One (num_slots, C) dispatch of ``_prefill_full`` over the slots
        in ``pending``."""
        c = self.prefill_chunk
        with tracing.span(".pack"):
            tokens, valid, reset, vision = self._slab(c)
            for s in pending:
                req = self.slots.reqs[s]
                reset[s] = s in self._needs_reset
                self._fill_row(tokens, valid, vision, s, req, min(c, req.prefill_remaining))
        self._steps.prepare("prefill", tree)  # capture_s, not prefill_s
        t0 = time.perf_counter()
        greedy, last, positions = self._steps.prefill(
            tokens, task_ids, self.pos, valid, reset, self._block_tables(), tree, vision,
        )
        rows = self._rows(last)
        self.prefill_s += time.perf_counter() - t0
        self.prefill_dispatches += 1
        self.prefill_tokens += int(valid.sum())
        self._consec_dispatch_faults = 0
        self._needs_reset -= set(pending)
        with tracing.span(".emit"):
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
            if self.quarantine and completed:
                self._quarantine_scan({s: rows[s] for s, _ in completed}, completed)
            for s, req in completed:
                if self.slots.reqs[s] is not req:  # quarantined/cancelled
                    continue
                self._register_prefix(s, req)
                if not req.out:
                    self._emit(req, row=None if rows is None else rows[s],
                               greedy=greedy[s])

    def _quarantine_scan(self, rows: dict, items: list) -> None:
        """Lane quarantine: one host-side finiteness check over the logits
        rows this dispatch already read. A non-finite row fails ONLY its
        own request — terminal ``Request.failed`` with the reason, blocks
        freed, slot released — while every other lane's tokens are
        untouched.

        rows: {slot: logits row (np)}; items: [(slot, request)] emitting
        this dispatch. The ``nan`` fault seam poisons its scripted lanes
        here, in the host copy, never in the device output."""
        if not items:
            return
        if self.faults is not None:
            for s, req in items:
                if self.faults.fires("nan", slot=s, uid=req.uid):
                    rows[s] = np.full_like(rows[s], np.nan)
        mat = np.stack([rows[s] for s, _ in items])  # (n, V) or audio's (n, K, V)
        finite = np.isfinite(mat.reshape(len(items), -1)).all(axis=1)
        for (s, req), ok in zip(items, finite):
            if ok:
                continue
            self.quarantined += 1
            self._free_slot_blocks(s)  # blocks first (see _finish_ready)
            self.slots.release(s)
            req.failed = True
            req.error = (
                f"non-finite logits at tick {self.ticks} (slot {s}) — lane quarantined"
            )
            self.finished.append(req)

    def tick(self):
        """Advance every live slot one token — exactly ONE decode dispatch
        regardless of how many slots are live or at which positions."""
        live = self.slots.live()
        if not live.any():
            return
        if self.faults is not None and self.faults.fires("dispatch", where="decode"):
            raise FaultError("injected decode dispatch failure")
        with tracing.span("serve.decode"):
            with tracing.span(".pack"):
                k = self.model.cfg.num_codebooks
                tokens = np.zeros((self.num_slots,) + ((k,) if k > 1 else ()), np.int32)
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
            self._consec_dispatch_faults = 0
            with tracing.span(".emit"):
                self.slots.advance_live()
                if self.quarantine:
                    items = self.slots.live_items()
                    self._quarantine_scan({s: rows[s] for s, _ in items}, items)
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
        if self.faults is not None and self.faults.fires("dispatch", where="mixed"):
            raise FaultError("injected mixed dispatch failure")
        with tracing.span("serve.mixed"):
            self._mixed_dispatch(prefilling, decoding)

    def _mixed_dispatch(self, prefilling: list, decoding: list) -> None:
        """The fused dispatch of ``_interleaved_tick``."""
        c = self.prefill_chunk
        with tracing.span(".pack"):
            plan = self.scheduler.plan_prefill(prefilling, c)
            tokens, valid, reset, vision = self._slab(c)
            for s, n in plan:
                req = self.slots.reqs[s]
                self._fill_row(tokens, valid, vision, s, req, n)
                reset[s] = req.prompt_done == 0
            for s, req in decoding:
                tokens[s, 0] = req.out[-1] if req.out else np.asarray(req.tokens)[-1]
                valid[s, 0] = True
        greedy, last, positions = self._steps.prefill(
            tokens, self.slots.task_ids(self._null_task), self.pos, valid, reset,
            self._block_tables(), self._adapter_tree(), vision,
        )
        rows = self._rows(last)
        self.ticks += 1
        self.mixed_dispatches += 1
        self.prefill_tokens += sum(n for _, n in plan)
        self._consec_dispatch_faults = 0
        with tracing.span(".emit"):
            self.slots.set_positions(positions)
            completed = []
            for s, n in plan:
                req = self.slots.reqs[s]
                if req is None:  # cancelled from a streaming callback mid-round
                    continue
                req.prompt_done += n
                if req.prefill_remaining == 0:
                    completed.append((s, req))
            if self.quarantine:
                items = completed + [(s, r) for s, r in decoding if self.slots.reqs[s] is r]
                self._quarantine_scan({s: rows[s] for s, _ in items}, items)
            for s, req in completed:
                if self.slots.reqs[s] is req:  # not quarantined/cancelled
                    self._register_prefix(s, req)
            for s, req in completed + decoding:
                if self.slots.reqs[s] is req:  # not quarantined/cancelled
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
        ``chunk_budget`` is None, or one fused interleaved dispatch.

        An injected dispatch ``FaultError`` (always raised before the
        dispatch, so no state was mutated) aborts the round; the next round
        retries the same work. ``max_retries`` consecutive failed rounds
        fail every in-flight request terminally instead of spinning."""
        with tracing.span("serve.round"):
            if self.faults is not None:
                self.faults.set_tick(self.ticks)
            with tracing.span("serve.admit"):
                self._retire_expired()
            try:
                self._admit()
                if self.scheduler.chunk_budget is None:
                    self._finish_ready()  # prefill alone may satisfy max_new
                    if self.slots.any_live():
                        self.tick()
                else:
                    self._interleaved_tick()
            except FaultError as e:
                self._note_dispatch_fault(e)
            self._finish_ready()

    def _note_dispatch_fault(self, e: FaultError) -> None:
        """Count an injected dispatch fault, and once ``max_retries``
        CONSECUTIVE rounds have failed (a successful dispatch resets the
        streak), retire every in-flight request terminally failed."""
        self.dispatch_faults += 1
        self._consec_dispatch_faults += 1
        if self._consec_dispatch_faults <= self.max_retries:
            return
        for s, req in self.slots.live_items():
            self._free_slot_blocks(s)
            self.slots.release(s)
            req.failed = True
            req.error = (
                f"dispatch failed {self._consec_dispatch_faults} consecutive rounds: {e}"
            )
            self.finished.append(req)
        self._pending_prefill = set()
        self._consec_dispatch_faults = 0

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
                # a round that advanced nothing (injected faults, backoff)
                # burns budget too: a permanently faulted engine raises
                # TickBudgetExceeded instead of spinning
                stalled += 1
                self._stalled_steps += 1
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

    # ------------------------------------------------------ reconciliation
    def check_invariants(self) -> dict:
        """Host-side reconciliation: slot map vs. allocator refcounts vs.
        block tables vs. prefix-trie chains vs. the scheduler queue. Pure
        bookkeeping, no dispatch; callable between steps. Raises
        ``RuntimeError`` at the first violation; returns a summary dict
        when everything reconciles."""
        live = self.slots.live_items()
        self.slots.check_consistent(self.slot_capacity)
        for s, req in live:
            if req.done or req.failed or req.cancelled:
                raise RuntimeError(
                    f"slot {s}: request {req.uid} is retired "
                    "(done/failed/cancelled) but still bound"
                )
        uids = [r.uid for r in self.scheduler.queue] + [r.uid for _, r in live]
        if len(set(uids)) != len(uids):
            raise RuntimeError(f"duplicate uid across queue + slots: {sorted(uids)}")
        for r in self.scheduler.queue:
            if r.done or r.failed or r.cancelled or r.timed_out:
                raise RuntimeError(f"queued request {r.uid} is already retired")
        summary = {
            "live_slots": len(live),
            "queued": len(self.scheduler.queue),
            "finished": len(self.finished),
        }
        if self.paging is None:
            return summary
        spec = self.paging
        expected = [0] * spec.num_blocks
        for s in range(self.num_slots):
            blocks = self.slot_blocks[s]
            row = self.block_tables[s]
            if self.slots.reqs[s] is None:
                if blocks or row.any():
                    raise RuntimeError(
                        f"slot {s} is unbound but still holds blocks "
                        f"{blocks or row.nonzero()[0].tolist()} — leak"
                    )
                continue
            if not blocks:
                raise RuntimeError(
                    f"slot {s} (request {self.slots.reqs[s].uid}) is live "
                    "with no reserved blocks"
                )
            if list(row[: len(blocks)]) != blocks or row[len(blocks):].any():
                raise RuntimeError(
                    f"slot {s}: block table row {row.tolist()} does not "
                    f"mirror the reservation {blocks}"
                )
            for b in blocks:
                if not 0 < b < spec.num_blocks:
                    raise RuntimeError(f"slot {s} maps foreign block {b}")
                expected[b] += 1
        self.allocator.check_consistent(expected)
        registered = set(self.prefix._node_of_block) if self.prefix is not None else set()
        for b in range(1, spec.num_blocks):
            if (
                self.allocator.refcount[b] == 0
                and b not in self.allocator._free_set
                and b not in registered
            ):
                raise RuntimeError(
                    f"block {b} leaked: refcount 0, not on the free list, "
                    "not cached in the prefix trie"
                )
        if self.prefix is not None:
            self.prefix.check_chains()
        for r in self.scheduler.queue:
            if r._swap is None and r.prompt_done > r.cached_tokens:
                # a queued non-preempted request holds no cache state, so a
                # nonzero cursor would skip prefilling real prompt tokens
                raise RuntimeError(
                    f"queued request {r.uid} has prefill cursor "
                    f"{r.prompt_done} but no slot and no swap snapshot"
                )
        summary.update({
            "free_blocks": self.allocator.free_blocks,
            "live_refs": self.allocator.live_refs,
            "cached_blocks": len(registered),
        })
        return summary
