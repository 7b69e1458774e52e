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
    logits, caches). An audio model's tokens are (B, K) codebook rows, its
    step logits (B, K, V) and its greedy tokens (B, K), argmax over each
    codebook's vocabulary; a VLM's decode step is text only, as the
    reference's ``make_step_batch`` without extras.

  * ``prefill_chunk(tokens, task_ids, caches, positions, valid, reset,
    block_tables=None, adapters=None, extras=None)`` — write a whole (B,
    C) prompt slice ((B, C, K) for audio); ``extras`` carries a VLM
    chunk's (B, C, d_model) ``vision_embeds`` and (B, C) ``vision_mask``
    (None: a text-only chunk).
    ``valid[b, i]`` marks real prompt tokens as a contiguous prefix per
    row; ``reset[b]`` (host bool array) restores a (re)admitted slot's
    per-slot cache entries (dense stripes, recurrent states) to their
    ``init_cache`` value before writing (paged pools need no reset). Returns (logits
    after each slot's last valid token — zeros for rows with none, caches,
    ``positions + n_valid``).

``prefill_mode``: ``"parallel"`` (``model.prefill_step``: all C tokens in
one pass) or ``"scan"`` (C sequential ``decode_step`` calls — the oracle
the parallel path is held against, as in the JAX package).

MoE caveat (as in the JAX package): expert capacity is computed per
dispatch (``apply_moe`` sizes its buffers from the tokens it is given), so
when capacity binds, the (B*C)-token parallel slab drops other tokens than C
sequential B-token steps would. Routing itself is per token and the same;
only the lossy overflow differs. The two modes (and chunk widths) agree
token for token under dropless capacity (``capacity_factor >=
num_experts``); under binding capacity each is self-consistent but they
are not interchangeable. Both keep dead lanes out of the experts: a decode
tick passes ``live``, a parallel chunk ``valid`` and each scan step its
column of ``valid``.

With ``paging`` (a ``repro_torch.serve.paging.PagingSpec``) the caches are
the shared pools of ``model.init_cache(..., paging=spec)`` and every call
takes the (B, max_blocks) int32 ``block_tables`` of the slots, one device
tensor per dispatch shared by every layer. ``adapters`` is the serving tree
of a ``repro_torch.serve.adapters.TaskAdapterStore`` (per-task low-rank
deltas gathered by ``task_ids``), or None.

``StepExecutor`` is what the batcher dispatches through: the pair over the
static device buffers of one batcher, the counterpart of the reference's
``jax.jit`` of the pair. With ``cuda_graphs`` on (the default for a CUDA
model) each step is captured once as a CUDA graph, and a dispatch is one
upload of the packed int32 inputs, one graph replay and one read-back of
the results; with it off (the CPU, or ``cuda_graphs=False``: the
counterpart of ``jax.disable_jit``) the same buffers feed the eager pair.

``make_cow_copy(paging)`` returns the copy-on-write step of the prefix
cache: rows ``[0, rows)`` of block ``src`` into block ``dst`` in every pool.
``make_swap(paging, kinds)`` returns the pair of preemptive swap-out: a
slot's blocks (and its recurrent states' columns) gathered to host memory,
and written back into fresh blocks (and the slot it is restored to).
Both run eagerly between replays and write the pools in place, so the
captured graphs, which read the pools by address, stay valid.

The weights live in the model, so unlike the JAX pair these take no params
argument. Caches are updated in place and returned. The attention backend
rides on ``model.cfg.attn_backend``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import tracing
from repro_torch import tree as tree_lib
from repro_torch.kernels.decode_attention.ops import decode_attention, paged_decode_attention
from repro_torch.kernels.prefill_attention.ops import (
    paged_prefill_attention,
    prefill_attention,
)
from repro_torch.models.model import ATTN_KINDS

# the kernel wrappers a step can launch; a replay adds what its capture launched
_COUNTED_OPS = (decode_attention, paged_decode_attention, prefill_attention,
                paged_prefill_attention)


def _step_bodies(model, prefill_mode: str):
    """(decode_tick, prefill body without the slot reset)."""
    if prefill_mode not in ("parallel", "scan"):
        raise ValueError(
            f"prefill_mode must be 'parallel' or 'scan', got {prefill_mode!r}"
        )

    def rows(mask, like):  # a (B,) mask over the rows of (B, V) or (B, K, V) logits
        return mask.reshape(mask.shape + (1,) * (like.ndim - 1))

    def decode_tick(tokens, task_ids, caches, positions, live, block_tables=None,
                    adapters=None):
        logits, caches = model.decode_step(
            {"tokens": tokens[:, None], "task_ids": task_ids}, caches, positions,
            live=live, block_tables=block_tables, adapters=adapters,
        )
        step_logits = logits[:, 0]  # (B, V) f32, (B, K, V) for audio
        return step_logits.argmax(dim=-1), step_logits, caches

    def prefill_parallel(tokens, task_ids, caches, positions, valid, block_tables=None,
                         adapters=None, extras=None):
        logits, caches = model.prefill_step(
            {"tokens": tokens, "task_ids": task_ids, **(extras or {})}, caches, positions,
            valid, block_tables=block_tables, adapters=adapters,
        )
        n_valid = valid.sum(dim=1).to(positions.dtype)  # (B,)
        # slots with no valid token in this chunk report zeros
        last = torch.where(rows(n_valid > 0, logits[:, 0]), logits[:, 0], 0.0)
        return last, caches, positions + n_valid

    def prefill_scan(tokens, task_ids, caches, positions, valid, block_tables=None,
                     adapters=None, extras=None):
        last = None
        for i in range(tokens.shape[1]):
            vld = valid[:, i]
            batch = {"tokens": tokens[:, i : i + 1], "task_ids": task_ids}
            batch.update({k: t[:, i : i + 1] for k, t in (extras or {}).items()})
            logits, caches = model.decode_step(
                batch, caches, positions, live=vld, block_tables=block_tables,
                adapters=adapters,
            )
            step = logits[:, 0]
            last = torch.zeros_like(step) if last is None else last
            last = torch.where(rows(vld, step), step, last)
            positions = positions + vld.to(positions.dtype)
        return last, caches, positions

    return decode_tick, prefill_parallel if prefill_mode == "parallel" else prefill_scan


def make_serve_step(model, prefill_mode: str = "parallel", paging=None):
    decode_tick, prefill_body = _step_bodies(model, prefill_mode)

    def prefill_chunk(tokens, task_ids, caches, positions, valid, reset,
                      block_tables=None, adapters=None, extras=None):
        caches = model.reset_slot_state(caches, reset, paging)
        return prefill_body(tokens, task_ids, caches, positions, valid, block_tables,
                            adapters, extras)

    return decode_tick, prefill_chunk


def use_cuda_graphs(cuda_graphs: bool | None, device: torch.device) -> bool:
    """Resolve a ``cuda_graphs`` option for a model on ``device``: None is
    on for a CUDA model and off elsewhere; True off CUDA raises (only a
    CUDA stream can be captured)."""
    if cuda_graphs is None:
        return device.type == "cuda"
    if cuda_graphs and device.type != "cuda":
        raise ValueError(
            f"cuda_graphs=True needs a model on a CUDA device, not {device}; "
            "pass cuda_graphs=False (or None) to run the steps eagerly"
        )
    return bool(cuda_graphs)


def _pointers(tree) -> tuple:
    return tuple(t.data_ptr() for t in tree_lib.leaves(tree)) if tree is not None else ()


class _Step:
    """One step of the pair over its static inputs: a packed int32 host
    buffer (pinned on CUDA), its device copy and views of it, and, once
    captured, the graph and its outputs.

    Packed fields, in order: tokens (B, C) ((B, C, K) for K > 1 codebooks),
    task ids (B,), positions (B,) int32, the live / valid mask (B, C) as
    0/1, the (B, max_blocks) block table (paged only) and, for a VLM's
    prefill step (``vision_dim`` d_model), the (B, C) vision mask as 0/1.
    That step also holds a float32 (B, C, d_model) ``vision_embeds`` buffer
    with its own pinned host copy, uploaded only for a dispatch whose
    vision mask has a True (elsewhere the model reads no embedding)."""

    def __init__(self, b: int, c: int, max_blocks: int, device: torch.device,
                 codebooks: int = 1, vision_dim: int = 0):
        pinned = device.type == "cuda"
        tok_shape = (b, c) if codebooks == 1 else (b, c, codebooks)
        sizes = {"tokens": int(np.prod(tok_shape)), "task_ids": b, "positions": b,
                 "mask": b * c, "table": b * max_blocks, "vision": b * c if vision_dim else 0}
        n = sum(sizes.values())
        self.host = torch.zeros(n, dtype=torch.int32, pin_memory=pinned)
        self.dev = torch.zeros(n, dtype=torch.int32, device=device)
        host_np = self.host.numpy()
        self.fields, self.views, off = {}, {}, 0
        for name, size in sizes.items():
            self.fields[name] = host_np[off : off + size]
            self.views[name] = self.dev[off : off + size]
            off += size
        self.views["tokens"] = self.views["tokens"].view(tok_shape)
        self.views["mask"] = self.views["mask"].view(b, c)
        self.views["table"] = self.views["table"].view(b, max_blocks) if max_blocks else None
        self.views["vision"] = self.views["vision"].view(b, c) if vision_dim else None
        self.embeds = self.embeds_host = None
        if vision_dim:
            self.embeds_host = torch.zeros((b, c, vision_dim), pin_memory=pinned)
            self.embeds = torch.zeros((b, c, vision_dim), device=device)
        self.graph = None
        self.outputs = None
        self.launches = ()  # per counted op: kernels one replay launches
        self.bound = ()  # data pointers of the adapter tree the graph reads

    def fill(self, tokens, task_ids, positions, mask, table, vision=None) -> None:
        """Write one dispatch's inputs into the host buffer and start their
        upload on the current stream (one copy; a second for the vision
        embeddings when the ``vision`` (embeds, mask) pair masks any
        position in)."""
        self.fields["tokens"][:] = np.asarray(tokens).reshape(-1)
        self.fields["task_ids"][:] = task_ids
        self.fields["positions"][:] = positions
        self.fields["mask"][:] = np.asarray(mask).reshape(-1)
        if table is not None:
            self.fields["table"][:] = np.asarray(table).reshape(-1)
        if self.embeds is not None:
            emb, vmask = vision if vision is not None else (None, False)
            self.fields["vision"][:] = np.asarray(vmask).reshape(-1)
            if self.fields["vision"].any():
                self.embeds_host.numpy()[:] = emb
                self.embeds.copy_(self.embeds_host, non_blocking=True)
        self.dev.copy_(self.host, non_blocking=True)


class StepExecutor:
    """The step pair of one batcher over static device buffers.

    ``decode`` and ``prefill`` take host arrays (numpy), write them into
    one packed int32 buffer per step and upload it in one copy, run the
    step, and read the int32 results back in one copy, which waits for the
    device. With ``cuda_graphs`` on, each step is captured as one CUDA
    graph at its first dispatch (or at ``prepare``), and every later
    dispatch replays it; the two graphs share one memory pool. A capture or
    replay that fails raises: there is no eager fallback.

    Capture (``prepare``) first runs the step once eagerly on a side stream
    with every lane dead: dense dead lanes write each row's old value back
    and paged ones write only the null block 0, so the rows attention reads
    are unchanged. That run is where kernel libraries load and each kernel
    opts into its shared memory; its kernel launches count, since they
    execute. The capture itself executes nothing, so it counts none: the
    launches it records are added to the kernel wrappers' ``launches`` at
    every replay instead. ``capture_s`` is the host time of the warm-ups and
    captures, ``captures`` their number.

    The graphs bind the batcher's caches and the adapter serving tree given
    at capture; a dispatch with a tree whose leaves have moved raises.

    ``reset`` is applied eagerly before the prefill step, and only when it
    admits a slot: one ``index_fill_`` per per-slot cache tensor
    (``TransformerLM.reset_slot_state``), never inside a graph.

    The caches may mix entry kinds (a hybrid's K/V pairs and recurrent
    (conv_tail, ssm) states): the steps update every one in place, so the
    graphs bind them all by address."""

    def __init__(self, model, caches, num_slots: int, prefill_chunk: int,
                 prefill_mode: str = "parallel", paging=None, cuda_graphs: bool | None = None):
        self.model = model
        self.caches = caches
        self.paging = paging
        self.num_slots = num_slots
        self.cuda_graphs = use_cuda_graphs(cuda_graphs, model.device)
        self.decode_tick, self.prefill_body = _step_bodies(model, prefill_mode)
        cfg = model.cfg
        mb = paging.max_blocks_per_slot if paging is not None else 0
        k = cfg.num_codebooks
        vision = cfg.d_model if cfg.input_mode == "vlm" else 0
        self._steps = {
            "decode": _Step(num_slots, 1, mb, model.device, k),
            "prefill": _Step(num_slots, prefill_chunk, mb, model.device, k, vision),
        }
        self.capture_s = 0.0
        self.captures = 0
        self._pool = torch.cuda.graph_pool_handle() if self.cuda_graphs else None

    # ------------------------------------------------------------ steps
    def _run(self, kind: str, adapters):
        """The step on the static buffers, eagerly (or under capture).
        Returns (int32 results, logits): decode's next tokens (B,) ((B, K)
        for audio); prefill's greedy tokens, flat, then the new positions
        (B,)."""
        step = self._steps[kind]
        v = step.views
        mask = v["mask"] != 0
        if kind == "decode":
            nxt, logits, _ = self.decode_tick(
                v["tokens"][:, 0], v["task_ids"], self.caches, v["positions"], mask[:, 0],
                v["table"], adapters,
            )
            return nxt.to(torch.int32), logits
        extras = None
        if step.embeds is not None:
            extras = {"vision_embeds": step.embeds, "vision_mask": v["vision"] != 0}
        last, _, positions = self.prefill_body(
            v["tokens"], v["task_ids"], self.caches, v["positions"], mask, v["table"],
            adapters, extras,
        )
        greedy = last.argmax(dim=-1).to(torch.int32).reshape(-1)
        return torch.cat([greedy, positions.to(torch.int32)]), last

    def prepare(self, kind: str, adapters=None) -> None:
        """Capture step ``kind`` ("decode" or "prefill") now, as its first
        dispatch would, if graphs are on and it is not captured yet;
        ``adapters`` is the serving tree the graph will read."""
        step = self._steps[kind]
        if not self.cuda_graphs or step.graph is not None:
            return
        t0 = time.perf_counter()
        step.fill(0, self.model.cfg.num_tasks, 0, 0, 0)  # every lane dead, tables null
        graph = torch.cuda.CUDAGraph()
        # torch's one capture stream, shared by every capture in the process:
        # cuBLAS keeps a workspace for each stream it has run on, for good
        capture = torch.cuda.graph(graph, pool=self._pool)
        side = capture.capture_stream
        current = torch.cuda.current_stream(self.model.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._run(kind, adapters)  # the warm-up: every lane dead
            before = [op.launches for op in _COUNTED_OPS]
            try:
                with capture:
                    outputs = self._run(kind, adapters)
            except BaseException:
                # torch leaves a failed capture's pool registered as recording:
                # a later capture takes a fresh pool
                self._pool = torch.cuda.graph_pool_handle()
                raise
            finally:
                launched = tuple(op.launches - n for op, n in zip(_COUNTED_OPS, before))
                for op, n in zip(_COUNTED_OPS, before):
                    op.launches = n
        torch.cuda.synchronize(self.model.device)
        step.graph, step.outputs, step.launches = graph, outputs, launched
        step.bound = _pointers(adapters)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _dispatch(self, kind: str, adapters):
        step = self._steps[kind]
        if not self.cuda_graphs:
            return self._run(kind, adapters)
        if _pointers(adapters) != step.bound:
            raise RuntimeError(
                f"{kind} step: the adapter serving tree is not the one its CUDA graph was "
                "captured with (a leaf was reallocated); the store must update in place"
            )
        step.graph.replay()
        for op, n in zip(_COUNTED_OPS, step.launches):
            op.launches += n
        return step.outputs

    def decode(self, tokens, task_ids, positions, live, block_tables=None, adapters=None):
        """One decode tick. tokens, task_ids, positions: (B,) ints (tokens
        (B, K) for audio); live: (B,) bool; block_tables: (B, max_blocks)
        int32 (paged) or None. Returns (greedy next tokens (B,) ((B, K))
        numpy int32, step logits (B, V) ((B, K, V)) f32 on the device — a
        graph output, overwritten by the next tick)."""
        self.prepare("decode", adapters)
        with tracing.span(".pack"):
            self._steps["decode"].fill(tokens, task_ids, positions, live, block_tables)
        with tracing.span(".launch"):
            ints, logits = self._dispatch("decode", adapters)
        with tracing.span(".wait"):
            return ints.cpu().numpy(), logits

    def prefill(self, tokens, task_ids, positions, valid, reset, block_tables=None,
                adapters=None, vision=None):
        """One (B, C) prefill chunk ((B, C, K) tokens for audio). valid: (B,
        C) bool; reset: (B,) bool, the slots admitted by this dispatch;
        vision: a VLM chunk's (embeds (B, C, d_model) float32, mask (B, C)
        bool), or None for text only. Returns (greedy tokens after each
        slot's last valid token (B,) ((B, K)), those logits (B, V) ((B, K,
        V)) on the device, overwritten by the next chunk, new positions (B,)
        int32)."""
        self.prepare("prefill", adapters)
        with tracing.span(".pack"):
            reset = np.asarray(reset, bool)
            if reset.any():
                self.model.reset_slot_state(self.caches, reset, self.paging)
            self._steps["prefill"].fill(tokens, task_ids, positions, valid, block_tables, vision)
        with tracing.span(".launch"):
            ints, last = self._dispatch("prefill", adapters)
        with tracing.span(".wait"):
            out = ints.cpu().numpy()
        b = self.num_slots
        return out[:-b].reshape((b,) + last.shape[1:-1]), last, out[-b:]

    def close(self) -> None:
        """Release both graphs and their memory pool; a later dispatch
        captures again."""
        for step in self._steps.values():
            if step.graph is not None:
                step.graph.reset()
            step.graph = step.outputs = None
            step.launches = step.bound = ()
        if self.cuda_graphs:
            self._pool = torch.cuda.graph_pool_handle()


def make_cow_copy(paging):
    """The copy-on-write step of the prefix cache.

    Returns ``cow_copy(caches, src, dst, rows)``: copy rows ``[0, rows)`` of
    physical block ``src`` into block ``dst`` of every pool tensor, IN
    PLACE — one slice copy per pool, no host sync, nothing else of the pool
    touched. ``src``, ``dst`` and ``rows`` are host ints (the admission
    decision). Used when a request's prompt shares only the first ``rows``
    tokens of a cached block: the new slot gets a private copy of those
    rows and writes its own tail there, never into the aliased source.
    Every entry is a pool: the batcher refuses the prefix cache on a model
    with recurrent state."""
    if paging is None:
        raise ValueError("copy-on-write requires a paged cache layout")
    nb, bs = paging.num_blocks, paging.block_size

    def cow_copy(caches, src: int, dst: int, rows: int):
        if not (0 <= src < nb and 0 <= dst < nb and src != dst and 0 <= rows <= bs):
            raise ValueError(
                f"copy-on-write of rows [0, {rows}) from block {src} to block {dst}: "
                f"want distinct blocks in [0, {nb}) and rows in [0, {bs}]"
            )
        for pools in caches:
            for pool in pools:
                pool[dst, :rows].copy_(pool[src, :rows])
        return caches

    return cow_copy


def make_swap(paging, kinds):
    """The eager ``(swap_out, swap_in)`` pair of preemptive swap-out.

    ``swap_out(caches, blocks, slot=None)`` gathers the given physical
    blocks (a slot's real blocks, host ints) of every pool into one device
    staging tensor per pool row shape, one ``index_select`` per pool, and
    copies each to host memory in one copy: the pages, a list with one
    ``(pools of that shape, len(blocks), block_size, ...)`` tensor per
    distinct row shape in cache order, the pools in cache order within it
    and the blocks in ``blocks`` order. A GQA model has one, ``(2 *
    attention layers, len(blocks), block_size, KVH, hd)``, whose row ``2 i``
    holds the i-th attention layer's K pages and row ``2 i + 1`` its V
    pages; an MLA model two, its (…, kv_lora) latents and its (…, qk_rope)
    rotary keys; a model with no attention layer none. Beside them it
    copies the ``slot`` column of every dense
    per-slot entry (a recurrent layer's (conv_tail, ssm) state; ``kinds``,
    the model's ``kinds``, says which entries those are, as the
    reference's ``swap_out(caches, blocks, slot)`` takes them): the columns, a list of tensors in cache
    order. Returns the snapshot ``(pages, columns)``. On CUDA every part is
    pinned and every copy asynchronous.

    ``swap_in(caches, blocks, saved, slot=None)`` is the inverse: one upload
    per pages tensor and one ``index_copy_`` per pool into ``blocks`` (fresh
    ones, as many as were saved), and each column written into ``slot``
    (the slot the request is restored to). Every pool and state is written
    IN PLACE and keeps its ``data_ptr``, so the CUDA graphs that read them
    by address read the restored rows at their next replay.

    No host sync is needed in either direction. Both run on the current
    stream, between replays, like ``make_cow_copy``: the next replay's
    writes into blocks the swap-out freed are stream-ordered after the
    gather, and the swap-in's upload reads the snapshot only after the
    swap-out's copy has filled it. The staging tensors return to torch's
    stream-ordered caching allocator, and torch's pinned-memory cache does
    not reuse a snapshot's memory before the copies that use it complete.
    Only a reader on the host must synchronize before it looks at a
    snapshot taken on CUDA.

    Unlike the JAX pair, which pads the row to ``max_blocks_per_slot`` to
    keep one trace, the eager pair moves only the blocks given. Dense
    caches raise, as the reference's ``make_swap(None)`` does; a model with
    dense per-slot entries needs ``slot``."""
    if paging is None:
        raise ValueError("swap-out requires a paged cache layout")
    nb = paging.num_blocks

    def _ids(blocks, device):
        ids = [int(b) for b in blocks]
        if not ids or not all(0 < b < nb for b in ids):
            raise ValueError(
                f"swap of blocks {ids}: want at least one block id in [1, {nb})"
            )
        return torch.tensor(ids, dtype=torch.long, device=device)

    def _split(caches, slot):
        """(the pools grouped by row shape and dtype, in cache order; the
        dense per-slot states)."""
        pooled = [kind in ATTN_KINDS for kind in kinds]
        groups: dict = {}
        for entry, p in zip(caches, pooled):
            for t in entry if p else ():
                groups.setdefault((tuple(t.shape[1:]), t.dtype), []).append(t)
        states = [t for entry, p in zip(caches, pooled) if not p for t in entry]
        if states and slot is None:
            raise ValueError("swap of a model with per-slot recurrent state: pass its slot")
        return list(groups.values()), states

    def _host(t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` that no later step writes."""
        if t.device.type != "cuda":
            return t.clone()
        saved = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        saved.copy_(t, non_blocking=True)
        return saved

    def swap_out(caches, blocks, slot=None):
        groups, states = _split(caches, slot)
        idx = _ids(blocks, caches[0][0].device)
        pages = []
        for pools in groups:
            first = pools[0]
            staging = torch.empty((len(pools), len(idx)) + tuple(first.shape[1:]),
                                  dtype=first.dtype, device=first.device)
            for j, pool in enumerate(pools):
                # analysis: ignore[R001] -- _ids raises unless every id lies in [1, num_blocks)
                torch.index_select(pool, 0, idx, out=staging[j])
            pages.append(_host(staging))
        return pages, [_host(t[slot]) for t in states]

    def swap_in(caches, blocks, saved, slot=None):
        groups, states = _split(caches, slot)
        pages, columns = saved
        idx = _ids(blocks, caches[0][0].device)
        want = [((len(pools), len(idx)) + tuple(pools[0].shape[1:]), pools[0].dtype)
                for pools in groups]
        got = [(tuple(p.shape), p.dtype) for p in pages]
        if got != want or len(columns) != len(states) or any(
                c.shape != t.shape[1:] or c.dtype != t.dtype for c, t in zip(columns, states)):
            raise ValueError(
                f"swap-in of a snapshot of pages {got} and {len(columns)} state columns into "
                f"{len(idx)} blocks: want pages {want} and {len(states)} columns shaped as "
                "the states' rows"
            )
        for pools, saved_pages in zip(groups, pages):
            rows = saved_pages.to(pools[0].device, non_blocking=True)
            for j, pool in enumerate(pools):
                # analysis: ignore[R001] -- _ids raises unless every id lies in [1, num_blocks)
                pool.index_copy_(0, idx, rows[j])
        for t, col in zip(states, columns):
            t[slot].copy_(col, non_blocking=True)
        return caches

    return swap_out, swap_in
