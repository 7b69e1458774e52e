"""Paged KV-cache layout: block tables, a refcounted host-side block
allocator, and the radix prefix cache.

The port's own copy of ``repro.serve.paging`` (numpy only; nothing of the
JAX package is imported). Attention caches are a SHARED pool of pages per
layer,

    k_pool, v_pool : (num_blocks, block_size, KVH, hd)

plus ONE per-slot block table ``(num_slots, max_blocks_per_slot)`` of
physical block ids, shared by every layer. Logical position ``p`` of slot
``b`` lives at ``pool[table[b, p // block_size], p % block_size]``.

Invariants (everything downstream relies on these):

  * block 0 is the NULL block, never handed out. Dead slots and masked-out
    prefill lanes write to it, so the step never needs a conditional;
    unmapped table entries are 0, and whatever lies behind them is masked
    by ``kv_idx <= pos``.
  * allocation is per REQUEST, on the host: the batcher reserves
    ``ceil((len(prompt) + max_new) / block_size)`` blocks at admission and
    releases them when the request retires. A request that cannot get its
    blocks waits in the queue (admission backpressure).
  * freed blocks are recycled WITHOUT clearing: every position ``<= pos``
    of a live slot was written by that slot, and later positions are
    masked off.

Prefix sharing (``RadixPrefixCache`` + the allocator's refcounts): a block
holding a fully prefilled PROMPT chunk may be aliased read-only by several
slots' tables, each holding a reference. Writes never land in a shared
block: admission copy-on-writes the one partially shared block first.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PagingSpec:
    """Static shape of the paged cache (hashable: it keys the copy-on-write step).

    num_blocks counts PHYSICAL blocks including the reserved null block 0,
    so ``num_blocks - 1`` blocks are allocatable. ``max_blocks_per_slot``
    bounds one slot's logical length: a slot can hold at most
    ``max_blocks_per_slot * block_size`` tokens.
    """

    block_size: int
    num_blocks: int
    max_blocks_per_slot: int

    def __post_init__(self):
        # typed errors, not asserts: these guard every downstream layout
        # computation and must survive `python -O`
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {self.block_size}")
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (>= 1 allocatable block + the "
                f"reserved null block 0), got {self.num_blocks}"
            )
        if self.max_blocks_per_slot <= 0:
            raise ValueError(
                f"max_blocks_per_slot must be positive, got "
                f"{self.max_blocks_per_slot}"
            )

    @property
    def tokens_per_slot(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    @property
    def pool_tokens(self) -> int:
        """Token capacity of the shared pool (incl. the null block)."""
        return self.num_blocks * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        """Physical blocks needed to hold ``n_tokens`` logical positions."""
        return -(-n_tokens // self.block_size)

    @staticmethod
    def sized(
        block_size: int, max_seq: int, pool_tokens: int
    ) -> "PagingSpec":
        """Spec whose pool holds ``pool_tokens`` KV entries (plus the null
        block) and whose slots can each reach ``max_seq`` positions."""
        return PagingSpec(
            block_size=block_size,
            num_blocks=pool_tokens // block_size + 1,
            max_blocks_per_slot=-(-max_seq // block_size),
        )


class BlockAllocator:
    """Host-side refcounted free list over physical blocks ``1..num_blocks-1``.

    Pure bookkeeping — it never touches device memory. Every allocatable
    block is in exactly one of three states:

      * **free** — on the free list, ``refcount == 0``. Only these are
        handed out by ``alloc`` (which sets ``refcount = 1``).
      * **live** — ``refcount >= 1``: referenced by that many slot block
        tables (plus, transiently, an admission-time pin on a COW source).
      * **cached-idle** — ``refcount == 0`` but NOT on the free list: held
        only by the prefix cache's trie, waiting to be revived (``incref``)
        or evicted (``reclaim``). Without a prefix cache this state never
        occurs.

    The single-owner batcher path uses ``alloc`` + ``free`` exactly as
    before; the prefix-sharing path uses ``incref``/``decref``/``reclaim``
    so one block can back the same prompt prefix in many slots.
    """

    def __init__(self, spec: PagingSpec):
        self.spec = spec
        # pop() hands out ascending ids first — deterministic tables for tests
        self._free = list(range(spec.num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self.refcount = [0] * spec.num_blocks
        self.high_water = 0  # max blocks simultaneously allocated

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.spec.num_blocks - 1) - len(self._free)

    @property
    def live_refs(self) -> int:
        """Sum of refcounts — equals the number of live block-table entries
        (plus transient COW pins) when the batcher's bookkeeping is sound."""
        return sum(self.refcount[1:])

    def _check_id(self, b: int) -> None:
        # typed errors, not asserts: a bad id reaching the free list would
        # later be handed to TWO live slots, whose KV writes would silently
        # corrupt each other. Must survive `python -O`.
        if not 0 < b < self.spec.num_blocks:
            raise RuntimeError(f"foreign block id {b}")

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if not self.can_alloc(n):
            raise RuntimeError(
                f"out of KV blocks: requested {n}, free {len(self._free)}"
            )
        blocks = []
        for _ in range(n):
            b = self._free.pop()
            self._free_set.discard(b)
            if self.refcount[b] != 0:
                raise RuntimeError(
                    f"block {b} was on the free list with refcount "
                    f"{self.refcount[b]}"
                )
            self.refcount[b] = 1
            blocks.append(b)
        self.high_water = max(self.high_water, self.used_blocks)
        return blocks

    def incref(self, blocks: list[int]) -> None:
        """Add a reference to each block (aliasing into another slot's
        table, reviving a cached-idle block, or pinning a COW source).
        Free-listed blocks cannot be revived — they must go through
        ``alloc``."""
        for b in blocks:
            self._check_id(b)
            if b in self._free_set:
                raise RuntimeError(f"incref of free block {b}")
            self.refcount[b] += 1

    def decref(self, blocks: list[int]) -> list[int]:
        """Drop one reference per block; returns the blocks that reached
        refcount 0 WITHOUT reclaiming them — the caller decides whether a
        zeroed block returns to the free list or stays cached-idle in the
        prefix trie."""
        zeroed = []
        for b in blocks:
            self._check_id(b)
            if self.refcount[b] <= 0:
                raise RuntimeError(f"double free of block {b}")
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                zeroed.append(b)
        return zeroed

    def reclaim(self, blocks: list[int]) -> None:
        """Return refcount-0 blocks to the free list."""
        for b in blocks:
            self._check_id(b)
            if self.refcount[b] != 0:
                raise RuntimeError(
                    f"reclaim of block {b} with refcount {self.refcount[b]}"
                )
            if b in self._free_set:
                raise RuntimeError(f"double free of block {b}")
            self._free.append(b)
            self._free_set.add(b)
        if len(self._free) > self.spec.num_blocks - 1:
            raise RuntimeError(
                f"free list holds {len(self._free)} blocks but only "
                f"{self.spec.num_blocks - 1} are allocatable"
            )

    def free(self, blocks: list[int]) -> None:
        """Single-owner release: refcount 1 -> 0 and straight back to the
        free list (the pre-refcount contract; shared blocks must go through
        ``decref``)."""
        for b in blocks:
            self._check_id(b)
            if b in self._free_set or self.refcount[b] == 0:
                raise RuntimeError(f"double free of block {b}")
            if self.refcount[b] != 1:
                raise RuntimeError(
                    f"free of shared block {b} (refcount {self.refcount[b]}) "
                    "— shared references must be released via decref"
                )
        self.reclaim(self.decref(blocks))

    def check_consistent(self, expected: list[int] | None = None) -> None:
        """Reconciliation pass: free-list/refcount coherence, and — when
        the caller supplies per-block expected reference counts (computed
        from its own tables) — exact agreement with them. Raises
        ``RuntimeError`` on the first violation."""
        if len(self._free) != len(self._free_set):
            raise RuntimeError(
                f"free list holds {len(self._free)} entries but "
                f"{len(self._free_set)} distinct blocks — duplicate free"
            )
        for b in self._free:
            self._check_id(b)
            if self.refcount[b] != 0:
                raise RuntimeError(
                    f"block {b} is on the free list with refcount "
                    f"{self.refcount[b]}"
                )
        if self.refcount[0] != 0:
            raise RuntimeError(
                f"null block 0 holds refcount {self.refcount[0]} — it must "
                "never be handed out"
            )
        if expected is not None:
            for b in range(1, self.spec.num_blocks):
                if self.refcount[b] != expected[b]:
                    raise RuntimeError(
                        f"block {b}: allocator refcount {self.refcount[b]} "
                        f"but {expected[b]} table reference(s) — "
                        f"{'leaked' if self.refcount[b] > expected[b] else 'dangling'}"
                        " reference"
                    )


def _key_seq(tokens) -> list:
    """Hashable per-position keys for trie matching: ints for flat prompts,
    tuples for (S0, K) codebook rows."""
    arr = np.asarray(tokens)
    if arr.ndim == 1:
        return [int(t) for t in arr]
    return [tuple(int(x) for x in row) for row in arr]


class _PrefixNode:
    """One full prompt block in the radix trie. ``key`` is the block's
    ``block_size``-tuple of token keys; the root sentinel has ``key=()``
    and ``block=-1``."""

    __slots__ = ("key", "block", "parent", "children", "last_use")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children = {}
        self.last_use = 0


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Longest cached prefix for one (task_id, prompt) lookup."""

    nodes: tuple  # matched full-block chain, root-first
    partial: object  # trie node sharing only the first `partial_rows` of
    partial_rows: int  # the next block (COW source), or None
    tokens: int  # total reusable tokens: len(nodes) * block_size + rows


@dataclasses.dataclass(frozen=True)
class PrefixAdmit:
    """Admission decision: the slot's table-order block ids (aliased prefix
    chain first, then freshly allocated tail), how many prompt tokens are
    already in cache, and — when the last reusable block is only partially
    shared — the ``(src, dst, rows)`` copy-on-write the executor must
    dispatch before prefill (then ``release([src])`` to drop the pin)."""

    blocks: tuple
    cached_tokens: int
    cow: tuple | None


class RadixPrefixCache:
    """vLLM/SGLang-style radix prefix cache over the refcounted allocator.

    Keyed on (task_id, token ids): per-task adapters make KV task-dependent
    (the JAX package's graph-mixed adapters), so identical token prefixes
    under different tasks never alias.
    Only FULL prompt blocks are inserted, and only once their prefill has
    completed — a block is registered iff every row holds final KV values,
    so aliasing it read-only is always sound.

    Refcounts count slot-table references; trie membership itself holds no
    reference. A registered block whose refcount drops to 0 stays
    **cached-idle** (off the free list, evictable) instead of being
    reclaimed — that pool is the LRU eviction ground ``alloc`` harvests
    lazily when the free list runs dry, replacing hard backpressure.
    Holders reference their whole prefix chain, so ``parent.refcount >=
    child.refcount`` and refcount-0 subtrees can always be evicted
    leaf-first.
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self.block_size = allocator.spec.block_size
        self._roots: dict = {}  # task_id -> sentinel node
        self._node_of_block: dict = {}  # block id -> node
        self._clock = 0
        # stats (hit ratio of the lookups)
        self.lookups = 0
        self.lookup_tokens = 0
        self.hit_tokens = 0
        self.evictions = 0
        # (block, refcount at eviction) of every eviction, for tests
        self.evicted_log: list = []

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- queries
    @property
    def cached_blocks(self) -> int:
        return len(self._node_of_block)

    @property
    def hit_ratio(self) -> float:
        return self.hit_tokens / max(1, self.lookup_tokens)

    def match(self, task_id: int, tokens) -> PrefixMatch:
        """Longest cached block-aligned prefix (read-only — no refcount or
        LRU side effects). Matching is capped at ``len(prompt) - 1`` so an
        admitted slot always computes at least its last prompt token (the
        logits that emit the first generated token)."""
        keys = _key_seq(tokens)
        bs = self.block_size
        limit = len(keys) - 1
        chain: list = []
        partial, rows = None, 0
        node = self._roots.get(task_id)
        if node is not None:
            matched = 0
            while matched + bs <= limit:
                child = node.children.get(tuple(keys[matched : matched + bs]))
                if child is None:
                    break
                chain.append(child)
                node = child
                matched += bs
            # partial tail: a child sharing a strict prefix of the next
            # (sub-block) span — the copy-on-write source
            rest = keys[matched:limit]
            for key, child in node.children.items():
                j = 0
                while j < len(rest) and j < len(key) and key[j] == rest[j]:
                    j += 1
                if j > rows:
                    rows, partial = j, child
        return PrefixMatch(
            tuple(chain), partial, rows,
            len(chain) * bs + rows,
        )

    def _protected(self, m: PrefixMatch) -> set:
        prot = {n.block for n in m.nodes}
        if m.partial is not None:
            prot.add(m.partial.block)
        return prot

    def _evictable(self, protect: frozenset | set = frozenset()) -> list:
        rc = self.allocator.refcount
        return [
            b for b in self._node_of_block
            if rc[b] == 0 and b not in protect
        ]

    def can_admit(self, fresh: int, m: PrefixMatch) -> bool:
        """Backpressure check: fresh blocks are covered by the free list
        plus evictable cached-idle blocks NOT pinned by this match."""
        avail = self.allocator.free_blocks + len(self._evictable(self._protected(m)))
        return fresh <= avail

    def can_alloc(self, n: int) -> bool:
        """Can ``n`` blocks be produced WITHOUT trie matching (free list +
        every evictable cached-idle block)? No match pins anything."""
        return n <= self.allocator.free_blocks + len(self._evictable())

    def check_chains(self) -> None:
        """Trie structural reconciliation: node<->block bijectivity, parent
        linkage, chain-monotone refcounts (holders reference their WHOLE
        prefix chain, so ``parent.refcount >= child.refcount``), and no
        registered block on the free list. Raises ``RuntimeError`` on the
        first violation."""
        rc = self.allocator.refcount
        seen: set = set()
        for task, root in self._roots.items():
            stack = [root]
            while stack:
                node = stack.pop()
                for key, child in node.children.items():
                    if child.parent is not node or child.key != key:
                        raise RuntimeError(
                            f"task {task}: trie node for block {child.block} "
                            "has broken parent/key linkage"
                        )
                    if self._node_of_block.get(child.block) is not child:
                        raise RuntimeError(
                            f"task {task}: block {child.block} not (or "
                            "wrongly) registered in the block index"
                        )
                    if child.block in seen:
                        raise RuntimeError(
                            f"block {child.block} registered at two trie "
                            "positions"
                        )
                    seen.add(child.block)
                    if child.block in self.allocator._free_set:
                        raise RuntimeError(
                            f"registered block {child.block} is on the free "
                            "list — it would be handed to a live slot while "
                            "still aliasable"
                        )
                    if node.block != -1 and rc[node.block] < rc[child.block]:
                        raise RuntimeError(
                            f"chain refcounts not monotone: parent block "
                            f"{node.block} ({rc[node.block]}) < child "
                            f"{child.block} ({rc[child.block]})"
                        )
                    stack.append(child)
        orphans = set(self._node_of_block) - seen
        if orphans:
            raise RuntimeError(
                f"blocks {sorted(orphans)} are in the block index but "
                "unreachable from any trie root"
            )

    # ------------------------------------------------------------ eviction
    def _drop(self, node: _PrefixNode) -> None:
        self.evicted_log.append((node.block, self.allocator.refcount[node.block]))
        del node.parent.children[node.key]
        del self._node_of_block[node.block]
        self.evictions += 1
        self.allocator.reclaim([node.block])

    def _evict_one(self, protect: set) -> None:
        """Evict the least-recently-used refcount-0 LEAF (children must go
        before parents so surviving chains stay contiguous)."""
        rc = self.allocator.refcount
        best = None
        for b, node in self._node_of_block.items():
            if rc[b] != 0 or b in protect or node.children:
                continue
            if best is None or node.last_use < best.last_use:
                best = node
        if best is None:
            raise RuntimeError(
                "prefix cache: free list empty and no evictable "
                "refcount-0 block"
            )
        self._drop(best)

    def alloc(self, n: int, protect: set = frozenset()) -> list[int]:
        """Allocate ``n`` blocks, lazily evicting LRU cached-idle blocks
        when the free list cannot cover them."""
        while self.allocator.free_blocks < n:
            self._evict_one(protect)
        return self.allocator.alloc(n)

    # ----------------------------------------------------------- admission
    def admit(self, task_id: int, tokens, total_blocks: int) -> PrefixAdmit | None:
        """One admission: match, backpressure-check, pin the matched chain
        (incref), allocate the fresh tail (evicting as needed, never the
        pinned chain). Returns None when live + unreclaimable memory truly
        cannot cover the request."""
        keys_len = len(_key_seq(tokens))
        m = self.match(task_id, tokens)
        fresh_needed = total_blocks - len(m.nodes)
        if not self.can_admit(fresh_needed, m):
            return None
        self.lookups += 1
        self.lookup_tokens += keys_len
        self.hit_tokens += m.tokens
        t = self._tick()
        pinned = [n.block for n in m.nodes]
        for n in m.nodes:
            n.last_use = t
        if m.partial is not None:
            pinned.append(m.partial.block)
            m.partial.last_use = t
        self.allocator.incref(pinned)
        fresh = self.alloc(fresh_needed, self._protected(m))
        blocks = [n.block for n in m.nodes] + fresh
        cow = None
        if m.partial is not None:
            # the fresh block at table index len(nodes) receives the
            # partially-shared rows; the source stays pinned until the
            # executor's copy dispatch retires, then release([src])
            cow = (m.partial.block, fresh[0], m.partial_rows)
        return PrefixAdmit(tuple(blocks), m.tokens, cow)

    def insert(self, task_id: int, tokens, blocks: list[int]) -> None:
        """Register a COMPLETELY prefilled prompt's full blocks. Called by
        the executor when ``prompt_done == len(tokens)`` — never earlier,
        so no partially-written block is ever aliasable. Existing nodes win
        duplicate keys (the slot's private duplicate stays unregistered and
        is reclaimed at release)."""
        keys = _key_seq(tokens)
        bs = self.block_size
        node = self._roots.setdefault(task_id, _PrefixNode((), -1, None))
        t = self._tick()
        for i in range(len(keys) // bs):
            key = tuple(keys[i * bs : (i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                b = blocks[i]
                if b in self._node_of_block:
                    raise RuntimeError(
                        f"block {b} already registered at another trie "
                        "position"
                    )
                child = _PrefixNode(key, b, node)
                node.children[key] = child
                self._node_of_block[b] = child
            child.last_use = t
            node = child

    def release(self, blocks: list[int]) -> None:
        """Drop one reference per block (slot finish / cancel / timeout /
        COW-source unpin). Zeroed blocks registered in the trie stay
        cached-idle for future hits; unregistered ones go straight back to
        the free list."""
        zeroed = self.allocator.decref(blocks)
        self.allocator.reclaim(
            [b for b in zeroed if b not in self._node_of_block]
        )

    def clear(self) -> None:
        """Drop every cached-idle block (leaf-first). Blocks still
        referenced by live slots stay registered."""
        while True:
            rc = self.allocator.refcount
            leaves = [
                n for b, n in self._node_of_block.items()
                if rc[b] == 0 and not n.children
            ]
            if not leaves:
                return
            for n in leaves:
                self._drop(n)
