"""The port's paging host code (repro_torch.serve.paging) against the JAX
package's (repro.serve.paging): PagingSpec sizing and its typed errors, the
refcounted BlockAllocator's lifecycle and errors, the RadixPrefixCache's
block-aligned capped matching, insertion, protection of an admission's own
match and lazy leaf-first LRU eviction, and the two caches driven in
lockstep by the same seeded admit / complete / retire sequences (the
driver of tests/test_serve_prefix.py) with identical block ids, refcounts,
free lists, COW descriptors and hit counts after every step. Pure host
code: exact equality, no tolerance."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import paging as jpaging  # noqa: E402
from repro_torch.serve.paging import (  # noqa: E402
    BlockAllocator,
    PagingSpec,
    RadixPrefixCache,
)


def test_paging_spec_sized_and_errors():
    spec = PagingSpec.sized(8, max_seq=32, pool_tokens=64)
    assert spec.num_blocks == 9  # 64/8 allocatable + the null block
    assert spec.max_blocks_per_slot == 4 and spec.tokens_per_slot == 32
    assert spec.pool_tokens == 72
    assert spec.blocks_for(1) == 1 and spec.blocks_for(16) == 2 and spec.blocks_for(17) == 3
    # the serving phase's spec: 2048 pool tokens of 16-token blocks, 1024 per slot
    big = PagingSpec.sized(16, 1024, 2048)
    assert (big.num_blocks, big.max_blocks_per_slot) == (129, 64)
    assert hash(big) == hash(PagingSpec(16, 129, 64))
    for bad, match in (((0, 4, 2), "block_size"), ((4, 1, 2), "num_blocks"),
                       ((4, 4, 0), "max_blocks_per_slot")):
        with pytest.raises(ValueError, match=match):
            PagingSpec(*bad)


def test_allocator_hands_out_ascending_ids_and_recycles():
    spec = PagingSpec(block_size=8, num_blocks=5, max_blocks_per_slot=4)
    alloc = BlockAllocator(spec)
    assert alloc.free_blocks == 4 and alloc.used_blocks == 0
    a = alloc.alloc(3)
    assert a == [1, 2, 3]  # ascending, never the null block 0
    assert not alloc.can_alloc(2)
    with pytest.raises(RuntimeError, match="out of KV blocks"):
        alloc.alloc(2)
    assert alloc.alloc(1) == [4]
    alloc.free(a)
    assert sorted(alloc.alloc(3)) == a  # freed blocks are recycled
    assert alloc.high_water == 4
    alloc.check_consistent()


def test_allocator_refcount_lifecycle():
    alloc = BlockAllocator(PagingSpec(block_size=4, num_blocks=6, max_blocks_per_slot=4))
    a, b = alloc.alloc(2)
    assert alloc.refcount[a] == 1 and alloc.refcount[b] == 1 and alloc.live_refs == 2
    alloc.incref([a])  # a second slot aliases a
    assert alloc.refcount[a] == 2
    assert alloc.decref([a]) == []  # still referenced
    assert alloc.decref([a, b]) == [a, b]  # zeroed but NOT reclaimed
    assert alloc.free_blocks == 3  # cached-idle blocks stay off the free list
    alloc.incref([a])  # revive a cached-idle block (a trie hit)
    alloc.free([a])
    alloc.reclaim([b])
    assert alloc.free_blocks == 5 and alloc.live_refs == 0
    expected = [0] * 6
    alloc.check_consistent(expected)
    (c,) = alloc.alloc(1)
    with pytest.raises(RuntimeError, match="leaked"):
        alloc.check_consistent(expected)
    expected[c] = 1
    alloc.check_consistent(expected)


def test_allocator_refcount_errors():
    alloc = BlockAllocator(PagingSpec(block_size=4, num_blocks=6, max_blocks_per_slot=4))
    (a,) = alloc.alloc(1)
    with pytest.raises(RuntimeError, match="foreign block id"):
        alloc.incref([0])
    with pytest.raises(RuntimeError, match="foreign block id"):
        alloc.decref([6])
    with pytest.raises(RuntimeError, match="incref of free block"):
        alloc.incref([a + 1])
    with pytest.raises(RuntimeError, match="double free"):
        alloc.decref([a + 1])
    alloc.incref([a])
    with pytest.raises(RuntimeError, match="shared block"):
        alloc.free([a])
    alloc.decref([a])
    alloc.free([a])
    with pytest.raises(RuntimeError, match="double free"):
        alloc.free([a])
    with pytest.raises(RuntimeError, match="reclaim of block"):
        alloc.reclaim(alloc.alloc(1))


def _fill(cache, task, tokens):
    """Admit + register a prompt as a finished request would; returns its
    table blocks."""
    admit = cache.admit(task, tokens, cache.allocator.spec.blocks_for(len(tokens)))
    if admit.cow is not None:
        cache.release([admit.cow[0]])
    cache.insert(task, tokens, list(admit.blocks))
    return list(admit.blocks)


def test_prefix_match_block_aligned_capped_and_task_keyed():
    spec = PagingSpec(block_size=4, num_blocks=12, max_blocks_per_slot=8)
    cache = RadixPrefixCache(BlockAllocator(spec))
    toks = np.arange(10, dtype=np.int32)  # blocks [0..3], [4..7] + tail
    blocks = _fill(cache, 0, toks)
    cache.release(blocks)
    m = cache.match(0, np.arange(12, dtype=np.int32))
    assert len(m.nodes) == 2 and m.partial is None and m.tokens == 8
    assert [n.block for n in m.nodes] == blocks[:2]
    # the len(prompt) - 1 cap: an identical prompt keeps its last token
    m = cache.match(0, toks[:8])
    assert len(m.nodes) == 1 and m.partial_rows == 3 and m.tokens == 7
    # diverging inside block 1: the shared rows are the COW source
    m = cache.match(0, np.array([0, 1, 2, 3, 4, 5, 99, 98, 97, 96], np.int32))
    assert len(m.nodes) == 1 and m.partial_rows == 2 and m.tokens == 6
    # another task shares nothing
    assert cache.match(1, np.arange(12, dtype=np.int32)).tokens == 0
    # match is read-only: no refcount moved
    assert cache.allocator.live_refs == 0
    cache.check_chains()


def test_prefix_admit_cow_descriptor_and_insert_keeps_existing_nodes():
    spec = PagingSpec(block_size=4, num_blocks=12, max_blocks_per_slot=8)
    cache = RadixPrefixCache(BlockAllocator(spec))
    first = _fill(cache, 0, np.arange(8, dtype=np.int32))
    admit = cache.admit(0, np.array([0, 1, 2, 3, 4, 5, 77, 78, 79], np.int32), 3)
    assert admit.blocks[0] == first[0] and admit.cached_tokens == 6
    src, dst, rows = admit.cow
    assert (src, rows) == (first[1], 2) and dst == admit.blocks[1]
    assert cache.allocator.refcount[src] == 2  # first's table + the COW pin
    cache.release([src])
    second = _fill(cache, 0, np.arange(8, dtype=np.int32))
    assert second[0] == first[0] and second[1] != first[1]  # private duplicate
    for held in (first, second, list(admit.blocks)):
        cache.release(held)
    assert cache.cached_blocks == 2  # the duplicate was never registered
    cache.check_chains()
    cache.allocator.check_consistent()


def test_lru_eviction_is_lazy_leaf_first_and_refcount0_only():
    spec = PagingSpec(block_size=4, num_blocks=7, max_blocks_per_slot=6)
    cache = RadixPrefixCache(BlockAllocator(spec))
    old = _fill(cache, 0, np.arange(100, 108, dtype=np.int32))
    hot = _fill(cache, 0, np.arange(200, 208, dtype=np.int32))
    cache.release(old)
    got = cache.alloc(4)
    assert len(got) == 4 and cache.evictions == 2
    assert [b for b, _ in cache.evicted_log] == [old[1], old[0]]  # leaf first
    assert all(rc == 0 for _, rc in cache.evicted_log)
    assert all(cache.allocator.refcount[b] == 1 for b in hot)
    with pytest.raises(RuntimeError, match="no evictable"):
        cache.alloc(1)


def test_admit_protects_its_own_match_from_eviction():
    spec = PagingSpec(block_size=4, num_blocks=7, max_blocks_per_slot=6)
    cache = RadixPrefixCache(BlockAllocator(spec))
    chain = _fill(cache, 0, np.arange(8, dtype=np.int32))
    cache.release(chain)
    admit = cache.admit(0, np.arange(24, dtype=np.int32), 6)
    assert admit.cached_tokens == 8 and list(admit.blocks[:2]) == chain
    assert cache.evictions == 0
    assert cache.admit(0, np.arange(24, dtype=np.int32), 6) is None  # backpressure
    cache.release(list(admit.blocks))
    cache.clear()
    assert cache.cached_blocks == 0 and cache.allocator.free_blocks == 6


def _random_ops(rng, n):
    ops = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:
            length = int(rng.integers(1, 15))
            ops.append(("admit", int(rng.integers(0, 2)),
                        [int(t) for t in rng.integers(0, 4, length)],
                        int(rng.integers(1, 5))))
        elif kind == 1:
            ops.append(("complete", int(rng.integers(0, 8))))
        else:
            ops.append(("retire", int(rng.integers(0, 8))))
    return ops


def _state(cache):
    a = cache.allocator
    return (list(a.refcount), list(a._free), cache.cached_blocks, cache.evictions,
            [b for b, _ in cache.evicted_log], cache.hit_tokens, cache.lookup_tokens)


@pytest.mark.parametrize("seed", range(8))
def test_radix_cache_lockstep_with_jax(seed):
    """The same seeded op sequence through both caches: identical block
    ids, COW descriptors, refcounts, free lists, evictions and hit counts
    after every step."""
    ops = _random_ops(np.random.default_rng(seed), 60)
    caches = []
    for mod in (jpaging, None):
        if mod is None:
            spec = PagingSpec(block_size=4, num_blocks=13, max_blocks_per_slot=5)
            caches.append(RadixPrefixCache(BlockAllocator(spec)))
        else:
            spec = mod.PagingSpec(block_size=4, num_blocks=13, max_blocks_per_slot=5)
            caches.append(mod.RadixPrefixCache(mod.BlockAllocator(spec)))
    lives = [[], []]  # per cache: [task, tokens, blocks, registered]
    admits = 0
    for op in ops:
        if op[0] == "admit":
            _, task, tokens, max_new = op
            total = spec.blocks_for(len(tokens) + max_new)
            if total <= spec.max_blocks_per_slot:
                want, got = (cache.admit(task, tokens, total) for cache in caches)
                assert (want is None) == (got is None)
                if want is not None:
                    assert (tuple(want.blocks), want.cached_tokens, want.cow) == (
                        tuple(got.blocks), got.cached_tokens, got.cow)
                    admits += 1
                    for cache, live, adm in zip(caches, lives, (want, got)):
                        if adm.cow is not None:
                            cache.release([adm.cow[0]])  # the copy is done
                        live.append([task, tokens, list(adm.blocks), False])
        elif op[0] == "complete":
            for cache, live in zip(caches, lives):
                if live and not live[op[1] % len(live)][3]:
                    entry = live[op[1] % len(live)]
                    cache.insert(entry[0], entry[1], entry[2])
                    entry[3] = True
        else:
            for cache, live in zip(caches, lives):
                if live:
                    cache.release(live.pop(op[1] % len(live))[2])
        assert _state(caches[0]) == _state(caches[1])
        caches[1].check_chains()
        caches[1].allocator.check_consistent()
    assert admits > 5
