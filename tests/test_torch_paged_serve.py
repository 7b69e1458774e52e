"""Paged serving of the port (repro_torch.serve with ``paging=`` and
``prefix_cache=True``) against the JAX package's, on the olmo_1b and
qwen2_5_14b smoke configs with converted weights, CPU, float32: greedy
tokens token for token, dispatch and prefill-token counts, block tables and
copy-on-write counts equal to JAX's, at block sizes 8 and 16, in both
``chunk_budget`` regimes; staggered reuse of freed blocks, admission
backpressure and its order, submit rejections, cancel and timeout freeing
blocks, dense == paged inside the port; the prefix cache's shared-prefix
parity with fewer prefill tokens, an identical prompt served twice, forced
eviction, sjf by uncached tokens, engine admission waves with
``last_prefix_stats`` equal to JAX's. Greedy tokens and counters are
compared exactly (no tolerance)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.serve import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serve import PagingSpec as JaxPagingSpec  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    PagingSpec,
    Request,
    ServeEngine,
)

ARCHS = ["olmo_1b", "qwen2_5_14b"]
MAX_SEQ = 48
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def reference_cow_cache_cleared():
    """The JAX package's ``make_cow_copy`` is an lru_cache keyed by the
    paging spec, and its jitted function keeps the traces of this module's
    reference runs: cleared after the module, so that a later module in
    the same process starts from no trace (tests/test_serve_prefix.py
    counts the traces of this spec's copy)."""
    yield
    from repro.serve.step import make_cow_copy

    make_cow_copy.cache_clear()


def _models(arch, backend="kernel"):
    """(JAX model, JAX params, port model on the CPU with the same weights)."""
    if arch not in _CACHE:
        jm = JaxLM(jax_get(arch, smoke=True))
        _CACHE[arch] = (jm, jm.init(jax.random.PRNGKey(0)))
    jm, params = _CACHE[arch]
    cfg = dataclasses.replace(get(arch, smoke=True), attn_backend=backend)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _spec(block_size=8, pool_tokens=4 * MAX_SEQ, jax_spec=False):
    cls = JaxPagingSpec if jax_spec else PagingSpec
    return cls.sized(block_size, MAX_SEQ, pool_tokens)


def _batchers(arch, backend="kernel", *, block_size=8, pool_tokens=4 * MAX_SEQ,
              spec_args=None, **kw):
    """A JAX batcher and a port batcher built alike. ``spec_args`` gives an
    exact (block_size, num_blocks, max_blocks_per_slot) instead of sized."""
    jm, params, tm = _models(arch, backend)
    if spec_args is not None:
        jspec, tspec = JaxPagingSpec(*spec_args), PagingSpec(*spec_args)
    else:
        jspec = _spec(block_size, pool_tokens, jax_spec=True)
        tspec = _spec(block_size, pool_tokens)
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_chunk", 4)
    jb = JaxBatcher(jm, params, max_seq=MAX_SEQ, paging=jspec, **kw)
    tb = ContinuousBatcher(tm, max_seq=MAX_SEQ, paging=tspec, **kw)
    return jb, tb


def _tables_log(batcher):
    """Record every (slot, blocks) the batcher puts in its block table."""
    log = []
    orig = batcher._set_table

    def set_table(s, blocks):
        log.append((s, tuple(int(b) for b in blocks)))
        orig(s, blocks)

    batcher._set_table = set_table
    return log


def _drive(batcher, req_cls, reqs):
    for r in reqs:
        batcher.submit(req_cls(**r))
    done = batcher.run()
    return {r.uid: list(map(int, r.out)) for r in done}


def _counts(b):
    return (b.decode_dispatches, b.prefill_dispatches, b.mixed_dispatches, b.prefill_tokens,
            b.cow_copies)


def _ragged(cfg, lens, seed=0, max_new=4):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, tokens=rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
                 max_new=max_new, task_id=i % cfg.num_tasks) for i, n in enumerate(lens)]


def _shared(cfg, n, shared_len, suffix_len, seed=0, max_new=4):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, shared_len).astype(np.int32)
    return [dict(uid=i, max_new=max_new, tokens=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, suffix_len).astype(np.int32)]))
        for i in range(n)]


# -------------------------------------------------------------- paged mode
@pytest.mark.parametrize("chunk_budget", [None, 5])
@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_batcher_matches_jax(arch, block_size, chunk_budget):
    """Ragged prompts, more requests than slots: the same tokens, the same
    dispatches and the same block tables (ascending ids, freed blocks
    reused) as the JAX paged batcher."""
    jb, tb = _batchers(arch, block_size=block_size, chunk_budget=chunk_budget)
    reqs = _ragged(tb.model.cfg, (13, 8, 21, 5, 30))
    jlog, tlog = _tables_log(jb), _tables_log(tb)
    want = _drive(jb, JaxRequest, reqs)
    got = _drive(tb, Request, reqs)
    assert got == want and len(got) == 5
    assert (jb.decode_dispatches, jb.prefill_dispatches, jb.mixed_dispatches,
            jb.prefill_tokens) == _counts(tb)[:4]
    assert tlog == jlog
    assert tb.allocator.free_blocks == tb.paging.num_blocks - 1
    assert not tb.block_tables.any()


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_dense_equals_paged_in_the_port(backend):
    """The same requests through the port's dense cache and its paged pool
    (block sizes 8 and 16) give the same greedy tokens."""
    _, _, tm = _models("qwen2_5_14b", backend)
    reqs = _ragged(tm.cfg, (9, 17, 3, 25), seed=3, max_new=6)
    dense = _drive(ContinuousBatcher(tm, num_slots=2, max_seq=MAX_SEQ, prefill_chunk=4),
                   Request, reqs)
    for bs in (8, 16):
        paged = _drive(ContinuousBatcher(tm, num_slots=2, max_seq=MAX_SEQ, prefill_chunk=4,
                                         paging=_spec(bs)), Request, reqs)
        assert paged == dense


def test_staggered_admission_reuses_freed_blocks_like_jax():
    """Demand above the pool: finished requests free their blocks and later
    admissions recycle the SAME physical ids as in JAX."""
    spec_args = (8, 7, 4)  # 6 allocatable blocks of 8
    jb, tb = _batchers("qwen2_5_14b", spec_args=spec_args)
    lens = (9, 5, 17, 3, 11, 7)
    reqs = _ragged(tb.model.cfg, lens, seed=1)
    assert sum(tb.paging.blocks_for(n + 4) for n in lens) > 6
    jlog, tlog = _tables_log(jb), _tables_log(tb)
    assert _drive(tb, Request, reqs) == _drive(jb, JaxRequest, reqs)
    assert tlog == jlog
    reused = [b for _, blocks in tlog for b in blocks]
    assert len(reused) > len(set(reused))  # physical blocks were recycled
    assert tb.allocator.high_water <= 6 and tb.allocator.free_blocks == 6


def test_admission_backpressure_waits_then_admits_in_order():
    """Two free slots but blocks for one request: the second waits queued
    (counted in admission_waits) and the third, though its one block would
    fit, does not jump it (head-of-line order); both are admitted when the
    first finishes, with the same block tables and tokens as JAX."""
    jb, tb = _batchers("qwen2_5_14b", spec_args=(8, 4, 2))  # 3 blocks of 8
    reqs = _ragged(tb.model.cfg, (9, 9, 4), seed=2)
    jlog, tlog = _tables_log(jb), _tables_log(tb)
    for r in reqs:
        tb.submit(Request(**r))
    tb._admit()
    assert [r is not None for r in tb.slots.reqs] == [True, False]
    assert [r.uid for r in tb.queue] == [1, 2] and tb.admission_waits == 1
    assert tb.allocator.free_blocks == 1  # request 2 would fit, yet waits
    tb.run()
    got = {r.uid: list(map(int, r.out)) for r in tb.finished}
    assert got == _drive(jb, JaxRequest, reqs)
    assert tlog == jlog
    assert [len(blocks) for _, blocks in tlog] == [2, 2, 1]  # requests 0, 1, 2
    assert tb.allocator.free_blocks == 3


def test_submit_rejections_paged():
    _, _, tm = _models("qwen2_5_14b")
    small = ContinuousBatcher(tm, num_slots=1, max_seq=MAX_SEQ,
                              paging=PagingSpec(block_size=8, num_blocks=3,
                                                max_blocks_per_slot=4))
    with pytest.raises(ValueError, match="KV blocks"):  # 25 tokens: 4 blocks of 2
        small.submit(Request(uid=0, tokens=np.arange(17, dtype=np.int32), max_new=8))
    narrow = ContinuousBatcher(tm, num_slots=1, max_seq=MAX_SEQ,
                               paging=PagingSpec(block_size=8, num_blocks=16,
                                                 max_blocks_per_slot=2))
    assert narrow.slot_capacity == 16  # min(max_seq, 2 blocks x 8)
    with pytest.raises(ValueError, match="capacity"):
        narrow.submit(Request(uid=1, tokens=np.arange(10, dtype=np.int32), max_new=8))
    assert not narrow.queue and not small.queue


def test_cancel_and_timeout_free_blocks():
    _, _, tm = _models("olmo_1b")
    clock = [0.0]
    b = ContinuousBatcher(tm, num_slots=2, max_seq=MAX_SEQ, prefill_chunk=4,
                          paging=_spec(8), now_fn=lambda: clock[0])
    reqs = _ragged(tm.cfg, (7, 6, 7), seed=4, max_new=8)
    b.submit(Request(**reqs[0]))
    b.submit(Request(**reqs[1], timeout_s=5.0))
    b.submit(Request(**reqs[2]))
    b.step()
    held = b.paging.num_blocks - 1 - b.allocator.free_blocks
    assert held == 2 + 2  # 15 and 14 tokens: two blocks each
    assert b.cancel(0)  # mid-flight
    assert b.allocator.free_blocks == b.paging.num_blocks - 1 - 2
    assert not b.block_tables[0].any() and not b.slot_blocks[0]
    clock[0] = 10.0
    b.step()  # request 1 times out; request 2 takes slot 0
    done = {r.uid: r for r in b.finished}
    assert done[0].cancelled and done[1].timed_out
    b.run()
    assert len({r.uid: r for r in b.finished}[2].out) == 8
    assert b.allocator.free_blocks == b.paging.num_blocks - 1
    b.allocator.check_consistent()


# ------------------------------------------------------------ prefix cache
@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_shared_prefix_matches_jax_with_fewer_prefill_tokens(arch, block_size):
    """20 shared + 12 unique tokens: wave-2 hits share the boundary block in
    part, so COW fires. Tokens, prefill tokens, COW copies and hit counts
    equal JAX's; the cache computes fewer prefill tokens than no cache."""
    jb, tb = _batchers(arch, block_size=block_size, prefix_cache=True, prefill_chunk=16)
    reqs = _shared(tb.model.cfg, 4, 20, 12)
    got = _drive(tb, Request, reqs)
    assert got == _drive(jb, JaxRequest, reqs)
    assert _counts(tb) == _counts(jb)
    assert (tb.prefix.hit_tokens, tb.prefix.lookup_tokens) == (
        jb.prefix.hit_tokens, jb.prefix.lookup_tokens)
    assert tb.cow_copies >= 1 and tb.prefix.hit_tokens > 0
    base = ContinuousBatcher(tb.model, num_slots=2, max_seq=MAX_SEQ, prefill_chunk=16,
                             paging=_spec(block_size))
    assert _drive(base, Request, reqs) == got
    assert tb.prefill_tokens < base.prefill_tokens
    assert tb.allocator.live_refs == 0
    assert tb.allocator.free_blocks + tb.prefix.cached_blocks == tb.paging.num_blocks - 1
    tb.prefix.check_chains()


def test_identical_prompt_served_twice_still_computes_last_token():
    jb, tb = _batchers("qwen2_5_14b", prefix_cache=True, num_slots=1, prefill_chunk=16)
    reqs = _shared(tb.model.cfg, 2, 16, 0)
    assert np.array_equal(reqs[0]["tokens"], reqs[1]["tokens"])
    assert _drive(tb, Request, reqs) == _drive(jb, JaxRequest, reqs)
    assert tb.prefix.hit_tokens == len(reqs[0]["tokens"]) - 1  # the cap
    assert _counts(tb) == _counts(jb)


def test_chunked_mode_with_prefix_cache_matches_jax():
    jb, tb = _batchers("olmo_1b", prefix_cache=True, policy="sjf", chunk_budget=8,
                       prefill_chunk=16)
    reqs = _shared(tb.model.cfg, 4, 20, 4, seed=3)
    assert _drive(tb, Request, reqs) == _drive(jb, JaxRequest, reqs)
    assert _counts(tb) == _counts(jb)
    assert tb.prefix.hit_tokens > 0 and tb.mixed_dispatches > 0


def test_forced_eviction_keeps_parity_with_jax():
    """A pool too small to keep every finished prompt: lazy LRU eviction,
    only of refcount-0 blocks, and the same tokens and evictions as JAX."""
    jb, tb = _batchers("qwen2_5_14b", spec_args=(8, 6, 3), prefix_cache=True,
                       num_slots=1, prefill_chunk=16)
    reqs = _shared(tb.model.cfg, 5, 12, 4, seed=7)
    assert _drive(tb, Request, reqs) == _drive(jb, JaxRequest, reqs)
    assert tb.prefix.evictions > 0 and tb.prefix.evictions == jb.prefix.evictions
    assert tb.prefix.evicted_log == jb.prefix.evicted_log
    assert all(rc == 0 for _, rc in tb.prefix.evicted_log)


def test_cancel_decrefs_shared_blocks_and_survivors_keep_serving():
    _, _, tm = _models("qwen2_5_14b")
    reqs = _shared(tm.cfg, 3, 20, 4, seed=5, max_new=6)
    b = ContinuousBatcher(tm, num_slots=2, max_seq=MAX_SEQ, prefill_chunk=16,
                          paging=_spec(), prefix_cache=True)
    for r in reqs:
        b.submit(Request(**r))
    b.step()  # requests 0 and 1 admitted, prefilled, prompts registered
    assert b.cancel(1)
    b.step()  # request 2 aliases request 0's chain while 0 is still live
    assert b.allocator.refcount[b.slot_blocks[0][0]] == 2
    b.run()
    assert b.allocator.live_refs == 0
    done = {r.uid: r for r in b.finished}
    assert len(done[0].out) == 6 and len(done[2].out) == 6 and done[1].cancelled


def test_sjf_orders_by_uncached_tokens():
    _, _, tm = _models("qwen2_5_14b")
    b = ContinuousBatcher(tm, num_slots=1, max_seq=MAX_SEQ, prefill_chunk=16,
                          paging=_spec(), prefix_cache=True, policy="sjf")
    warm = _shared(tm.cfg, 1, 24, 0, seed=9)[0]["tokens"]
    b.submit(Request(uid=0, tokens=warm, max_new=2))
    b.run()
    long_hit = np.concatenate([warm, np.arange(4, dtype=np.int32)])  # 4 uncached
    cold = _shared(tm.cfg, 1, 12, 0, seed=11)[0]["tokens"]  # 12 uncached
    order = []
    b.on_token = lambda req, tok: order.append(req.uid)
    b.submit(Request(uid=1, tokens=long_hit, max_new=2))
    b.submit(Request(uid=2, tokens=cold, max_new=2))
    assert b.scheduler._cost(b.queue[0]) == 4
    b.run()
    assert order[0] == 1


def test_prefix_cache_requires_paging():
    _, _, tm = _models("olmo_1b")
    with pytest.raises(ValueError, match="paged cache layout"):
        ContinuousBatcher(tm, num_slots=2, max_seq=MAX_SEQ, prefix_cache=True)
    with pytest.raises(ValueError, match="paged cache layout"):
        ServeEngine(tm, max_seq=MAX_SEQ, prefix_cache=True).generate(
            {"tokens": [np.arange(3, dtype=np.int32)]}, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_waves_hit_the_cache_like_jax(arch):
    jm, params, tm = _models(arch)
    reqs = _shared(tm.cfg, 4, 20, 4, seed=13)
    prompts = np.stack([r["tokens"] for r in reqs])
    kw = dict(max_seq=MAX_SEQ, prefill_chunk=16, num_slots=2, prefix_cache=True)
    jeng = JaxEngine(jm, params, paging=_spec(jax_spec=True), **kw)
    teng = ServeEngine(tm, paging=_spec(), **kw)
    want = jeng.generate({"tokens": prompts}, 4)
    got = teng.generate({"tokens": prompts}, 4)
    np.testing.assert_array_equal(got, want)
    assert teng.last_prefix_stats == jeng.last_prefix_stats
    assert teng.last_prefix_stats["hit_tokens"] > 0
    plain = ServeEngine(tm, max_seq=MAX_SEQ, prefill_chunk=16, num_slots=2, paging=_spec())
    np.testing.assert_array_equal(plain.generate({"tokens": prompts}, 4), got)
    assert plain.last_prefix_stats is None
    assert plain.last_stats["prefill_tokens"] > teng.last_prefix_stats["prefill_tokens"]
