"""Greedy serving of the Zamba2 hybrid (mamba2 layers + one shared
attention block) through the port's batcher and engine, against the JAX
package's, on the zamba2_7b smoke config with converted weights (CPU,
eager, float32; JAX at matmul precision "highest"). Tokens and counters are
compared exactly (no tolerance); recurrent state after a reset exactly;
the swap snapshot's state columns against JAX's within 1e-5.

Scenarios are the reference tests': staggered admission over 2 slots with
slot reuse (tests/test_serve_batching.py:38), dense and paged at block
sizes 8 and 16 (tests/test_serve_paging.py:69), a preemption under block
pressure (tests/test_serve_faults.py), and the prefix-cache refusal
(tests/test_serve_prefix.py:345). On top: a request served in a reused slot
gives what a fresh batcher gives, dense and paged; ``reset_slot_state``
restores every per-slot entry (the mamba states under paging too) to its
``init_cache`` value as JAX's does; the adapter store's trees equal JAX's."""
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.core.graph import ring_graph as jax_ring_graph  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import adapters_from_numpy, load_numpy_params  # noqa: E402
from repro_torch.core.graph import ring_graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402

MAX_SEQ = 32
PROMPT_LENS = (5, 9, 3, 7)
MAX_NEWS = (4, 6, 5, 3)
SIDES = ("jax", "torch")
COUNTERS = ("decode_dispatches", "prefill_dispatches", "prefill_tokens", "swap_outs",
            "swap_ins")


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _built():
    """(JAX model, JAX params, port model on the CPU with the same weights)."""
    jm = JaxLM(jax_get("zamba2_7b", smoke=True))
    params = jm.init(jax.random.PRNGKey(0))
    tm = load_numpy_params(TransformerLM(get("zamba2_7b", smoke=True), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _api(side):
    return jserve if side == "jax" else tserve


def _batcher(side, **kw):
    jm, params, tm = _built()
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_chunk", 4)
    if side == "jax":
        return jserve.ContinuousBatcher(jm, params, **kw)
    return tserve.ContinuousBatcher(tm, cuda_graphs=False, **kw)


def _spec(side, block_size=8, pool_tokens=2 * MAX_SEQ):
    return _api(side).PagingSpec.sized(block_size, MAX_SEQ, pool_tokens=pool_tokens)


def _requests(side, uids=None):
    vocab = _built()[2].cfg.vocab_size
    rng = np.random.default_rng(0)
    reqs = [_api(side).Request(uid=i, tokens=rng.integers(0, vocab, (n,)).astype(np.int32),
                               max_new=mn, task_id=i % 4)
            for i, (n, mn) in enumerate(zip(PROMPT_LENS, MAX_NEWS))]
    return [r for r in reqs if uids is None or r.uid in uids]


def _serve(side, uids=None, **kw):
    """Drain the scenario's requests (or the ``uids`` among them) through a
    fresh batcher; returns ({uid: tokens}, batcher, {uid: slot})."""
    b = _batcher(side, **kw)
    slots = {}
    bind = b.slots.bind

    def record(s, req, **k):
        slots[req.uid] = s
        return bind(s, req, **k)

    b.slots.bind = record
    for r in _requests(side, uids):
        b.submit(r)
    done = b.run()
    return {r.uid: [int(t) for t in r.out] for r in done}, b, slots


@functools.lru_cache(maxsize=None)
def _lockstep(block_size=None):
    """Both packages on the scenario, dense (None) or paged: the same
    tokens and counters. Returns the port's (tokens, slots)."""
    outs = {}
    for side in SIDES:
        kw = {} if block_size is None else {"paging": _spec(side, block_size)}
        toks, b, slots = _serve(side, **kw)
        outs[side] = (toks, {c: getattr(b, c) for c in COUNTERS}, slots)
    assert outs["torch"][:2] == outs["jax"][:2]
    assert outs["torch"][2] == outs["jax"][2]
    return outs["torch"][0], outs["torch"][2]


def test_batcher_matches_jax_dense_with_slot_reuse():
    toks, slots = _lockstep()
    assert sorted(toks) == [0, 1, 2, 3]
    assert [len(toks[i]) for i in range(4)] == list(MAX_NEWS)
    assert len(set(slots.values())) == 2  # four requests over two slots


@pytest.mark.parametrize("block_size", [8, 16])
def test_paged_batcher_matches_jax_and_dense(block_size):
    """Paged attention pools beside dense recurrent states, one cache."""
    toks, _ = _lockstep(block_size)
    assert toks == _lockstep()[0]


@pytest.mark.parametrize("block_size", [None, 8])
def test_request_in_a_reused_slot_gives_a_fresh_batchers_tokens(block_size):
    """The requests admitted into a slot that served an earlier request
    decode what they decode alone in a fresh batcher: the slot's recurrent
    state was reset on admission, under paging too."""
    toks, slots = _lockstep(block_size)
    first = {}
    for uid in sorted(slots):
        first.setdefault(slots[uid], uid)
    reused = [uid for uid in slots if first[slots[uid]] != uid]
    assert reused
    kw = {} if block_size is None else {"paging": _spec("torch", block_size)}
    for uid in reused:
        alone, _, _ = _serve("torch", uids={uid}, **kw)
        assert alone[uid] == toks[uid], uid


@pytest.mark.parametrize("paged", [False, True])
def test_reset_restores_every_per_slot_entry_as_jax_does(paged):
    """After filling every cache tensor with ones, the reset rows of every
    per-slot entry hold JAX's reset value and the other rows keep theirs;
    under paging the attention pools are left alone and the mamba states
    are reset all the same."""
    jm, _, tm = _built()
    jspec = _spec("jax") if paged else None
    tspec = _spec("torch") if paged else None
    reset = np.array([False, True, True])
    jc = jax.tree.map(jnp.ones_like, jm.init_cache(3, MAX_SEQ, jspec))
    jc = jm.reset_slot_state(jc, jnp.asarray(reset), MAX_SEQ, jspec)
    tc = tm.init_cache(3, MAX_SEQ, tspec)
    for entry in tc:
        for t in entry:
            t.fill_(1.0)
    assert tm.reset_slot_state(tc, reset, tspec) is tc
    stage = jc[0]  # the smoke config's one period: slot0 mamba, slot1 shared_attn
    for layer, slot in ((0, "slot0"), (1, "slot1")):
        for got, want in zip(tc[layer], stage[slot]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    assert all(t.eq(1).all() for t in tc[1]) == paged


def test_preemption_in_lockstep_with_jax():
    """A priority-10 hog swapped out of a tight pool for a priority-0
    request, then restored: tokens, swap counters and the state columns of
    the snapshot equal JAX's, and the tokens equal a roomy pool's."""
    def pressure(side, pool_tokens, preempt, snaps):
        b = _batcher(side, paging=_spec(side, 8, pool_tokens), policy="priority",
                     preempt=preempt, prefill_chunk=8)
        if preempt:
            out = b._swap_out_fn

            def keep(*args):
                snaps.append(out(*args))
                return snaps[-1]

            b._swap_out_fn = keep
        vocab = _built()[2].cfg.vocab_size
        rng = np.random.default_rng(11)
        req = _api(side).Request
        b.submit(req(uid=0, priority=10, max_new=16,
                     tokens=rng.integers(1, vocab, (8,)).astype(np.int32)))
        b.step()
        b.step()  # the hog is decoding and owns most of the pool
        b.submit(req(uid=1, priority=0, max_new=6,
                     tokens=rng.integers(1, vocab, (6,)).astype(np.int32)))
        b.run()
        return {r.uid: [int(t) for t in r.out] for r in b.finished}, b

    snaps = {side: [] for side in SIDES}
    runs = {side: pressure(side, 4 * 8, True, snaps[side]) for side in SIDES}
    (jt, jb), (tt, tb) = runs["jax"], runs["torch"]
    assert tt == jt
    assert {c: getattr(tb, c) for c in COUNTERS} == {c: getattr(jb, c) for c in COUNTERS}
    assert (tb.swap_outs, tb.swap_ins) == (1, 1)
    roomy, _ = pressure("torch", 8 * 8, False, [])
    assert roomy == tt
    (jsaved,), (((pages,), columns),) = snaps["jax"], snaps["torch"]
    conv, ssm = (np.asarray(t)[0, 0] for t in jsaved[0]["slot0"])  # (P, 1, ...) columns
    assert len(columns) == 2 and pages.shape[0] == 2  # one attention layer: its K and V
    np.testing.assert_allclose(columns[0].numpy(), conv, atol=1e-5, rtol=0)
    np.testing.assert_allclose(columns[1].numpy(), ssm, atol=1e-5, rtol=0)
    assert tb.check_invariants() == jb.check_invariants()


def test_prefix_cache_and_adapters_refuse_the_hybrid():
    """The prefix cache would resume recurrent state from foreign blocks:
    it raises, with the reason. The adapter store takes the hybrid in the
    reference's layout — an "out" pair on the mamba slot, an "attn" and an
    "mlp" pair on the shared-attention slot — and its raw and mixed trees
    equal the JAX store's (the steps under it: tests/test_torch_xlstm_serve.py)."""
    with pytest.raises(ValueError, match="attention-only"):
        _batcher("torch", paging=_spec("torch"), prefix_cache=True)
    with pytest.raises(ValueError, match="attention-only"):
        tserve.ServeEngine(_built()[2], max_seq=MAX_SEQ, paging=_spec("torch"),
                           prefix_cache=True, cuda_graphs=False).generate(
            {"tokens": np.ones((1, 4), np.int32)}, 2)
    jm, _, tm = _built()
    js = jserve.TaskAdapterStore(jm, jax_ring_graph(4), rank=2)
    js.randomize(scale=0.5)
    ts = tserve.TaskAdapterStore(tm, ring_graph(4), rank=2)
    adapters_from_numpy(ts, jax.tree.map(np.asarray, js.raw))
    assert sorted(ts.raw["stages"][0]["slot0"]) == ["out"]
    assert sorted(ts.raw["stages"][0]["slot1"]) == ["attn", "mlp"]
    for tree, want in ((ts.raw, js.raw), (ts.serving, js.serving)):
        got = list(tree_lib.paths(tree))
        ref = list(tree_lib.paths(jax.tree.map(np.asarray, want)))
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (p, a), (_, w) in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), w, atol=1e-6, rtol=1e-6, err_msg=p)


def test_engine_generate_matches_jax_engine():
    """ServeEngine.generate on a batch of 3 over 2 slots, dense and paged,
    equals the JAX engine's greedy tokens."""
    jm, params, tm = _built()
    prompts = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (3, 7)).astype(np.int32)
    for paged in (False, True):
        kw = {"num_slots": 2, "prefill_chunk": 4}
        jk = dict(kw, paging=_spec("jax")) if paged else kw
        tk = dict(kw, paging=_spec("torch")) if paged else kw
        want = jserve.ServeEngine(jm, params, max_seq=MAX_SEQ, **jk).generate(
            {"tokens": prompts}, 5)
        got = tserve.ServeEngine(tm, max_seq=MAX_SEQ, cuda_graphs=False, **tk).generate(
            {"tokens": prompts}, 5)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
