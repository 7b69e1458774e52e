"""Fault tolerance of the port's serving engine in lockstep with the JAX
package's: every scenario of tests/test_serve_faults.py (fault injection at
each seam, lane quarantine, bounded retry, preemptive swap-out and exact
restore, check_invariants) runs through the JAX batcher and through the
port's (CPU, eager, float32; JAX at matmul precision "highest") on the
qwen2_5_14b smoke config with converted weights, with plans built alike
from one seed. Both sides must give the same greedy tokens, the same
``plan.log``, the same counters, the same terminal states and errors and
the same ``check_invariants()`` summary; each test then makes the
reference test's own assertions on the port. The preemption test also
holds the port's swap snapshot to the JAX snapshot's rows at the same
blocks (1e-5), and the swap pair is checked on its own: in place, exact,
refusing dense caches and foreign snapshots."""
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs import get as jax_get  # noqa: E402
from repro.core.graph import ring_graph as jax_ring_graph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.core.graph import ring_graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve.step import make_swap  # noqa: E402

MAX_SEQ = 32
SHAPES = ((9, 6), (6, 5), (12, 4))  # (prompt_len, max_new) per request
SIDES = ("jax", "torch")
TOL = 1e-5
COUNTERS = ("ticks", "decode_dispatches", "prefill_dispatches", "mixed_dispatches",
            "cow_copies", "prefill_tokens", "swap_outs", "swap_ins", "quarantined",
            "dispatch_faults", "adapter_faults", "retire_faults", "_stalled_steps")


@functools.lru_cache(maxsize=None)
def _built():
    """(JAX model, JAX params, port model on the CPU with the same weights)."""
    jm = JaxLM(jax_get("qwen2_5_14b", smoke=True))
    params = jm.init(jax.random.PRNGKey(0))
    tm = load_numpy_params(TransformerLM(get("qwen2_5_14b", smoke=True), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _api(side):
    return jserve if side == "jax" else tserve


def _batcher(side, **kw):
    jm, params, tm = _built()
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_chunk", 8)
    if side == "jax":
        return jserve.ContinuousBatcher(jm, params, **kw)
    return tserve.ContinuousBatcher(tm, cuda_graphs=False, **kw)


def _engine(side, **kw):
    jm, params, tm = _built()
    if side == "jax":
        return jserve.ServeEngine(jm, params, max_seq=MAX_SEQ, **kw)
    return tserve.ServeEngine(tm, max_seq=MAX_SEQ, cuda_graphs=False, **kw)


def _spec(side, pool_tokens=4 * MAX_SEQ, block_size=8):
    return _api(side).PagingSpec.sized(block_size, MAX_SEQ, pool_tokens=pool_tokens)


def _plan(side, build):
    """``build(FaultPlan class)`` for this side's package, or None."""
    return None if build is None else build(_api(side).FaultPlan)


def _requests(side, shapes=SHAPES, **kw):
    vocab = _built()[2].cfg.vocab_size
    rng = np.random.default_rng(0)
    return [
        _api(side).Request(uid=i, max_new=mn,
                           tokens=rng.integers(1, vocab, (n,)).astype(np.int32), **kw)
        for i, (n, mn) in enumerate(shapes)
    ]


def _serve(side, plan=None, shapes=SHAPES, paged=True, num_slots=3, req_kw=None, **kw):
    """A fresh batcher of ``side``, its plan built by ``plan``, fed the
    deterministic requests and drained. Returns ({uid: Request}, batcher)."""
    if paged and "paging" not in kw:
        kw["paging"] = _spec(side)
    b = _batcher(side, num_slots=num_slots, faults=_plan(side, plan), **kw)
    for r in _requests(side, shapes, **(req_kw or {})):
        b.submit(r)
    b.run()
    return {r.uid: r for r in b.finished}, b


def _on(side, fn):
    if side == "jax":
        with jax.default_matmul_precision("highest"):
            return fn()
    return fn()


def _state(finished, b):
    """Everything the two packages must agree on after a run."""
    return {
        "tokens": {uid: [int(t) for t in r.out] for uid, r in finished.items()},
        "log": None if b.faults is None else list(b.faults.log),
        "counters": {c: getattr(b, c) for c in COUNTERS},
        "terminal": {uid: (r.done, r.failed, r.timed_out, r.cancelled, r.truncated, r.error,
                           r.retries, r.preemptions) for uid, r in finished.items()},
        "invariants": b.check_invariants(),
    }


def _lockstep(run):
    """``run(side)`` -> ({uid: Request}, batcher) on both sides; their
    states must be equal. Returns the port's pair."""
    outs = {side: _on(side, lambda side=side: run(side)) for side in SIDES}
    want, got = (_state(*outs[side]) for side in SIDES)
    assert got == want
    return outs["torch"]


@functools.lru_cache(maxsize=None)
def _base_tokens(paged=True, chunk_budget=None):
    """The port's fault-free tokens (the lockstep tests pin them to JAX's)."""
    fin, _ = _serve("torch", paged=paged, chunk_budget=chunk_budget)
    return _tokens(fin)


def _tokens(finished):
    return {uid: [int(t) for t in r.out] for uid, r in finished.items()}


def _assert_clean(b):
    summary = b.check_invariants()
    assert summary["live_slots"] == 0 and summary["queued"] == 0
    if b.paging is not None:
        assert summary["live_refs"] == 0


# ------------------------------------------------------- zero overhead off
@pytest.mark.parametrize("paged", [False, True])
def test_empty_plan_is_token_and_dispatch_identical(paged):
    off, b_off = _lockstep(lambda side: _serve(side, paged=paged))
    on, b_on = _lockstep(lambda side: _serve(side, lambda F: F(), paged=paged))
    assert _tokens(off) == _tokens(on)
    for counter in ("decode_dispatches", "prefill_dispatches", "mixed_dispatches",
                    "cow_copies", "prefill_tokens"):
        assert getattr(b_off, counter) == getattr(b_on, counter), counter
    assert b_on.faults.fired == 0 and b_on.faults.log == []
    assert b_off.quarantine is False and b_on.quarantine is True
    _assert_clean(b_off)
    _assert_clean(b_on)


# ------------------------------------------------------------- alloc seam
def test_alloc_fault_backpressures_then_recovers():
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().script("alloc", uid=1, count=2)))
    assert b.faults.fired == 2
    assert _tokens(fin) == _base_tokens()
    assert not fin[1].failed and fin[1].retries == 0
    _assert_clean(b)


# ------------------------------------------------------------ incref seam
def _prefix_run(side, prompts, plan=None, prefix=True, max_retries=3):
    b = _batcher(side, num_slots=1, paging=_spec(side), prefix_cache=prefix,
                 faults=_plan(side, plan), max_retries=max_retries)
    req = _api(side).Request
    for uid, p in enumerate(prompts):
        b.submit(req(uid=uid, tokens=p.copy(), max_new=4))
    b.run()
    return {r.uid: r for r in b.finished}, b


def test_incref_fault_on_prefix_sharing_path():
    vocab = _built()[2].cfg.vocab_size
    rng = np.random.default_rng(3)
    pa = rng.integers(1, vocab, (16,)).astype(np.int32)
    pb = np.concatenate([pa[:8], rng.integers(1, vocab, (4,))]).astype(np.int32)
    base, _ = _lockstep(lambda side: _prefix_run(side, (pa, pb), prefix=False))
    fin, b = _lockstep(lambda side: _prefix_run(
        side, (pa, pb), lambda F: F().script("incref", uid=1, count=1)))
    assert b.faults.fired == 1
    assert _tokens(base) == _tokens(fin)
    assert not fin[1].failed
    _assert_clean(b)


# ------------------------------------------------ dispatch seams (+ retry)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_dispatch_fault_retries_with_parity(paged):
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().script("dispatch", where="decode", count=2), paged=paged))
    assert b.faults.fired == 2 and b.dispatch_faults == 2
    assert _tokens(fin) == _base_tokens(paged)
    _assert_clean(b)


def test_prefill_fault_mid_gulp_resumes_exactly():
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().script("dispatch", where="prefill", tick=0, count=1)))
    assert b.faults.fired == 1 and b.dispatch_faults == 1
    assert _tokens(fin) == _base_tokens()
    _assert_clean(b)


def test_mixed_dispatch_fault_in_chunked_mode():
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().script("dispatch", where="mixed", count=2), chunk_budget=8))
    assert b.faults.fired == 2 and b.dispatch_faults == 2
    assert _tokens(fin) == _base_tokens(chunk_budget=8)
    _assert_clean(b)


def test_permanent_dispatch_fault_fails_terminally_without_raising():
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().probabilistic("dispatch", p=1.0), max_retries=2))
    assert fin and all(r.failed and not r.done for r in fin.values())
    assert all("dispatch failed" in r.error for r in fin.values())
    _assert_clean(b)


def test_fault_streak_resets_on_a_successful_dispatch():
    """Two decode faults in rounds apart, with max_retries=1: the dispatch
    between them resets the streak, so nothing fails."""
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().script("dispatch", where="decode", tick=2, count=1)
        .script("dispatch", where="decode", tick=4, count=1), max_retries=1))
    assert b.dispatch_faults == 2 and not any(r.failed for r in fin.values())
    assert _tokens(fin) == _base_tokens()
    _assert_clean(b)


def test_run_tick_budget_still_enforced_under_faults():
    def run(side):
        b = _batcher(side, num_slots=3, faults=_plan(
            side, lambda F: F().probabilistic("dispatch", p=1.0)), max_retries=10_000)
        reqs = _requests(side)
        for r in reqs:
            b.submit(r)
        with pytest.raises(_api(side).TickBudgetExceeded):
            b.run(max_ticks=5)
        return {r.uid: r for r in reqs}, b

    fin, b = _lockstep(run)
    assert all(r.timed_out and not r.done for r in fin.values())


# ------------------------------------------------------------- cow seam
def _cow_prompts():
    vocab = _built()[2].cfg.vocab_size
    rng = np.random.default_rng(7)
    pa = rng.integers(1, vocab, (12,)).astype(np.int32)
    pb = np.concatenate([pa[:5], rng.integers(1, vocab, (5,))]).astype(np.int32)
    return pa, pb


def test_cow_fault_unwinds_and_retries():
    base, _ = _lockstep(lambda side: _prefix_run(side, _cow_prompts()))
    fin, b = _lockstep(lambda side: _prefix_run(
        side, _cow_prompts(), lambda F: F().script("dispatch", where="cow", count=1)))
    assert b.faults.fired == 1
    assert _tokens(base) == _tokens(fin)
    assert fin[1].retries == 1 and b.cow_copies == 1
    _assert_clean(b)


def test_cow_fault_exhaustion_is_terminal_and_leak_free():
    base, _ = _lockstep(lambda side: _prefix_run(side, _cow_prompts()))
    fin, b = _lockstep(lambda side: _prefix_run(
        side, _cow_prompts(), lambda F: F().script("dispatch", where="cow", count=None),
        max_retries=2))
    assert fin[1].failed and "retries exhausted" in fin[1].error
    assert list(fin[0].out) == list(base[0].out)  # sharer unaffected
    _assert_clean(b)


# ------------------------------------------------------------- free seam
def test_free_fault_mid_retire_stays_reconcilable():
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().script("clock", tick=2, skew_s=1_000.0).script("free", count=1),
        now_fn=lambda: 0.0, req_kw={"timeout_s": 500.0}))
    assert b.retire_faults == 1
    assert fin and all(r.timed_out and not r.done for r in fin.values())
    _assert_clean(b)


# ---------------------------------------------------------------- nan seam
def test_nan_quarantine_fails_only_the_poisoned_lane():
    fin, b = _lockstep(lambda side: _serve(side, lambda F: F().script("nan", uid=0, count=1)))
    assert b.quarantined == 1 and b.faults.fired == 1
    assert fin[0].failed and "non-finite" in fin[0].error
    base = _base_tokens()
    for uid in (1, 2):
        assert list(fin[uid].out) == base[uid]
    _assert_clean(b)


def test_quarantine_preserves_single_dispatch_per_tick():
    _, b_off = _lockstep(lambda side: _serve(side))
    _, b_on = _lockstep(lambda side: _serve(side, lambda F: F().script("nan", uid=0, count=1)))
    assert b_on.decode_dispatches <= b_off.decode_dispatches
    assert b_on.prefill_dispatches == b_off.prefill_dispatches


# ------------------------------------------------------------ adapter seam
def test_adapter_fault_is_absorbed_not_fatal():
    def store(side):
        num_tasks = _built()[2].cfg.num_tasks
        if side == "jax":
            return jserve.TaskAdapterStore(_built()[0], jax_ring_graph(num_tasks),
                                           mixing="bsr", rank=2)
        return tserve.TaskAdapterStore(_built()[2], ring_graph(num_tasks), mixing="bsr",
                                       rank=2)

    base, _ = _lockstep(lambda side: _serve(side, adapters=store(side)))
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().script("adapter", uid=0, count=1), adapters=store(side)))
    assert b.adapter_faults == 1 and b.faults.fired == 1
    assert _tokens(base) == _tokens(fin)
    assert all(r.done for r in fin.values())
    _assert_clean(b)


# -------------------------------------------------------------- clock seam
def test_clock_skew_triggers_timeout_storm():
    fin, b = _lockstep(lambda side: _serve(
        side, lambda F: F().script("clock", tick=2, skew_s=1_000.0),
        now_fn=lambda: 0.0, req_kw={"timeout_s": 500.0}))
    assert b.faults.fired == 1
    assert fin and all(r.timed_out and not r.done for r in fin.values())
    assert any(r.out for r in fin.values())
    _assert_clean(b)


# ------------------------------------------------------ preemptive swap-out
def _pressure_run(side, pool_tokens, preempt, plan=None, snapshots=None):
    b = _batcher(side, num_slots=2, paging=_spec(side, pool_tokens=pool_tokens),
                 policy="priority", preempt=preempt, faults=_plan(side, plan))
    if snapshots is not None and preempt:
        swap_out = b._swap_out_fn

        def keep(*args):
            saved = swap_out(*args)
            snapshots.append(saved)
            return saved

        b._swap_out_fn = keep
    vocab = _built()[2].cfg.vocab_size
    req = _api(side).Request
    rng = np.random.default_rng(11)
    b.submit(req(uid=0, priority=10, max_new=16,
                 tokens=rng.integers(1, vocab, (8,)).astype(np.int32)))
    b.step()
    b.step()  # the hog is decoding and owns most of the pool
    b.submit(req(uid=1, priority=0, max_new=6,
                 tokens=rng.integers(1, vocab, (6,)).astype(np.int32)))
    b.run()
    return {r.uid: r for r in b.finished}, b


def test_preemption_swaps_out_victim_with_exact_restore():
    """The hog yields to the short request through one swap-out and one
    swap-in, and both decode what a roomy pool decodes; the port's
    snapshot holds JAX's rows at the same blocks."""
    roomy, b_ref = _lockstep(lambda side: _pressure_run(side, 8 * 8, preempt=False))
    assert b_ref.swap_outs == 0
    snaps = {side: [] for side in SIDES}
    tight, b = _lockstep(lambda side: _pressure_run(side, 4 * 8, preempt=True,
                                                    snapshots=snaps[side]))
    assert b.swap_outs == 1 and b.swap_ins == 1
    assert tight[0].preemptions == 1 and tight[0]._swap is None
    assert _tokens(roomy) == _tokens(tight)
    _assert_clean(b)
    (jkv,), (((saved,), columns),) = snaps["jax"], snaps["torch"]  # one pool row shape
    assert columns == []  # an attention-only model has no per-slot state
    jk, jv = (np.asarray(x) for x in jax.tree.leaves(jkv))  # (L, max_blocks, BS, KVH, hd)
    n = saved.shape[1]
    assert n == b.paging.blocks_for(8 + 16)  # the hog's real blocks, no padding
    assert saved.shape[0] == 2 * jk.shape[0] and jk.shape[2:] == tuple(saved.shape[2:])
    for i in range(jk.shape[0]):
        np.testing.assert_allclose(saved[2 * i].numpy(), jk[i, :n], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(saved[2 * i + 1].numpy(), jv[i, :n], rtol=TOL, atol=TOL)


def test_refusal_only_without_preempt_still_drains():
    roomy, _ = _lockstep(lambda side: _pressure_run(side, 8 * 8, preempt=False))
    tight, b = _lockstep(lambda side: _pressure_run(side, 4 * 8, preempt=False))
    assert b.swap_outs == 0
    assert _tokens(roomy) == _tokens(tight)
    _assert_clean(b)


def test_swap_dispatch_fault_degrades_to_refusal():
    roomy, _ = _lockstep(lambda side: _pressure_run(side, 8 * 8, preempt=False))
    fin, b = _lockstep(lambda side: _pressure_run(
        side, 4 * 8, preempt=True,
        plan=lambda F: F().script("dispatch", where="swap", count=None)))
    assert b.faults.fired >= 1 and b.swap_outs == 0
    assert _tokens(roomy) == _tokens(fin)
    _assert_clean(b)


# --------------------------------------------------------------- engine API
def _engine_batch():
    vocab = _built()[2].cfg.vocab_size
    return {"tokens": np.random.default_rng(0).integers(1, vocab, (2, 8)).astype(np.int32)}


def test_engine_surfaces_terminal_failures():
    logs = []
    for side in SIDES:
        plan = _plan(side, lambda F: F().script("nan", uid=0, count=1))
        with pytest.raises(RuntimeError, match="uid 0.*non-finite") as err:
            _on(side, lambda side=side, plan=plan: _engine(side, faults=plan).generate(
                _engine_batch(), 4))
        logs.append((plan.log, str(err.value)))
    assert logs[0] == logs[1]


def test_engine_transparent_under_transient_faults():
    outs = {}
    for side in SIDES:
        plan = _plan(side, lambda F: F().script("dispatch", where="decode", count=2))
        base = _on(side, lambda side=side: _engine(side).generate(_engine_batch(), 4))
        out = _on(side, lambda side=side, plan=plan: _engine(side, faults=plan).generate(
            _engine_batch(), 4))
        assert np.array_equal(base, out)
        outs[side] = (np.asarray(out).tolist(), plan.log)
    assert outs["torch"] == outs["jax"]


# ----------------------------------------------------------- randomized chaos
def _random_plan(seed):
    """The reference test's seeded schedule over every probabilistic seam,
    for either package's FaultPlan."""
    def build(F):
        rng = np.random.default_rng(seed)
        plan = F(seed=seed)
        for seam, sites in (
            ("alloc", [None]), ("incref", [None]), ("adapter", [None]), ("free", [None]),
            ("dispatch", ["decode", "prefill", "cow", None]),
        ):
            if rng.random() < 0.5:
                plan.probabilistic(seam, p=float(rng.uniform(0.05, 0.3)),
                                   where=sites[rng.integers(len(sites))], count=3)
        if rng.random() < 0.3:
            plan.script("nan", uid=int(rng.integers(3)), count=1)
        return plan

    return build


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), paged=st.booleans())
def test_random_fault_schedules_never_crash_and_reconcile(seed, paged):
    fin, b = _lockstep(lambda side: _serve(side, _random_plan(seed), paged=paged))
    base = _base_tokens(paged)
    assert set(fin) == set(base)
    for uid, req in fin.items():
        if not req.failed:
            assert list(req.out) == base[uid], uid
    _assert_clean(b)


# ------------------------------------------------------------ the swap pair
def test_swap_pair_round_trips_in_place():
    """swap_out gathers exactly the given blocks' rows of every pool;
    swap_in writes them into other blocks, in place (the same tensors,
    the same data pointers), touching no other block."""
    tm = _built()[2]
    spec = tserve.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ)
    caches = tm.init_cache(2, MAX_SEQ, spec)
    g = torch.Generator().manual_seed(0)
    for k, v in caches:
        k.copy_(torch.randn(k.shape, generator=g))
        v.copy_(torch.randn(v.shape, generator=g))
    before = [(k.clone(), v.clone()) for k, v in caches]
    ptrs = [(k.data_ptr(), v.data_ptr()) for k, v in caches]
    swap_out, swap_in = make_swap(spec, tm.kinds)
    src, dst = [3, 1, 7], [2, 9, 5]
    saved = swap_out(caches, src)
    (pages,), columns = saved  # one pool row shape: one pages tensor
    assert tuple(pages.shape) == (2 * len(caches), 3) + tuple(caches[0][0].shape[1:])
    assert columns == []
    assert swap_in(caches, dst, saved) is caches
    assert [(k.data_ptr(), v.data_ptr()) for k, v in caches] == ptrs
    untouched = [b for b in range(spec.num_blocks) if b not in dst]
    for (k, v), (k0, v0) in zip(caches, before):
        for got, old in ((k, k0), (v, v0)):
            assert torch.equal(got[dst], old[src])
            assert torch.equal(got[untouched], old[untouched])


def test_swap_pair_refuses_dense_caches_and_foreign_snapshots():
    tm = _built()[2]
    spec = tserve.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ)
    with pytest.raises(ValueError, match="paged"):
        make_swap(None, tm.kinds)
    caches = tm.init_cache(2, MAX_SEQ, spec)
    swap_out, swap_in = make_swap(spec, tm.kinds)
    with pytest.raises(ValueError, match="block id"):
        swap_out(caches, [0, 1])  # the null block is never a slot's
    with pytest.raises(ValueError, match="block id"):
        swap_out(caches, [spec.num_blocks])
    (pages,), columns = swap_out(caches, [1, 2])
    with pytest.raises(ValueError, match="snapshot"):
        swap_in(caches, [3], ([pages], columns))  # fewer blocks than were saved
    with pytest.raises(ValueError, match="snapshot"):
        swap_in(caches, [3, 4], ([pages.double()], columns))


# ----------------------------------------------------------- reconciliation
def _leak(b):
    b.slot_blocks[0] = [5]  # an unbound slot that still holds a block


def _double_bind(b):
    b.slots.reqs[0] = b.slots.reqs[1] = b.finished[0]
    b.finished[0].done = False


def _lost_block(b):
    b.allocator.alloc(1)  # referenced by no slot, not on the free list


@pytest.mark.parametrize("corrupt,match", [
    (_leak, "unbound but still holds blocks"),
    (_double_bind, "bound to two slots"),
    (_lost_block, "refcount"),
])
def test_check_invariants_reports_a_violation(corrupt, match):
    """A drained batcher reconciles; each corruption of its bookkeeping
    raises RuntimeError naming the violation."""
    _, b = _serve("torch")
    _assert_clean(b)
    corrupt(b)
    with pytest.raises(RuntimeError, match=match):
        b.check_invariants()
