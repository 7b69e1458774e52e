"""Serving parity of the port (repro_torch.serve) with the JAX package on
the olmo_1b and qwen2_5_14b smoke configs (and the module-level
``generate`` on phi4_mini_3_8b and qwen1_5_110b) with converted weights: greedy
tokens from ServeEngine.generate and from the staggered ContinuousBatcher
workload of tests/test_serve_backend.py, token for token and with the same
dispatch counts, in both chunk_budget regimes and both prefill modes; plus
the executor's contracts (cancel, timeout, streaming, tick budget, sampling
stability, validation of the fault options, a quarantined request
surfacing from ServeEngine, refusal of an adapter store built for another
task count). CPU, float32."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.serve import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.core.graph import ring_graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    FaultPlan,
    Request,
    ServeEngine,
    TaskAdapterStore,
    TickBudgetExceeded,
    generate,
)

ARCHS = ["olmo_1b", "qwen2_5_14b"]
_CACHE = {}


def _models(arch, backend="kernel"):
    """(JAX model, JAX params, port model on the CPU with the same weights)."""
    if arch not in _CACHE:
        jm = JaxLM(jax_get(arch, smoke=True))
        _CACHE[arch] = (jm, jm.init(jax.random.PRNGKey(0)))
    jm, params = _CACHE[arch]
    cfg = dataclasses.replace(get(arch, smoke=True), attn_backend=backend)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _staggered(batcher, req_cls, vocab, num_tasks):
    """3 requests over 2 slots: a second admission round (slot reuse, reset
    path) with ragged prompt lengths (tests/test_serve_backend.py)."""
    rng = np.random.default_rng(0)
    for i, (n, mn) in enumerate(((5, 6), (8, 4), (3, 5))):
        batcher.submit(req_cls(
            uid=i, tokens=rng.integers(0, vocab, (n,)).astype(np.int32),
            max_new=mn, task_id=i % num_tasks,
        ))
    done = batcher.run()
    assert len(done) == 3
    return ({r.uid: list(map(int, r.out)) for r in done},
            (batcher.decode_dispatches, batcher.prefill_dispatches, batcher.mixed_dispatches))


@pytest.mark.parametrize("chunk_budget", [None, 4])
@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_staggered_batcher_matches_jax(arch, backend, chunk_budget):
    jm, params, tm = _models(arch, backend)
    kw = dict(num_slots=2, max_seq=24, prefill_chunk=3, chunk_budget=chunk_budget)
    want = _staggered(JaxBatcher(jm, params, **kw), JaxRequest, tm.cfg.vocab_size,
                      tm.cfg.num_tasks)
    got = _staggered(ContinuousBatcher(tm, **kw), Request, tm.cfg.vocab_size,
                     tm.cfg.num_tasks)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_matches_jax(arch):
    jm, params, tm = _models(arch)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, tm.cfg.vocab_size, (3, 7)).astype(np.int32),
             "task_ids": np.array([0, 1, 3], np.int32)}
    want = JaxEngine(jm, params, max_seq=32, prefill_chunk=4).generate(batch, 8)
    engine = ServeEngine(tm, max_seq=32, prefill_chunk=4)
    got = engine.generate(batch, 8)
    np.testing.assert_array_equal(got, want)
    assert engine.last_stats["prefill_dispatches"] == 2  # ceil(7 / 4)
    assert engine.last_stats["decode_dispatches"] == 7


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "qwen1_5_110b"])
def test_module_generate_equals_engine_and_jax(arch):
    """repro_torch.serve.generate is ServeEngine(model, max_seq).generate,
    on the tied-head phi4-mini and the QKV-bias Qwen1.5 smoke configs, and
    both equal the JAX package's generate."""
    jm, params, tm = _models(arch)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, tm.cfg.vocab_size, (3, 9)).astype(np.int32),
             "task_ids": np.array([2, 0, 1], np.int32)}
    got = generate(tm, batch, 6, 48)  # max_seq 48: the default 32-token chunk fits
    np.testing.assert_array_equal(got, ServeEngine(tm, 48).generate(batch, 6))
    np.testing.assert_array_equal(got, jax_generate(jm, params, batch, 6, 48))


def test_scan_prefill_mode_matches_parallel():
    _, _, tm = _models("qwen2_5_14b")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, tm.cfg.vocab_size, (2, 9)).astype(np.int32)}
    par = ServeEngine(tm, max_seq=24, prefill_chunk=4).generate(batch, 5)
    scan = ServeEngine(tm, max_seq=24, prefill_chunk=4, prefill_mode="scan").generate(batch, 5)
    np.testing.assert_array_equal(par, scan)


def test_ragged_engine_batch_matches_batcher_and_reuses_slots():
    """A list of ragged prompts through fewer slots than rows: admission
    waves reuse (and reset) slots, and each row's tokens equal the same
    request served alone."""
    _, _, tm = _models("olmo_1b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32) for n in (9, 2, 6, 4)]
    got = ServeEngine(tm, max_seq=24, prefill_chunk=4, num_slots=2).generate(
        {"tokens": prompts}, 5)
    for i, p in enumerate(prompts):
        alone = ServeEngine(tm, max_seq=24, prefill_chunk=4).generate({"tokens": [p]}, 5)
        np.testing.assert_array_equal(got[i], alone[0])


@pytest.mark.parametrize("policy", ["sjf", "priority"])
def test_policies_match_jax(policy):
    jm, params, tm = _models("qwen2_5_14b")
    outs = []
    for batcher, req in ((JaxBatcher(jm, params, num_slots=2, max_seq=24, prefill_chunk=3,
                                     policy=policy, chunk_budget=3), JaxRequest),
                         (ContinuousBatcher(tm, num_slots=2, max_seq=24, prefill_chunk=3,
                                            policy=policy, chunk_budget=3), Request)):
        rng = np.random.default_rng(4)
        for i, n in enumerate((7, 2, 5, 3)):
            batcher.submit(req(uid=i, tokens=rng.integers(0, 512, n).astype(np.int32),
                               max_new=3, priority=3 - i))
        outs.append([(r.uid, list(map(int, r.out))) for r in batcher.run()])
    assert outs[0] == outs[1]  # same tokens, same finishing order


def test_cancel_mid_flight_and_streaming():
    _, _, tm = _models("olmo_1b")
    streamed = []
    batcher = ContinuousBatcher(tm, num_slots=2, max_seq=24, prefill_chunk=4,
                                on_token=lambda r, t: streamed.append((r.uid, t)))
    rng = np.random.default_rng(5)
    for i in range(3):
        batcher.submit(Request(uid=i, tokens=rng.integers(0, 512, 4).astype(np.int32),
                               max_new=6))
    batcher.step()
    batcher.step()
    assert batcher.cancel(1) and not batcher.cancel(99)
    n1 = len([u for u, _ in streamed if u == 1])
    done = {r.uid: r for r in batcher.run()}
    assert done[1].cancelled and not done[1].done and len(done[1].out) == n1
    assert done[0].done and done[2].done and len(done[2].out) == 6
    assert [t for u, t in streamed if u == 0] == done[0].out  # streamed in order
    assert batcher.cancel(2) is False  # already finished


def test_timeout_expires_queued_and_in_flight():
    _, _, tm = _models("olmo_1b")
    clock = [0.0]
    batcher = ContinuousBatcher(tm, num_slots=1, max_seq=24, prefill_chunk=4,
                                now_fn=lambda: clock[0])
    for i in range(2):
        batcher.submit(Request(uid=i, tokens=np.arange(3, dtype=np.int32), max_new=8,
                               timeout_s=1.0))
    batcher.step()  # uid 0 admitted, uid 1 queued
    clock[0] = 2.0
    done = {r.uid: r for r in batcher.run()}
    assert done[0].timed_out and done[1].timed_out
    assert not done[0].done and done[1].out == []
    assert not batcher.slots.any_live() and not batcher.queue


def test_tick_budget_raises_or_flags():
    _, _, tm = _models("olmo_1b")
    for mode in ("raise", "flag"):
        batcher = ContinuousBatcher(tm, num_slots=1, max_seq=24, prefill_chunk=4)
        batcher.submit(Request(uid=0, tokens=np.arange(3, dtype=np.int32), max_new=10))
        if mode == "raise":
            with pytest.raises(TickBudgetExceeded):
                batcher.run(max_ticks=2)
        else:
            assert batcher.run(max_ticks=2, on_exhausted="flag") == []
        assert batcher.slots.reqs[0].timed_out


def test_submit_validation():
    _, _, tm = _models("olmo_1b")
    batcher = ContinuousBatcher(tm, num_slots=1, max_seq=8, prefill_chunk=4)
    with pytest.raises(ValueError, match="empty prompt"):
        batcher.submit(Request(uid=0, tokens=np.zeros(0, np.int32), max_new=2))
    with pytest.raises(ValueError, match="task_id"):
        batcher.submit(Request(uid=1, tokens=np.ones(2, np.int32), max_new=2, task_id=4))
    with pytest.raises(ValueError, match="capacity"):
        batcher.submit(Request(uid=2, tokens=np.ones(5, np.int32), max_new=4))


def test_fault_options_are_validated():
    """As in the reference: preemption needs a paged pool, and a retry
    budget cannot be negative."""
    _, _, tm = _models("olmo_1b")
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(tm, num_slots=1, max_seq=8, preempt=True)
    with pytest.raises(ValueError, match="max_retries"):
        ContinuousBatcher(tm, num_slots=1, max_seq=8, max_retries=-1)


def test_engine_raises_for_a_quarantined_request():
    """ServeEngine passes its fault plan to the batcher, and a request the
    quarantine failed makes generate raise; the others' stats are kept."""
    _, _, tm = _models("olmo_1b")
    plan = FaultPlan().script("nan", uid=1, count=1)
    engine = ServeEngine(tm, max_seq=16, prefill_chunk=4, faults=plan)
    toks = np.arange(12, dtype=np.int32).reshape(3, 4)
    with pytest.raises(RuntimeError, match="uid 1: non-finite logits"):
        engine.generate({"tokens": toks}, 3)
    assert engine.last_stats["quarantined"] == 1 and plan.fired == 1


def test_adapter_store_of_another_task_count_raises():
    """Adapters are served now; a store built for another num_tasks than
    the model's is refused by the batcher and by the engine."""
    _, _, tm = _models("olmo_1b")
    other = TransformerLM(dataclasses.replace(tm.cfg, num_tasks=tm.cfg.num_tasks + 2),
                          device="cpu")
    store = TaskAdapterStore(other, ring_graph(other.cfg.num_tasks), rank=2)
    with pytest.raises(ValueError, match="adapter store serves"):
        ContinuousBatcher(tm, num_slots=1, max_seq=8, adapters=store)
    with pytest.raises(ValueError, match="adapter store serves"):
        ServeEngine(tm, max_seq=8, adapters=store)


def test_temperature_sampling_stable_under_reordering():
    """Sampled streams are keyed by (seed, request id, token index), so a
    request draws the same tokens whatever its batch position."""
    _, _, tm = _models("olmo_1b")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tm.cfg.vocab_size, (3, 5)).astype(np.int32)
    eng = ServeEngine(tm, max_seq=24, prefill_chunk=4)
    a = eng.generate({"tokens": toks}, 6, seed=3, temperature=1.0, request_ids=[10, 11, 12])
    b = eng.generate({"tokens": toks[::-1]}, 6, seed=3, temperature=1.0,
                     request_ids=[12, 11, 10])
    np.testing.assert_array_equal(a, b[::-1])
    c = eng.generate({"tokens": toks}, 6, seed=4, temperature=1.0, request_ids=[10, 11, 12])
    assert not np.array_equal(a, c)
