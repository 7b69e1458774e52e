"""The port's span recorder (``repro_torch.tracing``): off by default and
free of records there, the span tree it records inside the serving round,
the adapter store's update and the train step, and that recording changes
no served token and no loss. CPU, smoke sizes, no JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serve.adapters import TaskAdapterStore  # noqa: E402
from repro_torch.train import batch_to_device, init_state, make_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.stop()
    yield
    tracing.stop()


def children(recs, i):
    return [j for j, r in enumerate(recs) if r[3] == i]


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not tracing.enabled()
    a, b = tracing.span("serve.round"), tracing.span("x", uid=3)
    assert a is tracing.OFF and b is tracing.OFF
    with a:
        tracing.mark("request.queued", 1, 0, 1)
        tracing.submitted(1)
        tracing.bound(1)
    assert tracing.stop() == []


def test_nesting_parents_uids_and_drain():
    tracing.start()
    assert tracing.enabled()
    with tracing.span("serve.round"):
        with tracing.span("serve.decode", uid=7):
            with tracing.span(".wait"):
                pass
        tracing.submitted(5)
        tracing.bound(5)
    with tracing.span(".orphan"):
        pass
    recs = tracing.stop()
    assert not tracing.enabled() and tracing.stop() == []
    names = [r[0] for r in recs]
    assert names == ["serve.round", "serve.decode", "serve.decode.wait", "request.queued",
                     "orphan"]
    assert [r[3] for r in recs] == [-1, 0, 1, 0, -1]
    assert [r[4] for r in recs] == [None, 7, None, 5, None]
    for name, t0, t1, _, _ in recs:
        assert 0 < t0 <= t1, name


def _serve(store_seed: int, traced: bool, chunk_budget=None):
    cfg = get("multitask_lm", smoke=True)
    model = TransformerLM(cfg, device="cpu", seed=0)
    store = TaskAdapterStore(model, band_graph(cfg.num_tasks, 1), max_delay=2, seed=store_seed)
    store.randomize(0.5)
    bt = ContinuousBatcher(model, num_slots=2, max_seq=48, prefill_chunk=8, adapters=store,
                           chunk_budget=chunk_budget)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
                    max_new=int(k), task_id=i % cfg.num_tasks)
            for i, (n, k) in enumerate([(5, 3), (11, 4), (3, 2), (9, 3), (4, 5)])]
    if traced:
        tracing.start()
    for r in reqs:
        bt.submit(r)
    before, steps = store.updates, 0
    while bt.queue or bt.slots.any_live():
        bt.step()
        steps += 1
    recs = tracing.stop() if traced else []
    return [list(map(int, r.out)) for r in reqs], recs, bt, store.updates - before, steps


@pytest.mark.parametrize("chunk_budget", [None, 6])
def test_serving_round_spans_count_and_nest(chunk_budget):
    tokens_off, _, _, _, _ = _serve(1, False, chunk_budget)
    tokens, recs, bt, updates, steps = _serve(1, True, chunk_budget)
    assert tokens == tokens_off
    names = [r[0] for r in recs]
    assert names.count("serve.round") == steps
    assert names.count("serve.prefill") == bt.prefill_dispatches
    assert names.count("serve.decode") == bt.decode_dispatches
    assert names.count("serve.mixed") == bt.mixed_dispatches
    assert (bt.mixed_dispatches > 0) == (chunk_budget is not None) != (bt.decode_dispatches > 0)
    assert names.count("store.update") == updates == 5
    assert names.count("request.queued") == names.count("request.decode") == 5
    for i, (name, t0, t1, parent, uid) in enumerate(recs):
        assert t0 <= t1, name
        if name.startswith("request."):
            assert uid in range(5)
        if name == "request.queued":  # queued before its round: only its end inside
            assert recs[parent][0] == "serve.round" and recs[parent][1] <= t1 <= recs[parent][2]
        elif parent >= 0:
            _, p0, p1, _, _ = recs[parent]
            assert p0 <= t0 <= t1 <= p1, (name, recs[parent][0])
        if name in ("serve.prefill", "serve.decode", "serve.mixed"):
            kids = {recs[j][0] for j in children(recs, i)}
            assert {name + s for s in (".pack", ".launch", ".wait", ".emit")} <= kids
            assert recs[parent][0] == "serve.round"
        if name == "store.update":
            kids = [recs[j][0] for j in children(recs, i)]
            assert kids[0] == "store.delays" and kids[-2:] == ["store.step", "store.refresh"]
            assert "store.mix" in kids


def test_train_step_spans_and_loss():
    cfg = get("multitask_lm", smoke=True)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "task_ids": np.arange(4, dtype=np.int32) % cfg.num_tasks}
    losses = []
    for traced in (False, True):
        model = TransformerLM(cfg, device="cpu", seed=0)
        opt = adamw(1e-3)
        step = make_train_step(model, opt, GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=0.1,
                                                        tau=1.0))
        state = init_state(model, opt)
        if traced:
            tracing.start()
        state, met = step(state, batch_to_device(batch, "cpu"))
        recs = tracing.stop() if traced else []
        losses.append(float(met["loss"]))
    assert losses[0] == losses[1]
    names = [r[0] for r in recs]
    assert names == ["train.upload", "train.step", "train.grads", "train.mix", "train.optimizer"]
    assert [r[3] for r in recs] == [-1, -1, 1, 1, 1]


def test_spans_open_profiler_ranges_only_while_a_profiler_records():
    tracing.start()
    with tracing.span("serve.round"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("serve.round"):
            with tracing.span(".wait"):
                torch.zeros(4).add_(1)
    recs = tracing.stop()
    assert [r[0] for r in recs] == ["serve.round", "serve.round", "serve.round.wait"]
    names = [e.name for e in prof.events()]
    assert names.count(tracing.PREFIX + "serve.round") == 1
    assert names.count(tracing.PREFIX + "serve.round.wait") == 1
