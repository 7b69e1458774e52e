"""Graph-mixed per-task adapter serving of the port against the JAX
package's, on the multitask_lm smoke config with converted weights, CPU,
float32: prefill and decode logits under a store carried across with
``adapters_from_numpy`` (atol 1e-4); greedy tokens of the batcher on a
mixed-task batch, dense and paged (block 8), in both ``chunk_budget``
regimes, with the stores' delayed updates running as requests finish; the
engine with ``adapters=``; zero-store parity token for token, dense and
paged; consensus collapse on the complete graph; dead lanes gathering the
zero null row. Greedy tokens are compared exactly."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.serve import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serve import PagingSpec as JaxPagingSpec  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import TaskAdapterStore as JaxStore  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import adapters_from_numpy, load_numpy_params  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    PagingSpec,
    Request,
    ServeEngine,
    TaskAdapterStore,
)

MAX_SEQ = 32
_CACHE = {}


def _models(backend="kernel"):
    """(JAX model, JAX params, port model on the CPU with the same weights)."""
    if not _CACHE:
        jm = JaxLM(jax_get("multitask_lm", smoke=True))
        _CACHE["jax"] = (jm, jm.init(jax.random.PRNGKey(0)))
    jm, params = _CACHE["jax"]
    cfg = dataclasses.replace(get("multitask_lm", smoke=True), attn_backend=backend)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _stores(jm, tm, graph_name="band", scale=0.1, **kw):
    """A randomized JAX store and a port store holding the same raw tree
    (the port's randomize keeps its numpy generator in step)."""
    m = tm.cfg.num_tasks
    jg, tg = {"band": (jgraph.band_graph(m, 2), graph.band_graph(m, 2)),
              "ring": (jgraph.ring_graph(m), graph.ring_graph(m))}[graph_name]
    js = JaxStore(jm, jg, **kw)
    ts = TaskAdapterStore(tm, tg, **kw)
    js.randomize(scale=scale)
    ts.randomize(scale=scale)
    adapters_from_numpy(ts, jax.tree.map(np.asarray, js.raw))
    return js, ts


def _mixed_requests(cfg, lens=(7, 12, 5, 9, 3), max_new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, tokens=rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
                 max_new=max_new, task_id=(3 * i + 1) % cfg.num_tasks)
            for i, n in enumerate(lens)]


def _drive(batcher, req_cls, reqs):
    for r in reqs:
        batcher.submit(req_cls(**r))
    return {r.uid: list(map(int, r.out)) for r in batcher.run()}


def test_step_logits_match_jax_under_a_store():
    jm, params, tm = _models()
    js, ts = _stores(jm, tm)
    rng = np.random.default_rng(1)
    b, c = 3, 5
    toks = rng.integers(0, tm.cfg.vocab_size, (b, c)).astype(np.int32)
    tids = np.array([1, 6, tm.cfg.num_tasks], np.int32)  # the last: null id of a dead lane
    pos = np.array([0, 3, 7], np.int32)
    valid = np.ones((b, c), bool)
    valid[1, 3:] = False
    valid[2] = False
    jc = jm.init_cache(b, MAX_SEQ)
    jl, jc = jm.prefill_step(params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(tids)},
                             jc, jnp.asarray(pos), jnp.asarray(valid), adapters=js.serving)
    tc = tm.init_cache(b, MAX_SEQ)
    tl, tc = tm.prefill_step({"tokens": torch.as_tensor(toks), "task_ids": torch.as_tensor(tids)},
                             tc, torch.as_tensor(pos), torch.as_tensor(valid),
                             adapters=ts.serving)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=1e-4)
    pos2 = pos + valid.sum(1).astype(np.int32)
    live = np.array([True, True, False])
    jd, _ = jm.decode_step(params, {"tokens": jnp.asarray(toks[:, :1]),
                                    "task_ids": jnp.asarray(tids)},
                           jc, jnp.asarray(pos2), live=jnp.asarray(live), adapters=js.serving)
    td, _ = tm.decode_step({"tokens": torch.as_tensor(toks[:, :1]),
                            "task_ids": torch.as_tensor(tids)},
                           tc, torch.as_tensor(pos2), live=torch.as_tensor(live),
                           adapters=ts.serving)
    np.testing.assert_allclose(td[:2].numpy(), np.asarray(jd)[:2], atol=1e-4)
    # the adapters reach the logits: without them the rows move by far more
    plain, _ = tm.decode_step({"tokens": torch.as_tensor(toks[:, :1]),
                               "task_ids": torch.as_tensor(tids)},
                              tm.init_cache(b, MAX_SEQ), torch.as_tensor(pos2),
                              live=torch.as_tensor(live))
    assert (plain[:2] - td[:2]).abs().max() > 1e-2


@pytest.mark.parametrize("chunk_budget", [None, 4])
@pytest.mark.parametrize("paged", [False, True])
def test_batcher_matches_jax_on_mixed_task_batch(paged, chunk_budget):
    """Five requests of five tasks over two slots, the stores updating
    after every second finish with resampled delays up to 2: the same
    tokens, dispatches and store updates as the JAX batcher, and the same
    store trees afterwards."""
    jm, params, tm = _models()
    js, ts = _stores(jm, tm, update_every=2, max_delay=2, lr=0.05, seed=3)
    kw = dict(num_slots=2, max_seq=MAX_SEQ, prefill_chunk=4, chunk_budget=chunk_budget)
    jspec = JaxPagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    tspec = PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    jb = JaxBatcher(jm, params, paging=jspec, adapters=js, **kw)
    tb = ContinuousBatcher(tm, paging=tspec, adapters=ts, **kw)
    reqs = _mixed_requests(tm.cfg)
    want = _drive(jb, JaxRequest, reqs)
    got = _drive(tb, Request, reqs)
    assert got == want and len(got) == 5
    assert (tb.decode_dispatches, tb.prefill_dispatches, tb.mixed_dispatches) == (
        jb.decode_dispatches, jb.prefill_dispatches, jb.mixed_dispatches)
    assert ts.updates == js.updates == 2
    for t, j in zip(tree_lib.leaves(ts.raw), jax.tree_util.tree_leaves(js.raw)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_engine_with_adapters_matches_jax():
    jm, params, tm = _models()
    js, ts = _stores(jm, tm, graph_name="ring")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, tm.cfg.vocab_size, (4, 6)).astype(np.int32),
             "task_ids": np.array([0, 2, 5, 7], np.int32)}
    want = JaxEngine(jm, params, max_seq=MAX_SEQ, adapters=js).generate(batch, 5)
    eng = ServeEngine(tm, max_seq=MAX_SEQ, adapters=ts)
    got = eng.generate(batch, 5)
    np.testing.assert_array_equal(got, np.asarray(want))
    base = ServeEngine(tm, max_seq=MAX_SEQ).generate(batch, 5)
    assert not np.array_equal(base, got)  # the adapters change the tokens


@pytest.mark.parametrize("paged", [False, True])
def test_zero_store_parity(paged):
    """An all-zero store serves token for token what no store serves: zero
    low-rank deltas add exact zeros everywhere."""
    _, _, tm = _models()
    spec = PagingSpec.sized(8, MAX_SEQ, 8 * MAX_SEQ) if paged else None
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, tm.cfg.vocab_size, (4, 6)).astype(np.int32),
             "task_ids": (np.arange(4) % tm.cfg.num_tasks).astype(np.int32)}
    base = ServeEngine(tm, max_seq=MAX_SEQ, paging=spec).generate(batch, 5)
    store = TaskAdapterStore(tm, graph.ring_graph(tm.cfg.num_tasks), mixing="bsr")
    got = ServeEngine(tm, max_seq=MAX_SEQ, paging=spec, adapters=store).generate(batch, 5)
    np.testing.assert_array_equal(got, base)


def test_consensus_mixing_collapses_to_single_task():
    """consensus_mixing on the complete graph is J/m: one mix makes every
    task's served adapters equal, and the same prompt under different task
    ids decodes the same tokens."""
    _, _, tm = _models()
    m = tm.cfg.num_tasks
    store = TaskAdapterStore(tm, graph.complete_graph(m), mixing="consensus")
    store.randomize(scale=0.1)
    for leaf in tree_lib.leaves(store.serving):
        torch.testing.assert_close(leaf[:m], leaf[:1].expand_as(leaf[:m]), rtol=0, atol=1e-5)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, tm.cfg.vocab_size, (1, 6)).astype(np.int32)
    batch = {"tokens": np.tile(prompt, (3, 1)), "task_ids": np.array([0, 3, 7], np.int32)}
    out = ServeEngine(tm, max_seq=MAX_SEQ, adapters=store).generate(batch, 5)
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(out[0], out[2])


def test_dead_lanes_gather_the_null_row():
    """Free lanes carry task id num_tasks into every dispatch, and that id
    (or any id past it, clamped) gathers the serving tree's zero row."""
    _, _, tm = _models()
    m = tm.cfg.num_tasks
    store = TaskAdapterStore(tm, graph.ring_graph(m))
    store.randomize(scale=1.0)
    layers, task_ad = tm._gather_adapters(store.serving, torch.tensor([2, m, m + 5]))
    assert len(layers) == tm.cfg.num_layers
    for leaf in tree_lib.leaves(layers) + tree_lib.leaves(task_ad):
        assert torch.count_nonzero(leaf[1:]) == 0 and torch.count_nonzero(leaf[0]) > 0
    batcher = ContinuousBatcher(tm, num_slots=3, max_seq=MAX_SEQ, prefill_chunk=4,
                                adapters=store)
    seen = []
    tick = batcher._steps.decode_tick  # the executor's eager decode step

    def spy(tokens, task_ids, *args):
        seen.append(task_ids.tolist())
        assert args[-1] is store.serving
        return tick(tokens, task_ids, *args)

    batcher._steps.decode_tick = spy
    batcher.submit(Request(uid=0, tokens=np.array([1, 2, 3], np.int32), max_new=3, task_id=5))
    batcher.run()
    assert seen and all(ids == [5, m, m] for ids in seen)
