"""The serving step pair captured as CUDA graphs (``repro_torch.serve.step.
StepExecutor`` with ``cuda_graphs`` on), on the card, at smoke width:

* captured against eager dispatches over the same inputs, dense, paged
  and under an adapter store: identical greedy tokens, logits and caches
  within 1e-5 (f32; the largest difference is printed), and identical
  tokens from ``ServeEngine.generate`` with and without graphs, the prefix
  cache included;
* a replay after an in-place adapter update reads the updated tree, and a
  tree whose leaves moved raises;
* the replay-counted ``.launches`` of the attention wrappers equal the
  partial kernels the profiler sees execute;
* a step body with a host sync raises at capture instead of running
  eagerly, and the executor captures cleanly afterwards;
* the warm-up before a capture leaves a dense cache, and every non-null
  block of a paged pool, bit-identical.

Every test but the last (a CPU model's executor is eager, and refuses
``cuda_graphs=True``) needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine that has only the port's dependencies:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.graph import band_graph  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import PagingSpec, ServeEngine, TaskAdapterStore  # noqa: E402
from repro_torch.serve.step import StepExecutor  # noqa: E402

MAX_SEQ, CHUNK, SLOTS, BLOCK = 64, 8, 3, 8
TOL = 1e-5
OPS = (dec_ops.decode_attention, dec_ops.paged_decode_attention, pre_ops.prefill_attention,
       pre_ops.paged_prefill_attention)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture CUDA streams only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, seed=0):
    return TransformerLM(get(arch, smoke=True), device="cuda", seed=seed)


def _store(model, scale=0.1):
    store = TaskAdapterStore(model, band_graph(model.cfg.num_tasks, 2), seed=1)
    store.randomize(scale=scale)
    return store


def _table(spec, seed=0):
    rng = np.random.default_rng(seed)
    mb = spec.max_blocks_per_slot
    ids = rng.permutation(np.arange(1, spec.num_blocks))[: SLOTS * mb]
    return ids.reshape(SLOTS, mb).astype(np.int32)


def _pair(model, spec):
    """A graph executor and an eager one, each over its own caches."""
    return [StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                         paging=spec, cuda_graphs=g) for g in (True, False)]


def _script(ex, vocab, table, tree, ticks=4, seed=1):
    """Two prefill chunks (ragged, one slot idle, resets in the first) and
    decode ticks with a dead slot; returns every dispatch's (greedy,
    logits on the host) for the live rows."""
    rng = np.random.default_rng(seed)
    tids = np.array([1, 2, 0], np.int32)
    pos = np.zeros(SLOTS, np.int32)
    out = []
    for i in range(2):
        toks = rng.integers(0, vocab, (SLOTS, CHUNK)).astype(np.int32)
        valid = np.zeros((SLOTS, CHUNK), bool)
        valid[0], valid[1, : 5 - 3 * i] = True, True
        greedy, last, pos = ex.prefill(toks, tids, pos, valid, [i == 0, i == 0, False],
                                       table, tree)
        out.append((greedy[:2], last[:2].cpu()))
    live = np.array([True, True, False])
    nxt = greedy
    for _ in range(ticks):
        greedy, logits = ex.decode(nxt, tids, pos, live, table, tree)
        out.append((greedy[:2], logits[:2].cpu()))
        pos, nxt = pos + live, greedy
    return out


def _assert_same(got, want):
    worst = 0.0
    for (g_tok, g_log), (w_tok, w_log) in zip(got, want):
        np.testing.assert_array_equal(g_tok, w_tok)
        worst = max(worst, (g_log - w_log).abs().max().item())
    print(f"largest logits difference, graph vs eager: {worst:.3e}")
    assert worst <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "paged", "adapters"])
def test_captured_steps_equal_eager(cuda, case):
    model = _model("multitask_lm" if case == "adapters" else "olmo_1b")
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if case == "paged" else None
    table = _table(spec) if spec is not None else None
    tree = _store(model).serving if case == "adapters" else None
    graphed, eager = _pair(model, spec)
    got = _script(graphed, model.cfg.vocab_size, table, tree)
    want = _script(eager, model.cfg.vocab_size, table, tree)
    assert graphed.captures == 2 and eager.captures == 0
    _assert_same(got, want)
    lo = 1 if spec is not None else 0  # the null block takes dead lanes' writes
    for gc_, ec in zip(graphed.caches, eager.caches):
        for g, e in zip(gc_, ec):
            assert (g[lo:] - e[lo:]).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "paged", "prefix", "adapters"])
def test_engine_tokens_with_graphs_equal_eager(cuda, case):
    model = _model("multitask_lm" if case == "adapters" else "olmo_1b")
    rng = np.random.default_rng(2)
    shared = rng.integers(0, model.cfg.vocab_size, 20).astype(np.int32)
    prompts = [np.concatenate([shared if case == "prefix" else shared[:0],
                               rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)])
               for n in (13, 3, 9, 21, 6)]
    batch = {"tokens": prompts, "task_ids": np.arange(5, dtype=np.int32) % model.cfg.num_tasks}
    kw = dict(max_seq=MAX_SEQ, prefill_chunk=CHUNK, num_slots=2)
    if case in ("paged", "prefix"):
        kw["paging"] = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ)
        kw["prefix_cache"] = case == "prefix"
    outs = []
    for g in (True, False):
        adapters = _store(model) if case == "adapters" else None  # same seed: same store
        engine = ServeEngine(model, adapters=adapters, cuda_graphs=g, **kw)
        outs.append(engine.generate(batch, 6))
        assert (engine.last_stats["captures"] > 0) == g
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.cuda
def test_replay_reads_in_place_adapter_updates_and_refuses_a_moved_tree(cuda):
    model = _model("multitask_lm")
    store = _store(model)
    tree = store.serving
    ptrs = [t.data_ptr() for t in tree_lib.leaves(tree)]
    graphed, eager = _pair(model, None)
    for ex in (graphed, eager):
        _script(ex, model.cfg.vocab_size, None, tree, ticks=1)
    old = tree_lib.map_(torch.clone, tree)
    store.randomize(scale=0.5)  # republished in place
    store.update()
    assert store.serving is tree and [t.data_ptr() for t in tree_lib.leaves(tree)] == ptrs
    assert any(not torch.equal(a, b) for a, b in zip(tree_lib.leaves(old),
                                                     tree_lib.leaves(tree)))
    got = _script(graphed, model.cfg.vocab_size, None, tree, ticks=2, seed=3)
    want = _script(eager, model.cfg.vocab_size, None, tree, ticks=2, seed=3)
    assert graphed.captures == 2  # the update was read by replays, not by new captures
    _assert_same(got, want)
    moved = dict(tree, task={k: v.clone() for k, v in tree["task"].items()})
    with pytest.raises(RuntimeError, match="captured with"):
        graphed.decode(np.zeros(SLOTS, np.int32), np.zeros(SLOTS, np.int32),
                       np.zeros(SLOTS, np.int32), np.ones(SLOTS, bool), None, moved)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_replay_counted_launches_equal_executed_kernels(cuda, paged):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = _model("olmo_1b")
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32) for n in (13, 3, 9)]
    engine = ServeEngine(model, max_seq=MAX_SEQ, prefill_chunk=CHUNK, num_slots=2, paging=spec)
    for op in OPS:
        op.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate({"tokens": prompts}, 5)
        torch.cuda.synchronize()
    st = engine.last_stats
    layers = model.cfg.num_layers
    dec, pre = (OPS[1], OPS[3]) if paged else (OPS[0], OPS[2])
    # one warm-up run of each step before its capture, then one per dispatch
    assert st["captures"] == 2
    assert dec.launches == layers * (st["decode_dispatches"] + 1)
    assert pre.launches == layers * (st["prefill_dispatches"] + 1)
    executed = {"decode": 0, "prefill": 0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for kind in executed:
                if f"{kind}_partial_kernel" in e.key:
                    executed[kind] += e.count
    assert executed == {"decode": dec.launches, "prefill": pre.launches}


@pytest.mark.cuda
def test_host_sync_in_the_body_raises_at_capture(cuda):
    model = _model("olmo_1b")
    ex = StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ), SLOTS, CHUNK)
    assert ex.cuda_graphs is True  # None on a CUDA model: graphs
    tick = ex.decode_tick

    def syncing(tokens, task_ids, caches, positions, *rest):
        if positions.sum().item() < 0:  # a host read of a device value
            raise AssertionError("unreachable")
        return tick(tokens, task_ids, caches, positions, *rest)

    ex.decode_tick = syncing
    counts = [op.launches for op in OPS]
    args = (np.zeros(SLOTS, np.int32), np.zeros(SLOTS, np.int32), np.zeros(SLOTS, np.int32),
            np.ones(SLOTS, bool))
    with pytest.raises(RuntimeError):
        ex.decode(*args)
    assert ex.captures == 0 and ex._steps["decode"].graph is None
    # the warm-up ran (and counts); the failed capture added nothing
    assert [op.launches for op in OPS] == [counts[0] + model.cfg.num_layers] + counts[1:]
    ex.decode_tick = tick
    greedy, _ = ex.decode(*args)
    assert ex.captures == 1 and greedy.shape == (SLOTS,)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_warmup_leaves_the_cache_bit_identical(cuda, paged):
    model = _model("olmo_1b")
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    caches = model.init_cache(SLOTS, MAX_SEQ, spec)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for pair in caches:
        for t in pair:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    before = [tuple(t.clone() for t in pair) for pair in caches]
    ex = StepExecutor(model, caches, SLOTS, CHUNK, paging=spec)
    for kind in ("prefill", "decode"):
        ex.prepare(kind)
    torch.cuda.synchronize()
    assert ex.captures == 2
    lo = 1 if paged else 0  # dead lanes write only the null block 0
    for pair, saved in zip(caches, before):
        for t, s in zip(pair, saved):
            assert torch.equal(t[lo:], s[lo:])


def test_cpu_model_runs_eagerly_and_refuses_graphs():
    """No card needed: a CPU model's executor is eager by default."""
    model = TransformerLM(dataclasses.replace(get("olmo_1b", smoke=True)), device="cpu")
    ex = StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ), SLOTS, CHUNK)
    assert ex.cuda_graphs is False
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ), SLOTS, CHUNK, cuda_graphs=True)
