"""The serving executor of the port (``repro_torch.serve.step.StepExecutor``)
on the CPU, where it runs the eager step pair over its static buffers
(``cuda_graphs=False``, the only mode a CPU model has): the staged
dispatch equals ``make_serve_step`` called directly (greedy tokens and
logits exactly, dense and paged, parallel and scan prefill); a sequence of
prefill chunks and decode ticks equals the JAX package's jitted step pair
on the olmo_1b and multitask_lm smoke configs (the latter under an adapter
store), dense and paged (f32, matmul precision "highest", logits within
rtol = atol = 1e-5, identical greedy tokens and positions); the eager reset
before the prefill step re-zeroes exactly the re-admitted dense rows, as
JAX's ``reset_slot_state`` does, a slot reused after a longer prompt
included; and ``cuda_graphs=True`` on a CPU model raises from the
executor, the batcher and the engine."""
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
from repro.serve import PagingSpec as JaxPagingSpec  # noqa: E402
from repro.serve import TaskAdapterStore as JaxStore  # noqa: E402
from repro.serve.step import make_serve_step as jax_make_serve_step  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import adapters_from_numpy, load_numpy_params  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    PagingSpec,
    ServeEngine,
    TaskAdapterStore,
)
from repro_torch.serve.step import StepExecutor, make_serve_step  # noqa: E402

MAX_SEQ, CHUNK, SLOTS, BLOCK = 32, 4, 3, 8
TOL = 1e-5
_CACHE = {}


def _models(arch):
    """(JAX model, JAX params, port model on the CPU with the same weights)."""
    if arch not in _CACHE:
        jm = JaxLM(jax_get(arch, smoke=True))
        _CACHE[arch] = (jm, jm.init(jax.random.PRNGKey(0)))
    jm, params = _CACHE[arch]
    tm = load_numpy_params(TransformerLM(get(arch, smoke=True), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _table(spec, seed=0):
    """Every slot's table row: distinct shuffled physical blocks (1..)."""
    rng = np.random.default_rng(seed)
    mb = spec.max_blocks_per_slot
    ids = rng.permutation(np.arange(1, spec.num_blocks))[: SLOTS * mb]
    return ids.reshape(SLOTS, mb).astype(np.int32)


def _script(vocab, seed=1):
    """Two prefill chunks (ragged, a slot with no valid token, a reset
    only in the first), then decode ticks with a dead slot."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, SLOTS, CHUNK)).astype(np.int32)
    valid = np.zeros((2, SLOTS, CHUNK), bool)
    valid[0, 0], valid[0, 1, :2] = True, True
    valid[1, 0, :3] = True
    reset = np.array([[True, True, False], [False, False, False]])
    return toks, valid, reset


# ------------------------------------------------ staged == direct call
@pytest.mark.parametrize("prefill_mode", ["parallel", "scan"])
@pytest.mark.parametrize("paged", [False, True])
def test_staged_dispatch_equals_serve_step(paged, prefill_mode):
    _, _, tm = _models("olmo_1b")
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec) if paged else None
    caches_direct = tm.init_cache(SLOTS, MAX_SEQ, spec)
    caches_staged = tm.init_cache(SLOTS, MAX_SEQ, spec)
    decode_tick, prefill = make_serve_step(tm, prefill_mode, spec)
    ex = StepExecutor(tm, caches_staged, SLOTS, CHUNK, prefill_mode, spec, cuda_graphs=False)
    assert ex.cuda_graphs is False
    tids = np.array([1, 0, tm.cfg.num_tasks], np.int32)
    toks, valid, reset = _script(tm.cfg.vocab_size)
    pos = np.zeros(SLOTS, np.int32)
    bt = None if table is None else torch.as_tensor(table)
    for i in range(2):
        want, _, want_pos = prefill(
            torch.as_tensor(toks[i]), torch.as_tensor(tids), caches_direct, torch.as_tensor(pos),
            torch.as_tensor(valid[i]), reset[i], bt)
        greedy, last, got_pos = ex.prefill(toks[i], tids, pos, valid[i], reset[i], table)
        torch.testing.assert_close(last, want, rtol=0, atol=0)
        np.testing.assert_array_equal(greedy, want.argmax(-1).numpy())
        np.testing.assert_array_equal(got_pos, want_pos.numpy())
        pos = got_pos
    live = np.array([True, True, False])
    nxt = greedy
    for _ in range(3):
        want_tok, want, _ = decode_tick(
            torch.as_tensor(nxt), torch.as_tensor(tids), caches_direct, torch.as_tensor(pos),
            torch.as_tensor(live), bt)
        greedy, logits = ex.decode(nxt, tids, pos, live, table)
        torch.testing.assert_close(logits, want, rtol=0, atol=0)
        np.testing.assert_array_equal(greedy, want_tok.numpy())
        pos, nxt = pos + live, greedy
    lo = 1 if paged else 0  # dead lanes collide in the null block 0, never read
    for (kd, vd), (ks, vs) in zip(caches_direct, caches_staged):
        assert torch.equal(kd[lo:], ks[lo:]) and torch.equal(vd[lo:], vs[lo:])


# ------------------------------------------------------- against JAX
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["olmo_1b", "multitask_lm"])
def test_executor_matches_jax_step_pair(arch, paged):
    jm, params, tm = _models(arch)
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    jspec = JaxPagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec) if paged else None
    jtable = None if table is None else jnp.asarray(table)
    jtree = ttree = None
    if arch == "multitask_lm":  # under a randomized store holding the same raw tree
        m = tm.cfg.num_tasks
        js = JaxStore(jm, jgraph.band_graph(m, 2))
        ts = TaskAdapterStore(tm, graph.band_graph(m, 2))
        js.randomize(scale=0.1)
        adapters_from_numpy(ts, jax.tree.map(np.asarray, js.raw))
        jtree, ttree = js.serving, ts.serving
    jdecode, jprefill = jax_make_serve_step(jm, MAX_SEQ, jspec, "parallel")
    jc = jm.init_cache(SLOTS, MAX_SEQ, jspec)
    ex = StepExecutor(tm, tm.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK, "parallel", spec)
    assert ex.cuda_graphs is False  # None on a CPU model: eager
    tids = np.array([1, 3 % tm.cfg.num_tasks, tm.cfg.num_tasks], np.int32)
    toks, valid, reset = _script(tm.cfg.vocab_size, seed=2)
    pos = np.zeros(SLOTS, np.int32)
    with jax.default_matmul_precision("highest"):
        for i in range(2):
            jl, jc, jpos = jprefill(params, jnp.asarray(toks[i]), jnp.asarray(tids), jc,
                                    jnp.asarray(pos), jnp.asarray(valid[i]),
                                    jnp.asarray(reset[i]), {}, jtable, jtree)
            greedy, last, pos = ex.prefill(toks[i], tids, pos, valid[i], reset[i], table, ttree)
            rows = valid[i].any(axis=1)
            np.testing.assert_allclose(last.numpy()[rows], np.asarray(jl)[rows], rtol=TOL,
                                       atol=TOL)
            np.testing.assert_array_equal(greedy[rows], np.asarray(jl).argmax(-1)[rows])
            np.testing.assert_array_equal(pos, np.asarray(jpos))
        live = np.array([True, True, False])
        nxt = greedy
        for _ in range(3):
            jtok, jl, jc = jdecode(params, jnp.asarray(nxt), jnp.asarray(tids), jc,
                                   jnp.asarray(pos), jnp.asarray(live), jtable, jtree)
            greedy, logits = ex.decode(nxt, tids, pos, live, table, ttree)
            np.testing.assert_allclose(logits.numpy()[live], np.asarray(jl)[live], rtol=TOL,
                                       atol=TOL)
            np.testing.assert_array_equal(greedy[live], np.asarray(jtok)[live])
            pos, nxt = pos + live, greedy


# ------------------------------------------------------------ the reset
def test_eager_reset_rezeroes_exactly_the_readmitted_rows():
    """Slot 0 first holds a 7-token prompt, slot 1 a 3-token one; then a
    2-token prompt is admitted into slot 0 (reset) while slot 1 keeps its
    rows. The port's dense caches equal JAX's after its reset_slot_state
    and the same writes: slot 0's rows 2..6 (the longer prompt's tail) are
    zero again, slot 1 untouched."""
    jm, params, tm = _models("olmo_1b")
    jc = jm.init_cache(2, MAX_SEQ)
    caches = tm.init_cache(2, MAX_SEQ)
    ex = StepExecutor(tm, caches, 2, 8, cuda_graphs=False)
    rng = np.random.default_rng(5)
    tids = np.zeros(2, np.int32)
    _, jprefill = jax_make_serve_step(jm, MAX_SEQ, None, "parallel")
    steps = [  # (tokens, valid, reset, positions)
        (rng.integers(0, tm.cfg.vocab_size, (2, 8)),
         np.array([[1] * 7 + [0], [1] * 3 + [0] * 5], bool), np.array([True, True]), [0, 0]),
        (rng.integers(0, tm.cfg.vocab_size, (2, 8)),
         np.array([[1] * 2 + [0] * 6, [0] * 8], bool), np.array([True, False]), [0, 3]),
    ]
    with jax.default_matmul_precision("highest"):
        for toks, valid, reset, pos in steps:
            toks, pos = toks.astype(np.int32), np.asarray(pos, np.int32)
            _, jc, _ = jprefill(params, jnp.asarray(toks), jnp.asarray(tids), jc,
                                jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(reset), {},
                                None, None)
            ex.prefill(toks, tids, pos, valid, reset)
    jk, jv = jc[0]["slot0"]
    for i, (k, v) in enumerate(caches):
        for got, want in ((k, jk[i]), (v, jv[i])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
            assert torch.count_nonzero(got[0, 2:]) == 0  # the old tail is gone
            assert torch.count_nonzero(got[0, :2]) > 0 and torch.count_nonzero(got[1, :3]) > 0


def test_reset_is_skipped_when_no_slot_is_admitted(monkeypatch):
    """The reset runs eagerly before the step, and only on a dispatch that
    admits a slot."""
    _, _, tm = _models("olmo_1b")
    ex = StepExecutor(tm, tm.init_cache(2, MAX_SEQ), 2, CHUNK, cuda_graphs=False)
    calls = []
    monkeypatch.setattr(tm, "reset_slot_state",
                        lambda caches, reset, paging=None: calls.append(reset.tolist()))
    toks = np.ones((2, CHUNK), np.int32)
    valid = np.ones((2, CHUNK), bool)
    ex.prefill(toks, np.zeros(2, np.int32), np.zeros(2, np.int32), valid, [False, True])
    ex.prefill(toks, np.zeros(2, np.int32), np.full(2, CHUNK, np.int32), valid, [False, False])
    assert calls == [[False, True]]


# ------------------------------------------------------------ the option
def test_cuda_graphs_true_on_a_cpu_model_raises():
    _, _, tm = _models("olmo_1b")
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        StepExecutor(tm, tm.init_cache(2, MAX_SEQ), 2, CHUNK, cuda_graphs=True)
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        ContinuousBatcher(tm, num_slots=2, max_seq=MAX_SEQ, cuda_graphs=True)
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        ServeEngine(tm, max_seq=MAX_SEQ, cuda_graphs=True)
    batch = {"tokens": np.ones((2, 5), np.int32)}
    eager = ServeEngine(tm, max_seq=MAX_SEQ, prefill_chunk=CHUNK, cuda_graphs=False)
    default = ServeEngine(tm, max_seq=MAX_SEQ, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(eager.generate(batch, 4), default.generate(batch, 4))
    assert default.last_stats["captures"] == 0 and default.last_stats["capture_s"] == 0.0


def test_plain_backend_executor_matches_kernel_backend_on_cpu():
    """The plain attention backend through the executor gives the kernel
    backend's CPU tokens (both run the plain versions here)."""
    _, _, tm = _models("olmo_1b")
    plain = dataclasses.replace(tm.cfg, attn_backend="plain")
    tp = TransformerLM(plain, device="cpu")
    tp.load_state_dict(tm.state_dict())
    batch = {"tokens": np.random.default_rng(3).integers(0, 512, (3, 6)).astype(np.int32)}
    outs = [ServeEngine(m, max_seq=MAX_SEQ, prefill_chunk=CHUNK).generate(batch, 4)
            for m in (tm, tp)]
    np.testing.assert_array_equal(outs[0], outs[1])
