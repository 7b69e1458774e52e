"""xLSTM (mLSTM + sLSTM) on the card, at the xlstm_350m smoke config's
width, and the adapter store's "out" pairs mixed by the graph-mix kernel:

* the serving steps captured as CUDA graphs against eager dispatches over
  the same inputs, under a randomized adapter store (ragged prefill
  chunks, a slot reset that restores the -1e30 stabilizer, decode ticks
  with a dead lane): identical greedy tokens, logits and recurrent states
  within 1e-5, every state written in place;
* the card against the CPU port with the same weights and store, eagerly:
  greedy tokens equal, logits within 1e-4;
* the store on the card: each refresh launches the graph-mix kernel (the
  launches are counted), and its trees equal the plain store's within
  the kernel's stated f32 tolerance (atol 1e-4, rtol 1e-5).

Every test needs a CUDA device and skips without one; the file imports no
JAX: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_xlstm.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.graph import band_graph  # noqa: E402
from repro_torch.kernels.graph_mix import ops as mix_ops  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import TaskAdapterStore  # noqa: E402
from repro_torch.serve.step import StepExecutor  # noqa: E402

TOL = 1e-5
CPU_TOL = 1e-4
MIX_ATOL, MIX_RTOL = 1e-4, 1e-5
MAX_SEQ, CHUNK, SLOTS = 64, 8, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device, backend="kernel"):
    cfg = dataclasses.replace(get("xlstm_350m", smoke=True), attn_backend=backend)
    return TransformerLM(cfg, device=device, seed=0)


def _store(model, raw=None):
    store = TaskAdapterStore(model, band_graph(model.cfg.num_tasks, 1), rank=4, seed=0)
    if raw is None:
        store.randomize(scale=0.3)
    else:
        store.set_raw(tree_lib.map_(lambda t: t.to(model.device), raw))
    return store


def _script(ex, vocab, adapters):
    """Two prefill chunks (ragged; slot 2 idle, then admitted with a reset)
    and four decode ticks with a dead slot; every dispatch's (greedy,
    logits on the host)."""
    rng = np.random.default_rng(1)
    tids = np.array([1, 2, 0], np.int32)
    pos = np.zeros(SLOTS, np.int32)
    out = []
    for i in range(2):
        toks = rng.integers(0, vocab, (SLOTS, CHUNK)).astype(np.int32)
        valid = np.zeros((SLOTS, CHUNK), bool)
        valid[0], valid[1, : 5 - 3 * i], valid[2, : 6 * i] = True, True, True
        greedy, last, pos = ex.prefill(toks, tids, pos, valid, [i == 0, i == 0, i == 1],
                                       adapters=adapters)
        out.append((greedy.copy(), last.cpu()))
    live = np.array([True, False, True])
    nxt = greedy
    for _ in range(4):
        greedy, logits = ex.decode(nxt, tids, pos, live, adapters=adapters)
        out.append((greedy[live], logits[live].cpu()))
        pos, nxt = pos + live, greedy
    return out


def _compare(got, want, tol):
    worst = 0.0
    for (g_tok, g_log), (w_tok, w_log) in zip(got, want):
        np.testing.assert_array_equal(g_tok, w_tok)
        worst = max(worst, (g_log - w_log).abs().max().item())
    assert worst <= tol, worst
    return worst


@pytest.mark.cuda
def test_xlstm_steps_captured_equal_eager_under_adapters(cuda):
    model = _model("cuda")
    store = _store(model)
    graphed, eager = [StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ), SLOTS, CHUNK,
                                   cuda_graphs=g) for g in (True, False)]
    ptrs = [t.data_ptr() for entry in graphed.caches for t in entry]
    got = _script(graphed, model.cfg.vocab_size, store.serving)
    want = _script(eager, model.cfg.vocab_size, store.serving)
    assert graphed.captures == 2 and eager.captures == 0
    worst = _compare(got, want, TOL)
    print(f"largest logits difference, graph vs eager: {worst:.3e}")
    assert [t.data_ptr() for entry in graphed.caches for t in entry] == ptrs
    for g, e in zip(graphed.caches, eager.caches):
        for a, b in zip(g, e):
            assert (a - b).abs().max().item() <= TOL


@pytest.mark.cuda
def test_xlstm_card_equals_cpu_port(cuda):
    cpu = _model("cpu")
    card = TransformerLM(cpu.cfg, device="cuda", seed=1)
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    cpu_store = _store(cpu)
    card_store = _store(card, cpu_store.raw)
    runs = [_script(StepExecutor(m, m.init_cache(SLOTS, MAX_SEQ), SLOTS, CHUNK,
                                 cuda_graphs=False), m.cfg.vocab_size, s.serving)
            for m, s in ((card, card_store), (cpu, cpu_store))]
    worst = _compare(*runs, CPU_TOL)
    print(f"largest logits difference, card vs CPU: {worst:.3e}")


@pytest.mark.cuda
def test_out_pair_store_mixes_through_the_kernel(cuda):
    model = _model("cuda")
    mix_ops.graph_mix.launches = 0
    store = _store(model)  # the initial refresh and randomize's
    assert mix_ops.graph_mix.launches == 2  # one launch per refresh: one dtype
    plain = _store(_model("cuda", "plain"), store.raw)
    assert mix_ops.graph_mix.launches == 2
    assert sorted(store.serving["stages"][0]) == ["slot0", "slot1"]
    for (p, a), (_, b) in zip(tree_lib.paths(store.serving), tree_lib.paths(plain.serving)):
        torch.testing.assert_close(a, b, atol=MIX_ATOL, rtol=MIX_RTOL, msg=p)
