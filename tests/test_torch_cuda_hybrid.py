"""The Zamba2 hybrid (mamba2 layers + one shared attention block) on the
card, at the smoke config's width and at the same width with Zamba2-7B's
head dim 112:

* the serving steps captured as CUDA graphs against eager dispatches over
  the same inputs, dense and paged (ragged prefill chunks, a slot reset,
  decode ticks with a dead lane): identical greedy tokens, logits within
  1e-5, and every recurrent state written in place (its ``data_ptr``
  unchanged, its values equal to the eager run's within 1e-5);
* the kernel backend against the plain one, eagerly: logits within 1e-4
  (the attention kernels' f32 arithmetic against the plain softmax,
  through the shared block's invocations);
* the swap pair on a hybrid pool: the slot's recurrent columns travel
  pinned beside the pages and land in the restore slot, in place.

Every test needs a CUDA device and skips without one; the file imports no
JAX: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_hybrid.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import PagingSpec  # noqa: E402
from repro_torch.serve.step import StepExecutor, make_swap  # noqa: E402

TOL = 1e-5
PLAIN_TOL = 1e-4
MAX_SEQ, CHUNK, SLOTS, BLOCK = 64, 8, 3, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(hd, backend="kernel"):
    cfg = dataclasses.replace(get("zamba2_7b", smoke=True), head_dim=hd, attn_backend=backend,
                              num_layers=4)  # two periods: two shared-block invocations
    return TransformerLM(cfg, device="cuda", seed=0)


def _table(spec):
    if spec is None:
        return None
    mb = spec.max_blocks_per_slot
    ids = np.random.default_rng(0).permutation(np.arange(1, spec.num_blocks))
    return ids[: SLOTS * mb].reshape(SLOTS, mb).astype(np.int32)


def _script(ex, vocab, table):
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
        greedy, last, pos = ex.prefill(toks, tids, pos, valid, [i == 0, i == 0, i == 1], table)
        out.append((greedy.copy(), last.cpu()))
    live = np.array([True, False, True])
    nxt = greedy
    for _ in range(4):
        greedy, logits = ex.decode(nxt, tids, pos, live, table)
        out.append((greedy[live], logits[live].cpu()))
        pos, nxt = pos + live, greedy
    return out


def _states(model, caches):
    return [t for kind, entry in zip(model.kinds, caches) if kind == "mamba" for t in entry]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("hd", [64, 112])
def test_hybrid_steps_captured_equal_eager(cuda, hd, paged):
    model = _model(hd)
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec)
    graphed, eager = [StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                                   paging=spec, cuda_graphs=g) for g in (True, False)]
    ptrs = [t.data_ptr() for t in _states(model, graphed.caches)]
    got = _script(graphed, model.cfg.vocab_size, table)
    want = _script(eager, model.cfg.vocab_size, table)
    assert graphed.captures == 2 and eager.captures == 0
    worst = 0.0
    for (g_tok, g_log), (w_tok, w_log) in zip(got, want):
        np.testing.assert_array_equal(g_tok, w_tok)
        worst = max(worst, (g_log - w_log).abs().max().item())
    print(f"largest logits difference, graph vs eager: {worst:.3e}")
    assert worst <= TOL
    assert [t.data_ptr() for t in _states(model, graphed.caches)] == ptrs
    for g, e in zip(_states(model, graphed.caches), _states(model, eager.caches)):
        assert (g - e).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_hybrid_kernel_backend_equals_plain(cuda, paged):
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec)
    runs = []
    for backend in ("kernel", "plain"):
        model = _model(112, backend)
        ex = StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                          paging=spec, cuda_graphs=False)
        runs.append(_script(ex, model.cfg.vocab_size, table))
    worst = max((k[1] - p[1]).abs().max().item() for k, p in zip(*runs))
    print(f"largest logits difference, kernel vs plain: {worst:.3e}")
    assert worst <= PLAIN_TOL


@pytest.mark.cuda
def test_hybrid_swap_pair_carries_the_slot_columns(cuda):
    model = _model(112)
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ)
    caches = model.init_cache(SLOTS, MAX_SEQ, spec)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for entry in caches:
        for t in entry:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    before = [t.clone() for entry in caches for t in entry]
    ptrs = [t.data_ptr() for entry in caches for t in entry]
    swap_out, swap_in = make_swap(spec, model.kinds)
    saved = swap_out(caches, [3, 1], 0)
    (pages,), columns = saved
    assert pages.is_pinned() and all(c.is_pinned() for c in columns)
    assert len(columns) == 2 * model.kinds.count("mamba")
    swap_in(caches, [2, 5], saved, 2)
    torch.cuda.synchronize()
    assert [t.data_ptr() for entry in caches for t in entry] == ptrs
    olds = iter(before)
    for kind, entry in zip(model.kinds, caches):
        for t, old in zip(entry, olds):
            if kind == "mamba":  # slot 0's column restored into slot 2
                assert torch.equal(t[2], old[0]) and torch.equal(t[:2], old[:2])
            else:  # blocks 3, 1 restored into blocks 2, 5
                assert torch.equal(t[[2, 5]], old[[3, 1]])
    with pytest.raises(ValueError, match="slot"):
        swap_out(caches, [3])
