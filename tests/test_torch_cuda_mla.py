"""DeepSeek-V2's MLA + MoE model on the card, at the deepseek_v2_236b smoke
config's width (dropless capacity, so that dispatches of any composition
route alike):

* the serving steps captured as CUDA graphs against eager dispatches over
  the same inputs, dense and paged (ragged prefill chunks, a slot reset,
  decode ticks with a dead lane): identical greedy tokens, logits within
  1e-5, the latent pools written in place;
* the card against the CPU port with the same weights, eagerly: greedy
  tokens equal, logits within 1e-4 (float32 sums in other orders);
* no attention-kernel launch on the kernel backend (MLA resolves to the
  plain path, as in the reference).

Every test needs a CUDA device and skips without one; the file imports no
JAX: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mla.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import PagingSpec  # noqa: E402
from repro_torch.serve.step import StepExecutor  # noqa: E402

TOL = 1e-5
CPU_TOL = 1e-4
MAX_SEQ, CHUNK, SLOTS, BLOCK = 64, 8, 3, 8
ATTENTION_OPS = (dec_ops.decode_attention, dec_ops.paged_decode_attention,
                 pre_ops.prefill_attention, pre_ops.paged_prefill_attention)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device):
    cfg = get("deepseek_v2_236b", smoke=True)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return TransformerLM(cfg, device=device, seed=0)


def _on(model, device):
    """A copy of ``model``'s weights on ``device``."""
    other = TransformerLM(model.cfg, device=device, seed=1)
    other.load_state_dict({k: v.to(device) for k, v in model.state_dict().items()})
    return other


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


def _compare(got, want, tol):
    worst = 0.0
    for (g_tok, g_log), (w_tok, w_log) in zip(got, want):
        np.testing.assert_array_equal(g_tok, w_tok)
        worst = max(worst, (g_log - w_log).abs().max().item())
    assert worst <= tol, worst
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_mla_steps_captured_equal_eager(cuda, paged):
    model = _model("cuda")
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec)
    graphed, eager = [StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                                   paging=spec, cuda_graphs=g) for g in (True, False)]
    ptrs = [t.data_ptr() for entry in graphed.caches for t in entry]
    for op in ATTENTION_OPS:
        op.launches = 0
    got = _script(graphed, model.cfg.vocab_size, table)
    want = _script(eager, model.cfg.vocab_size, table)
    assert graphed.captures == 2 and eager.captures == 0
    worst = _compare(got, want, TOL)
    print(f"largest logits difference, graph vs eager: {worst:.3e}")
    assert [t.data_ptr() for entry in graphed.caches for t in entry] == ptrs
    # a pool's null block 0 is the dead lanes' write sink, never read: the
    # graph run's warm-up (every lane dead) writes it where eager does not
    skip = 1 if paged else 0
    for g, e in zip(graphed.caches, eager.caches):
        for a, b in zip(g, e):
            assert (a[skip:] - b[skip:]).abs().max().item() <= TOL
    assert [op.launches for op in ATTENTION_OPS] == [0, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_mla_card_equals_cpu_port(cuda, paged):
    cpu = _model("cpu")
    card = _on(cpu, "cuda")
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec)
    runs = [_script(StepExecutor(m, m.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                                 paging=spec, cuda_graphs=False), m.cfg.vocab_size, table)
            for m in (card, cpu)]
    worst = _compare(*runs, CPU_TOL)
    print(f"largest logits difference, card vs CPU: {worst:.3e}")
