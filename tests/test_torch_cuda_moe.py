"""The port's mixture of experts on the card:

* ``apply_moe`` on CUDA against the same call on the CPU (float32, TF32
  off; atol 1e-5, aux rtol 1e-5), with binding and dropless capacity,
  dispatch groups, a router bias, the live mask and a NaN in a dead lane
  (which must stay out of the live rows), and under CUDA-graph capture
  (capacity is static: no host sync);
* the Mixtral smoke config's serving steps captured as CUDA graphs against
  eager dispatches over the same inputs, dense and paged: identical greedy
  tokens, logits within 1e-5.

Every test needs a CUDA device and skips without one; the file imports no
JAX: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models.moe import apply_moe, init_moe  # noqa: E402
from repro_torch.serve import PagingSpec  # noqa: E402
from repro_torch.serve.step import StepExecutor  # noqa: E402

D, FF, E, K = 128, 256, 8, 2
TOL = 1e-5
MAX_SEQ, CHUNK, SLOTS, BLOCK = 64, 8, 3, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _both(params, x, **kw):
    """apply_moe on the card and on the CPU: ((out, aux) card, (out, aux) CPU)."""
    def to(t, dev):
        if isinstance(t, dict):
            return {k: to(v, dev) for k, v in t.items()}
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    got = apply_moe(to(params, "cuda"), x.cuda(), top_k=K, **to(kw, "cuda"))
    want = apply_moe(params, x, top_k=K, **kw)
    return [t.cpu() for t in got], want


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("capacity", [0.5, float(E)])
@pytest.mark.parametrize("groups", [1, 4])
def test_apply_moe_on_cuda_equals_cpu(cuda, groups, capacity, shared):
    gen = torch.Generator().manual_seed(groups)
    params = init_moe(D, FF, E, shared, torch.float32, gen)
    x = torch.randn((4, 12, D), generator=gen)
    bias = torch.randn((4, 12, E), generator=gen)
    live = torch.tensor([True, False, True, True])
    x[1] = float("nan")  # a dead lane's content must not reach a live row
    (go, ga), (wo, _) = _both(params, x, capacity_factor=capacity, groups=groups,
                              router_bias=bias, live=live)
    assert torch.isfinite(go[live]).all()
    assert (go[live] - wo[live]).abs().max().item() <= TOL
    x[1] = 0.0
    (go, ga), (wo, wa) = _both(params, x, capacity_factor=capacity, groups=groups,
                               router_bias=bias, live=live)
    assert (go - wo).abs().max().item() <= TOL
    torch.testing.assert_close(ga, wa, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_apply_moe_captures_as_a_cuda_graph(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_moe(D, FF, E, 0, torch.float32, gen)
    x = torch.randn((4, 1, D), device="cuda", generator=gen)
    live = torch.tensor([True, True, False, True], device="cuda")
    eager, _ = apply_moe(params, x, top_k=K, live=live)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        apply_moe(params, x, top_k=K, live=live)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, aux = apply_moe(params, x, top_k=K, live=live)
    x.copy_(torch.randn((4, 1, D), device="cuda", generator=gen))
    graph.replay()
    want, want_aux = apply_moe(params, x, top_k=K, live=live)
    assert not torch.equal(out, eager)  # the replay read the new inputs
    assert (out - want).abs().max().item() <= TOL
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def _script(ex, vocab, table):
    """Two prefill chunks (ragged, one slot idle) and four decode ticks with
    a dead slot; every dispatch's (greedy, logits on the host), live rows."""
    rng = np.random.default_rng(1)
    tids = np.array([1, 2, 0], np.int32)
    pos = np.zeros(SLOTS, np.int32)
    out = []
    for i in range(2):
        toks = rng.integers(0, vocab, (SLOTS, CHUNK)).astype(np.int32)
        valid = np.zeros((SLOTS, CHUNK), bool)
        valid[0], valid[1, : 5 - 3 * i] = True, True
        greedy, last, pos = ex.prefill(toks, tids, pos, valid, [i == 0, i == 0, False], table)
        out.append((greedy[:2], last[:2].cpu()))
    live = np.array([True, True, False])
    nxt = greedy
    for _ in range(4):
        greedy, logits = ex.decode(nxt, tids, pos, live, table)
        out.append((greedy[:2], logits[:2].cpu()))
        pos, nxt = pos + live, greedy
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_mixtral_smoke_steps_captured_equal_eager(cuda, paged):
    model = TransformerLM(get("mixtral_8x22b", smoke=True), device="cuda", seed=0)
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = None
    if spec is not None:
        mb = spec.max_blocks_per_slot
        ids = np.random.default_rng(0).permutation(np.arange(1, spec.num_blocks))
        table = ids[: SLOTS * mb].reshape(SLOTS, mb).astype(np.int32)
    graphed, eager = [StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                                   paging=spec, cuda_graphs=g) for g in (True, False)]
    got = _script(graphed, model.cfg.vocab_size, table)
    want = _script(eager, model.cfg.vocab_size, table)
    assert graphed.captures == 2 and eager.captures == 0
    worst = 0.0
    for (g_tok, g_log), (w_tok, w_log) in zip(got, want):
        np.testing.assert_array_equal(g_tok, w_tok)
        worst = max(worst, (g_log - w_log).abs().max().item())
    print(f"largest logits difference, graph vs eager: {worst:.3e}")
    assert worst <= TOL
