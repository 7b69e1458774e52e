"""The audio family (MusicGen's layout: K codebooks in and out, GELU,
LayerNorm) on the card, at the smoke config's width:

* the serving steps captured as CUDA graphs against eager dispatches over
  the same (B, C, K) inputs, dense and paged (ragged chunks, a slot reset,
  decode ticks with a dead lane): identical (B, K) greedy tokens, logits
  (B, K, V) within 1e-5;
* the kernel backend against the plain one, eagerly: logits within 1e-4,
  one attention-kernel launch per layer per dispatch;
* the engine end to end: (B, T, K) tokens with CUDA graphs == eager ==
  the plain path's, greedy; sampled, one token per codebook, the same
  with graphs and eagerly.

Every test needs a CUDA device and skips without one; the file imports no
JAX: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_audio.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import PagingSpec, ServeEngine  # noqa: E402
from repro_torch.serve.step import StepExecutor  # noqa: E402

TOL = 1e-5
PLAIN_TOL = 1e-4
MAX_SEQ, CHUNK, SLOTS, BLOCK = 64, 8, 3, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(backend="kernel"):
    cfg = dataclasses.replace(get("musicgen_large", smoke=True), attn_backend=backend)
    return TransformerLM(cfg, device="cuda", seed=0)


def _table(spec):
    if spec is None:
        return None
    mb = spec.max_blocks_per_slot
    ids = np.random.default_rng(0).permutation(np.arange(1, spec.num_blocks))
    return ids[: SLOTS * mb].reshape(SLOTS, mb).astype(np.int32)


def _script(ex, cfg, table):
    rng = np.random.default_rng(1)
    k = cfg.num_codebooks
    tids = np.array([1, 2, 0], np.int32)
    pos = np.zeros(SLOTS, np.int32)
    out = []
    for i in range(2):
        toks = rng.integers(0, cfg.vocab_size, (SLOTS, CHUNK, k)).astype(np.int32)
        valid = np.zeros((SLOTS, CHUNK), bool)
        valid[0], valid[1, : 5 - 3 * i], valid[2, : 6 * i] = True, True, True
        greedy, last, pos = ex.prefill(toks, tids, pos, valid, [i == 0, i == 0, i == 1], table)
        assert greedy.shape == (SLOTS, k) and last.shape == (SLOTS, k, cfg.vocab_size)
        out.append((greedy.copy(), last.cpu()))
    live = np.array([True, False, True])
    nxt = greedy
    for _ in range(4):
        greedy, logits = ex.decode(nxt, tids, pos, live, table)
        out.append((greedy[live], logits[live].cpu()))
        pos, nxt = pos + live, greedy
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_audio_steps_captured_equal_eager(cuda, paged):
    model = _model()
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec)
    graphed, eager = [StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                                   paging=spec, cuda_graphs=g) for g in (True, False)]
    got = _script(graphed, model.cfg, table)
    want = _script(eager, model.cfg, table)
    assert graphed.captures == 2 and eager.captures == 0
    worst = 0.0
    for (g_tok, g_log), (w_tok, w_log) in zip(got, want):
        np.testing.assert_array_equal(g_tok, w_tok)
        worst = max(worst, (g_log - w_log).abs().max().item())
    print(f"largest logits difference, graph vs eager: {worst:.3e}")
    assert worst <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_audio_kernel_backend_equals_plain(cuda, paged):
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec)
    ops = ((dec_ops.paged_decode_attention, pre_ops.paged_prefill_attention) if paged
           else (dec_ops.decode_attention, pre_ops.prefill_attention))
    runs = []
    for backend in ("kernel", "plain"):
        model = _model(backend)
        ex = StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                          paging=spec, cuda_graphs=False)
        before = [op.launches for op in ops]
        runs.append(_script(ex, model.cfg, table))
        torch.cuda.synchronize()
        layers = model.cfg.num_layers
        want = [4 * layers, 2 * layers] if backend == "kernel" else [0, 0]
        assert [op.launches - n for op, n in zip(ops, before)] == want
    worst = max((k[1] - p[1]).abs().max().item() for k, p in zip(*runs))
    print(f"largest logits difference, kernel vs plain: {worst:.3e}")
    assert worst <= PLAIN_TOL


@pytest.mark.cuda
def test_audio_engine_graphs_equal_eager_greedy_and_sampled(cuda):
    cfg = get("musicgen_large", smoke=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (n, cfg.num_codebooks)).astype(np.int32)
               for n in (9, 20, 5, 14)]
    outs = {}
    for backend, graphs in (("kernel", True), ("kernel", False), ("plain", False)):
        engine = ServeEngine(_model(backend), max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                             num_slots=2, cuda_graphs=graphs)
        outs[backend, graphs] = engine.generate({"tokens": prompts}, 6)
        if backend == "kernel":
            outs["sampled", graphs] = engine.generate({"tokens": prompts}, 6, seed=1,
                                                      temperature=1.0)
    assert outs["kernel", True].shape == (4, 6, cfg.num_codebooks)
    np.testing.assert_array_equal(outs["kernel", True], outs["kernel", False])
    np.testing.assert_array_equal(outs["kernel", True], outs["plain", False])
    np.testing.assert_array_equal(outs["sampled", True], outs["sampled", False])
