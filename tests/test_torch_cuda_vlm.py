"""The VLM family (Pixtral-12B's layout) on the card, at the smoke
config's width with its head dim 64 and with Pixtral-12B's 160:

* the serving steps captured as CUDA graphs against eager dispatches over
  the same inputs, dense and paged (ragged prefill chunks with vision
  inputs, one chunk without any, a slot reset, decode ticks with a dead
  lane): identical greedy tokens, logits within 1e-5, the vision buffer
  read in place by the graph (its ``data_ptr`` unchanged);
* the kernel backend against the plain one, eagerly, at hd 160: logits
  within 1e-4, one attention-kernel launch per layer per dispatch;
* the batcher end to end with vision and text-only requests: graph tokens
  == eager tokens == the plain path's.

Every test needs a CUDA device and skips without one; the file imports no
JAX: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_vlm.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import ContinuousBatcher, PagingSpec, Request  # noqa: E402
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


def _model(hd, backend="kernel"):
    cfg = dataclasses.replace(get("pixtral_12b", smoke=True), head_dim=hd, attn_backend=backend)
    return TransformerLM(cfg, device="cuda", seed=0)


def _table(spec):
    if spec is None:
        return None
    mb = spec.max_blocks_per_slot
    ids = np.random.default_rng(0).permutation(np.arange(1, spec.num_blocks))
    return ids[: SLOTS * mb].reshape(SLOTS, mb).astype(np.int32)


def _script(ex, cfg, table):
    """Three prefill chunks (ragged; vision inputs in the first and third,
    none in the second; slot 2 admitted with a reset at the second) and
    four decode ticks with a dead slot; every dispatch's (greedy, logits on
    the host)."""
    rng = np.random.default_rng(1)
    tids = np.array([1, 2, 0], np.int32)
    pos = np.zeros(SLOTS, np.int32)
    out = []
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (SLOTS, CHUNK)).astype(np.int32)
        valid = np.zeros((SLOTS, CHUNK), bool)
        valid[0], valid[1, : 5 - 2 * i], valid[2, : 3 * i] = True, True, True
        vision = None
        if i != 1:
            emb = rng.standard_normal((SLOTS, CHUNK, cfg.d_model)).astype(np.float32)
            vision = (emb, (rng.random((SLOTS, CHUNK)) < 0.5) & valid)
        greedy, last, pos = ex.prefill(toks, tids, pos, valid, [i == 0, i == 0, i == 1], table,
                                       vision=vision)
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
@pytest.mark.parametrize("hd", [64, 160])
def test_vlm_steps_captured_equal_eager(cuda, hd, paged):
    model = _model(hd)
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec)
    graphed, eager = [StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                                   paging=spec, cuda_graphs=g) for g in (True, False)]
    embeds = graphed._steps["prefill"].embeds
    ptr = embeds.data_ptr()
    got = _script(graphed, model.cfg, table)
    want = _script(eager, model.cfg, table)
    assert graphed.captures == 2 and eager.captures == 0
    worst = 0.0
    for (g_tok, g_log), (w_tok, w_log) in zip(got, want):
        np.testing.assert_array_equal(g_tok, w_tok)
        worst = max(worst, (g_log - w_log).abs().max().item())
    print(f"hd {hd}: largest logits difference, graph vs eager: {worst:.3e}")
    assert worst <= TOL
    assert graphed._steps["prefill"].embeds.data_ptr() == ptr


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_vlm_kernel_backend_equals_plain_at_hd160(cuda, paged):
    spec = PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(spec)
    runs = []
    ops = ((dec_ops.paged_decode_attention, pre_ops.paged_prefill_attention) if paged
           else (dec_ops.decode_attention, pre_ops.prefill_attention))
    for backend in ("kernel", "plain"):
        model = _model(160, backend)
        ex = StepExecutor(model, model.init_cache(SLOTS, MAX_SEQ, spec), SLOTS, CHUNK,
                          paging=spec, cuda_graphs=False)
        before = [op.launches for op in ops]
        runs.append(_script(ex, model.cfg, table))
        torch.cuda.synchronize()
        launched = [op.launches - n for op, n in zip(ops, before)]
        layers = model.cfg.num_layers
        assert launched == ([4 * layers, 3 * layers] if backend == "kernel" else [0, 0])
    worst = max((k[1] - p[1]).abs().max().item() for k, p in zip(*runs))
    print(f"largest logits difference, kernel vs plain: {worst:.3e}")
    assert worst <= PLAIN_TOL


@pytest.mark.cuda
def test_vlm_batcher_graphs_equal_eager_and_plain(cuda):
    """Five requests (three with vision inputs over their first half, two
    text only) over two slots, paged: CUDA-graph tokens == eager tokens ==
    the plain backend's."""
    rng = np.random.default_rng(2)
    cfg = get("pixtral_12b", smoke=True)
    reqs = []
    for i, n in enumerate((9, 20, 5, 14, 11)):
        extras = None
        if i % 2 == 0:
            mask = np.zeros(n, bool)
            mask[: n // 2] = True
            extras = {"vision_embeds": rng.standard_normal((n, cfg.d_model)).astype(np.float32),
                      "vision_mask": mask}
        reqs.append((rng.integers(0, cfg.vocab_size, n).astype(np.int32), extras))
    outs = []
    for backend, graphs in (("kernel", True), ("kernel", False), ("plain", False)):
        model = _model(160, backend)
        bt = ContinuousBatcher(model, num_slots=2, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                               paging=PagingSpec.sized(BLOCK, MAX_SEQ, 4 * MAX_SEQ),
                               cuda_graphs=graphs)
        for uid, (toks, extras) in enumerate(reqs):
            bt.submit(Request(uid=uid, tokens=toks, max_new=6, extras=extras))
        outs.append({r.uid: r.out for r in bt.run()})
        bt.close()
    assert outs[0] == outs[1] == outs[2]
