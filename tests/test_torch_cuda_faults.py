"""Fault tolerance of the port's serving engine under CUDA graphs, on the
card, at smoke width (olmo_1b, f32):

* the swap pair leaves every pool in place (same ``data_ptr``) and the
  restored blocks bit-identical to the saved ones, with a pinned snapshot;
* a preempted request decodes the same tokens with graphs, eagerly and over
  a roomy pool without preemption, the pools never move, and the replays
  after the swap-in read the restored rows;
* a fault on the first prefill or decode dispatch leaves nothing captured
  and nothing counted, and the next dispatch captures cleanly;
* faulted dispatches leave the replay-counted launches of the attention
  wrappers what the successful dispatches account for;
* an empty plan gives the tokens and dispatch counts of ``faults=None``.

Every test needs a CUDA device and skips without one; the file imports no
JAX, so it runs on a machine with only the port's dependencies:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_faults.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    FaultPlan,
    PagingSpec,
    Request,
)
from repro_torch.serve.step import make_swap  # noqa: E402

MAX_SEQ, CHUNK, BLOCK = 32, 8, 8
SHAPES = ((9, 6), (6, 5), (12, 4))  # (prompt_len, max_new) per request
OPS = (dec_ops.decode_attention, dec_ops.paged_decode_attention, pre_ops.prefill_attention,
       pre_ops.paged_prefill_attention)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture CUDA streams only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model():
    return TransformerLM(get("olmo_1b", smoke=True), device="cuda", seed=0)


def _spec(pool_tokens=4 * MAX_SEQ):
    return PagingSpec.sized(BLOCK, MAX_SEQ, pool_tokens)


def _pointers(caches):
    return [(k.data_ptr(), v.data_ptr()) for k, v in caches]


def _serve(model, faults=None, paged=True, graphs=True, steps=None):
    """The three requests over 3 slots; ``steps`` drives that many rounds
    first and records the captures after each. Returns (tokens by uid,
    batcher, launches by op, captures after each of the first steps)."""
    bt = ContinuousBatcher(model, num_slots=3, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                           paging=_spec() if paged else None, faults=faults,
                           cuda_graphs=graphs)
    rng = np.random.default_rng(0)
    for uid, (n, new) in enumerate(SHAPES):
        bt.submit(Request(uid=uid, tokens=rng.integers(1, model.cfg.vocab_size, n)
                          .astype(np.int32), max_new=new))
    before = [op.launches for op in OPS]
    captured = []
    for _ in range(steps or 0):
        bt.step()
        captured.append(bt.captures)
    done = {r.uid: list(r.out) for r in bt.run()}
    torch.cuda.synchronize()
    launches = [op.launches - n for op, n in zip(OPS, before)]
    summary = bt.check_invariants()
    assert summary["live_slots"] == 0 and summary["queued"] == 0
    if paged:
        assert summary["live_refs"] == 0
    bt.close()
    return done, bt, launches, captured


@pytest.mark.cuda
def test_swap_pair_round_trips_in_place(cuda):
    model = _model()
    spec = _spec()
    caches = model.init_cache(3, MAX_SEQ, spec)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for pair in caches:
        for t in pair:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    before = [tuple(t.clone() for t in pair) for pair in caches]
    ptrs = _pointers(caches)
    swap_out, swap_in = make_swap(spec, model.kinds)
    src, dst = [3, 1, 7], [2, 9, 5]
    saved = swap_out(caches, src)
    (pages,), columns = saved
    assert pages.device.type == "cpu" and pages.is_pinned() and columns == []
    swap_in(caches, dst, saved)
    torch.cuda.synchronize()
    assert _pointers(caches) == ptrs
    untouched = [b for b in range(spec.num_blocks) if b not in dst]
    for pair, old in zip(caches, before):
        for t, o in zip(pair, old):
            assert torch.equal(t[dst], o[src])
            assert torch.equal(t[untouched], o[untouched])


def _pressure(model, pool_tokens, preempt, graphs):
    bt = ContinuousBatcher(model, num_slots=2, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                           paging=_spec(pool_tokens), policy="priority", preempt=preempt,
                           cuda_graphs=graphs)
    ptrs = _pointers(bt.caches)
    rng = np.random.default_rng(11)
    hog = Request(uid=0, priority=10, max_new=16,
                  tokens=rng.integers(1, model.cfg.vocab_size, 8).astype(np.int32))
    short = Request(uid=1, priority=0, max_new=6,
                    tokens=rng.integers(1, model.cfg.vocab_size, 6).astype(np.int32))
    bt.submit(hog)
    bt.step()
    bt.step()  # the hog is decoding and owns most of the pool
    bt.submit(short)
    bt.run()
    torch.cuda.synchronize()
    assert _pointers(bt.caches) == ptrs
    summary = bt.check_invariants()
    assert summary["live_slots"] == 0 and summary["live_refs"] == 0
    bt.close()
    return [list(hog.out), list(short.out)], bt, hog


@pytest.mark.cuda
def test_preempted_tokens_equal_eager_and_roomy(cuda):
    model = _model()
    want, roomy, _ = _pressure(model, 8 * BLOCK, preempt=False, graphs=True)
    assert roomy.swap_outs == 0
    for graphs in (True, False):
        got, bt, hog = _pressure(model, 4 * BLOCK, preempt=True, graphs=graphs)
        assert (bt.swap_outs, bt.swap_ins, hog.preemptions) == (1, 1, 1)
        assert bt.captures == (2 if graphs else 0)
        assert got == want, graphs


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_fault_on_the_first_dispatch_then_a_clean_capture(cuda, where):
    """The first dispatch of ``where`` fails before anything is captured
    or launched; the round after captures and serves the same tokens."""
    model = _model()
    want, _, want_launches, _ = _serve(model)
    plan = FaultPlan().script("dispatch", where=where, count=1)
    got, bt, launches, captured = _serve(model, faults=plan, steps=1)
    assert plan.log == [(0, "dispatch", None, None, where)] and bt.dispatch_faults == 1
    # prefill faults before its capture; decode faults after the prefill's
    assert captured == [0 if where == "prefill" else 1]
    assert bt.captures == 2 and got == want and launches == want_launches


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_faulted_dispatches_count_no_launches(cuda, paged):
    """Two decode faults mid-run and a prefill fault: the same dispatches
    run, so the replay-counted launches equal the fault-free run's, one
    per layer per dispatch plus the warm-up before each capture."""
    model = _model()
    _, base, base_launches, _ = _serve(model, paged=paged)
    plan = (FaultPlan().script("dispatch", where="decode", tick=3, count=2)
            .script("dispatch", where="prefill", count=1))
    _, bt, launches, _ = _serve(model, faults=plan, paged=paged)
    assert bt.dispatch_faults == 3 and len(plan.log) == 3
    assert launches == base_launches
    layers = model.cfg.num_layers
    dec, pre = (1, 3) if paged else (0, 2)
    assert launches[dec] == layers * (bt.decode_dispatches + 1)
    assert launches[pre] == layers * (bt.prefill_dispatches + 1)
    assert (bt.decode_dispatches, bt.prefill_dispatches) == (base.decode_dispatches,
                                                             base.prefill_dispatches)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_empty_plan_equals_no_plan(cuda, paged):
    model = _model()
    want, base, want_launches, _ = _serve(model, paged=paged)
    plan = FaultPlan()
    got, bt, launches, _ = _serve(model, faults=plan, paged=paged)
    assert bt.quarantine and plan.log == [] and got == want and launches == want_launches
    assert (bt.decode_dispatches, bt.prefill_dispatches, bt.captures) == (
        base.decode_dispatches, base.prefill_dispatches, base.captures)


@pytest.mark.cuda
def test_quarantine_under_graphs_fails_only_the_poisoned_lane(cuda):
    model = _model()
    want, _, _, _ = _serve(model)
    plan = FaultPlan().script("nan", uid=0, count=1)
    bt = ContinuousBatcher(model, num_slots=3, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                           paging=_spec(), faults=plan)
    rng = np.random.default_rng(0)
    for uid, (n, new) in enumerate(SHAPES):
        bt.submit(Request(uid=uid, tokens=rng.integers(1, model.cfg.vocab_size, n)
                          .astype(np.int32), max_new=new))
    done = {r.uid: r for r in bt.run()}
    bt.close()
    assert done[0].failed and "non-finite" in done[0].error and bt.quarantined == 1
    assert [list(done[uid].out) for uid in (1, 2)] == [want[1], want[2]]
    assert bt.check_invariants()["live_refs"] == 0
