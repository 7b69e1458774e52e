"""xLSTM (mLSTM + sLSTM layers) served through the port's entry points
against the JAX package's, on the xlstm_350m smoke config with the same
weights (repro_torch.convert), CPU, float32, JAX at matmul precision
"highest". Stated tolerance: atol 2e-5, rtol 1e-5 on values; greedy tokens
and dispatch counters equal.

Covered: the weight round trip; ``forward`` / ``loss_fn``; the prefill and
decode steps (a ragged chunk with an all-invalid row, a dead lane: their
states bit for bit); batcher greedy tokens with slot reuse, and the
requests admitted into reused slots against a fresh batcher; the engine;
the prefix-cache refusal; and the adapter store's "out" pairs on recurrent
blocks against JAX's store, for xLSTM and for the Zamba2 hybrid (trees,
and a prefill chunk and decode tick under a randomized store)."""
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs import get as jax_get  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    adapters_from_numpy,
    load_numpy_params,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.core import graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402

ARCH = "xlstm_350m"
ATOL, RTOL = 2e-5, 1e-5
MAX_SEQ = 32
PROMPT_LENS = (5, 9, 3, 7)
MAX_NEWS = (4, 6, 5, 3)
SIDES = ("jax", "torch")


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _built(arch=ARCH):
    """(JAX model, JAX params with randomized task tables, the port's model
    with the same weights on the CPU)."""
    jm = JaxLM(jax_get(arch, smoke=True))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params["task"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                      for k, v in params["task"].items()}
    tm = load_numpy_params(TransformerLM(get(arch, smoke=True), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _close(want, got):
    np.testing.assert_allclose(got.detach().float().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want, np.float32), atol=ATOL, rtol=RTOL)


def test_weights_round_trip_exactly():
    """Eight slots a period (seven mLSTM, one sLSTM) at full size map to
    layers 8 i + j; at smoke size the one period's two slots; the round
    trip gives the JAX tree back bit for bit, the xLSTM leaves float32."""
    jm, params, tm = _built()
    tree = jax.tree.map(np.asarray, params)
    state = params_from_numpy(tree, tm.cfg)
    assert set(state) == set(tm.state_dict())
    np.testing.assert_array_equal(state["layers.1.slstm.r"].numpy(),
                                  tree["stages"][0]["slot1"]["slstm"]["r"][0])
    back = params_to_numpy(tm)
    assert [(p, np.shape(t)) for p, t in tree_lib.paths(back)] == [
        (p, np.shape(t)) for p, t in tree_lib.paths(tree)]
    for (p, a), (_, b) in zip(tree_lib.paths(back), tree_lib.paths(tree)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)
    full = get("xlstm_350m")
    assert (full.period, full.num_periods, full.remainder) == (8, 3, ())


def test_forward_and_loss_match_jax():
    jm, params, tm = _built()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (3, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "task_ids": np.array([0, 3, 1], np.int32)}
    jl, _ = jax.jit(jm.forward)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    jloss, jmet = jax.jit(jm.loss_fn)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tl, aux = tm.forward(tb)
        tloss, tmet = tm.loss_fn(tb)
    _close(jl, tl)
    assert float(aux) == 0.0
    _close([float(jloss), float(jmet["nll"])], np.array([float(tloss), float(tmet["nll"])]))


def test_prefill_and_decode_steps_match_jax():
    """A ragged prefill chunk (rows of 8, 3 and 0 valid tokens) then three
    decode ticks with a dead lane: the live rows' logits and every state
    against JAX's; the all-invalid row and the dead lane keep their states
    bit for bit, in the cache's own storage."""
    jm, params, tm = _built()
    cfg = tm.cfg
    b, c = 3, 8
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    tids = np.array([0, 3, 1], np.int32)
    pos = np.array([0, 5, 9], np.int32)
    valid = np.arange(c)[None, :] < np.array([8, 3, 0])[:, None]
    jc, tc = jm.init_cache(b, MAX_SEQ), tm.init_cache(b, MAX_SEQ)
    ptrs = [t.data_ptr() for e in tc for t in e]
    jl, jc = jm.prefill_step(params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(tids)},
                             jc, jnp.asarray(pos), jnp.asarray(valid))
    tl, tc = tm.prefill_step({"tokens": torch.from_numpy(toks),
                              "task_ids": torch.from_numpy(tids)},
                             tc, torch.from_numpy(pos), torch.from_numpy(valid))
    _close(np.asarray(jl)[:2], tl[:2])
    fresh = tm.init_cache(1, MAX_SEQ)
    for entry, init in zip(tc, fresh):
        for t, t0 in zip(entry, init):
            assert torch.equal(t[2], t0[0])  # the all-invalid row: untouched
    dead = [t[1].clone() for e in tc for t in e]
    pos = pos + valid.sum(1).astype(np.int32)
    live = np.array([True, False, True])
    nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
    for _ in range(3):
        jd, jc = jm.decode_step(params, {"tokens": jnp.asarray(nxt),
                                         "task_ids": jnp.asarray(tids)},
                                jc, jnp.asarray(pos), live=jnp.asarray(live))
        td, tc = tm.decode_step({"tokens": torch.from_numpy(nxt),
                                 "task_ids": torch.from_numpy(tids)},
                                tc, torch.from_numpy(pos), live=torch.from_numpy(live))
        _close(np.asarray(jd)[live], td[torch.from_numpy(live)])
        pos = pos + live
        nxt = np.asarray(jd)[:, 0].argmax(-1).astype(np.int32)[:, None]
    assert [t.data_ptr() for e in tc for t in e] == ptrs
    assert all(torch.equal(t[1], d) for t, d in zip((t for e in tc for t in e), dead))
    for layer, slot in ((0, "slot0"), (1, "slot1")):
        for want, got in zip(jc[0][slot], tc[layer]):
            _close(np.asarray(want)[0][live], got[torch.from_numpy(live)])


def _requests(side, uids=None):
    vocab = _built()[2].cfg.vocab_size
    rng = np.random.default_rng(0)
    api = jserve if side == "jax" else tserve
    reqs = [api.Request(uid=i, tokens=rng.integers(0, vocab, (n,)).astype(np.int32),
                        max_new=mn, task_id=i % 4)
            for i, (n, mn) in enumerate(zip(PROMPT_LENS, MAX_NEWS))]
    return [r for r in reqs if uids is None or r.uid in uids]


def _serve(side, uids=None, **kw):
    """Drain the requests through a fresh 2-slot batcher: ({uid: tokens},
    batcher, {uid: slot})."""
    jm, params, tm = _built()
    kw = dict(dict(num_slots=2, max_seq=MAX_SEQ, prefill_chunk=4), **kw)
    b = (jserve.ContinuousBatcher(jm, params, **kw) if side == "jax"
         else tserve.ContinuousBatcher(tm, cuda_graphs=False, **kw))
    slots = {}
    bind = b.slots.bind

    def record(s, req, **k):
        slots[req.uid] = s
        return bind(s, req, **k)

    b.slots.bind = record
    for r in _requests(side, uids):
        b.submit(r)
    return {r.uid: [int(t) for t in r.out] for r in b.run()}, b, slots


def test_batcher_matches_jax_with_slot_reuse():
    """Four requests over two slots: the same greedy tokens, dispatch
    counts and slot assignment as JAX; each request admitted into a reused
    slot decodes what it decodes alone in a fresh batcher (the slot's
    mLSTM stabilizer was reset to -1e30 on admission)."""
    outs = {}
    for side in SIDES:
        toks, b, slots = _serve(side)
        outs[side] = (toks, b.decode_dispatches, b.prefill_dispatches, slots)
    assert outs["torch"] == outs["jax"]
    toks, _, _, slots = outs["torch"]
    assert [len(toks[i]) for i in range(4)] == list(MAX_NEWS)
    first = {}
    for uid in sorted(slots):
        first.setdefault(slots[uid], uid)
    reused = [uid for uid in slots if first[slots[uid]] != uid]
    assert reused
    for uid in reused:
        alone, _, _ = _serve("torch", uids={uid})
        assert alone[uid] == toks[uid], uid


def test_engine_generate_matches_jax():
    jm, params, tm = _built()
    prompts = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (3, 7)).astype(np.int32)
    kw = dict(num_slots=2, prefill_chunk=4, max_seq=MAX_SEQ)
    want = jserve.ServeEngine(jm, params, **kw).generate({"tokens": prompts}, 5)
    got = tserve.ServeEngine(tm, cuda_graphs=False, **kw).generate({"tokens": prompts}, 5)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_prefix_cache_is_refused():
    """The prefix cache would resume recurrent state from another request's
    blocks: refused with the reason, as for the hybrid."""
    tm = _built()[2]
    spec = tserve.PagingSpec.sized(8, MAX_SEQ, 2 * MAX_SEQ)
    with pytest.raises(ValueError, match="attention-only"):
        tserve.ContinuousBatcher(tm, num_slots=2, max_seq=MAX_SEQ, paging=spec,
                                 prefix_cache=True)


@pytest.mark.parametrize("arch", [ARCH, "zamba2_7b"])
def test_out_pair_store_matches_jax(arch):
    """The store on a recurrent model: an "out" pair per recurrent slot
    (and, for the hybrid, an attn/mlp pair on the shared-attention slot);
    raw and mixed trees equal JAX's store, and under a randomized store a
    ragged prefill chunk and a decode tick with a dead lane give JAX's
    logits on the live rows; the mix is one graph-mix call over the tree."""
    jm, params, tm = _built(arch)
    m = tm.cfg.num_tasks
    js = jserve.TaskAdapterStore(jm, jgraph.band_graph(m, 1), rank=4)
    ts = tserve.TaskAdapterStore(tm, graph.band_graph(m, 1), rank=4)
    js.randomize(scale=0.3)
    adapters_from_numpy(ts, jax.tree.map(np.asarray, js.raw))
    kinds = {f"slot{j}": k for j, k in enumerate(tm.cfg.pattern)}
    for slot, leaves in ts.raw["stages"][0].items():
        want = ["out"] if kinds[slot] != "shared_attn" else ["attn", "mlp"]
        assert sorted(leaves) == want, slot
    for tree, ref in ((ts.raw, js.raw), (ts.serving, js.serving)):
        got, want = list(tree_lib.paths(tree)), list(tree_lib.paths(
            jax.tree.map(np.asarray, ref)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, w) in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w, atol=1e-6, rtol=1e-6, err_msg=p)
    rng = np.random.default_rng(5)
    b, c = 3, 5
    toks = rng.integers(0, tm.cfg.vocab_size, (b, c)).astype(np.int32)
    tids = np.array([1, 2, m], np.int32)  # the last: a dead lane's null id
    pos = np.array([0, 3, 7], np.int32)
    valid = np.ones((b, c), bool)
    valid[1, 3:] = False
    valid[2] = False
    jl, jc = jm.prefill_step(params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(tids)},
                             jm.init_cache(b, MAX_SEQ), jnp.asarray(pos), jnp.asarray(valid),
                             adapters=js.serving)
    tl, tc = tm.prefill_step({"tokens": torch.as_tensor(toks), "task_ids": torch.as_tensor(tids)},
                             tm.init_cache(b, MAX_SEQ), torch.as_tensor(pos),
                             torch.as_tensor(valid), adapters=ts.serving)
    _close(np.asarray(jl)[:2], tl[:2])
    live = np.array([True, True, False])
    pos2 = pos + valid.sum(1).astype(np.int32)
    jd, _ = jm.decode_step(params, {"tokens": jnp.asarray(toks[:, :1]),
                                    "task_ids": jnp.asarray(tids)},
                           jc, jnp.asarray(pos2), live=jnp.asarray(live), adapters=js.serving)
    td, _ = tm.decode_step({"tokens": torch.as_tensor(toks[:, :1]),
                            "task_ids": torch.as_tensor(tids)}, tc, torch.as_tensor(pos2),
                           live=torch.as_tensor(live), adapters=ts.serving)
    _close(np.asarray(jd)[:2], td[:2])
    # the "out" deltas move the logits: a zero store gives the adapter-free step
    plain, _ = tm.prefill_step({"tokens": torch.as_tensor(toks),
                                "task_ids": torch.as_tensor(tids)},
                               tm.init_cache(b, MAX_SEQ), torch.as_tensor(pos),
                               torch.as_tensor(valid))
    assert (plain[:2] - tl[:2]).abs().max() > 1e-3
