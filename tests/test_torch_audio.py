"""The audio family (MusicGen-large) through the port's model and entry
points against the JAX package's, on the musicgen_large smoke config (2
codebooks of 256, GELU, LayerNorm) with the same weights
(repro_torch.convert), CPU, float32, JAX at matmul precision "highest".
Stated tolerance: 1e-5 absolute on logits and the loss; greedy tokens
equal per codebook.

Covered: the (K, V, d) embedding and (d, V * K) head across the weight
round trip; the forward and loss over (B, S, K) tokens and labels; a
prefill and a decode step against the full forward and JAX's steps; the
batcher dense, paged and with a chunk budget, and ``generate``, against the
JAX batcher with a chunk budget, per codebook (the reference's admission
gulp cannot serve codebook rows: it writes them into a (num_slots, C)
slab and raises, which a test pins); the prefix cache over codebook rows;
the adapter store's trees and head-bias width (V * K) against JAX's, and
its step logits; sampling one token per codebook, stable under request
reordering and slot count; the launcher's synthetic batches and an SGD
trace of the graph-mixed update against the JAX trainer."""
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
from repro.core import GraphMultiTask as JaxGMT  # noqa: E402
from repro.core import band_graph as jax_band  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train.trainer import init_state as jax_init_state  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    adapters_from_numpy,
    load_numpy_params,
    params_to_numpy,
)
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch.train import main as launch_main  # noqa: E402
from repro_torch.launch.train import model_inputs  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train import batch_to_device, init_state, make_train_step  # noqa: E402

ARCH = "musicgen_large"
ATOL = 1e-5
MAX_SEQ = 32
SIDES = ("jax", "torch")


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX model and params (task tables randomized), built once."""
    jm = JaxLM(jax_get(ARCH, smoke=True))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params["task"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                      for k, v in params["task"].items()}
    return jm, params


def _pair():
    jm, params = _jax()
    tm = load_numpy_params(TransformerLM(get(ARCH, smoke=True), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _close(want, got, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _batch(cfg, seed=1, b=2, s=12):
    rng = np.random.default_rng(seed)
    k = cfg.num_codebooks
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s, k)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s, k)).astype(np.int32),
            "task_ids": (np.arange(b) % cfg.num_tasks).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def test_codebook_weights_round_trip_exactly():
    """embed (K, V, d), head (d, V * K), task.head_bias (T, V * K): the
    port's shapes are JAX's, and params_to_numpy gives JAX's tree back."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    k, v, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
    assert tuple(tm.embed.shape) == (k, v, d) and tuple(tm.head.shape) == (d, v * k)
    assert tuple(tm.task["head_bias"].shape) == (cfg.num_tasks, v * k)
    want = dict(tree_lib.paths(jax.tree.map(np.asarray, params)))
    got = dict(tree_lib.paths(params_to_numpy(tm)))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    fresh = TransformerLM(cfg, device="cpu", seed=3)  # a seeded init has the same shapes
    assert [tuple(p.shape) for p in fresh.parameters()] == [
        tuple(p.shape) for p in tm.parameters()]


def test_forward_and_loss_match_jax():
    """(B, S, K) tokens in, (B, S, K, V) logits out, the loss the mean over
    every codebook's label."""
    jm, params, tm = _pair()
    batch = _batch(tm.cfg)
    jl, _ = jax.jit(jm.forward)(params, _j(batch))
    jloss, _ = jax.jit(jm.loss_fn)(params, _j(batch))
    with torch.no_grad():
        tl, _ = tm.forward(_t(batch))
        loss, _ = tm.loss_fn(_t(batch))
    assert tl.shape == (2, 12, tm.cfg.num_codebooks, tm.cfg.vocab_size)
    _close(jl, tl)
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)


def test_decode_after_prefill_matches_the_full_forward():
    jm, params, tm = _pair()
    seq = 8
    full = _batch(tm.cfg, seed=2, s=seq)
    del full["labels"]
    with torch.no_grad():
        want, _ = tm.forward(_t(full))
    head = dict(full, tokens=full["tokens"][:, : seq - 1])
    last = dict(full, tokens=full["tokens"][:, seq - 1: seq])
    caches = tm.init_cache(2, MAX_SEQ)
    tm.prefill_step(_t(head), caches, torch.zeros(2, dtype=torch.int32),
                    torch.ones((2, seq - 1), dtype=torch.bool))
    got, _ = tm.decode_step(_t(last), caches, seq - 1)
    assert got.shape == (2, 1, tm.cfg.num_codebooks, tm.cfg.vocab_size)
    _close(want[:, -1], got[:, 0])
    _, jc = jax.jit(lambda p, b: jm.prefill(p, b, MAX_SEQ))(params, _j(head))
    jd, _ = jax.jit(jm.decode_step)(params, _j(last), jc, seq - 1)
    _close(jd, got)


def _requests(side, lens=(5, 9, 3, 7, 11, 4), max_new=4, seed=0, prefix=None, task=None):
    cfg = get(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    api = jserve if side == "jax" else tserve
    reqs = []
    for i, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, (n, cfg.num_codebooks)).astype(np.int32)
        if prefix is not None:
            toks = np.concatenate([prefix, toks])
        tid = i % cfg.num_tasks if task is None else task
        reqs.append(api.Request(uid=i, tokens=toks, max_new=max_new, task_id=tid))
    return reqs


def _batcher(side, **kw):
    jm, params, tm = _pair()
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_chunk", 4)
    if side == "jax":
        return jserve.ContinuousBatcher(jm, params, **kw)
    return tserve.ContinuousBatcher(tm, cuda_graphs=False, **kw)


def _drive(b, reqs):
    for r in reqs:
        b.submit(r)
    return {r.uid: np.stack(r.out).tolist() for r in b.run()}


@functools.lru_cache(maxsize=None)
def _jax_tokens(paged):
    """The JAX batcher's tokens with a chunk budget, the one admission
    regime of the reference that serves codebook rows."""
    kw = {"paging": jserve.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ)} if paged else {}
    return _drive(_batcher("jax", chunk_budget=6, **kw), _requests("jax"))


@pytest.mark.parametrize("mode", ["dense", "paged", "chunk_budget", "paged_chunk_budget"])
def test_batcher_greedy_tokens_match_jax_per_codebook(mode):
    """Six requests of (S0, 2) codebook rows over two slots: every step's
    (K,) token row equals JAX's, and the requests' first rows come from the
    prefill."""
    kw = {"paging": tserve.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ)} if "paged" in mode else {}
    if "chunk_budget" in mode:
        kw["chunk_budget"] = 6
    got = _drive(_batcher("torch", **kw), _requests("torch"))
    want = _jax_tokens("paged" in mode)
    assert got == want
    assert {len(v) for v in got.values()} == {4} and len(got[0][0]) == 2


def test_generate_matches_jax_per_codebook_and_the_reference_gulp_cannot():
    """``generate`` over a (B, S0, K) batch returns (B, T, K), JAX's tokens
    (through its batcher with a chunk budget); the JAX engine itself, whose
    admission gulp writes (S0, K) rows into a (num_slots, C) slab, raises."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 6, cfg.num_codebooks)).astype(np.int32)
    got = tserve.ServeEngine(tm, max_seq=MAX_SEQ, prefill_chunk=4).generate(
        {"tokens": toks, "task_ids": np.array([0, 1, 2], np.int32)}, 5)
    assert got.shape == (3, 5, cfg.num_codebooks)
    b = _batcher("jax", num_slots=3, chunk_budget=32)
    want = _drive(b, [jserve.Request(uid=i, tokens=t, max_new=5, task_id=i)
                      for i, t in enumerate(toks)])
    assert got.tolist() == [want[i] for i in range(3)]
    with pytest.raises(ValueError, match="broadcast"):
        jserve.ServeEngine(jm, params, max_seq=MAX_SEQ, prefill_chunk=4).generate(
            {"tokens": jnp.asarray(toks)}, 5)


def test_prefix_cache_over_codebook_rows_matches_jax():
    """Four requests behind a shared 13-row codebook prefix (not a whole
    number of 8-token blocks), one tenant, two slots, a chunk budget: the trie keys
    codebook rows (``paging._key_seq``, held to the reference's), the
    second wave hits and copies the partial block on write; tokens and hit
    counts equal JAX's, and the tokens equal a run without the cache."""
    from repro.serve.paging import _key_seq as jax_key_seq
    from repro_torch.serve.paging import _key_seq

    cfg = get(ARCH, smoke=True)
    prefix = np.random.default_rng(6).integers(0, cfg.vocab_size, (13, cfg.num_codebooks))
    prefix = prefix.astype(np.int32)
    assert _key_seq(prefix) == jax_key_seq(prefix) and _key_seq(prefix[:, 0]) == jax_key_seq(
        prefix[:, 0])
    outs = {}
    for side in SIDES:
        for cache in (True, False):
            api = jserve if side == "jax" else tserve
            b = _batcher(side, paging=api.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ),
                         prefix_cache=cache, prefill_chunk=8, chunk_budget=8)
            got = _drive(b, _requests(side, lens=(4, 6, 3, 7), prefix=prefix, task=1))
            outs[side, cache] = (got, (b.prefix.hit_tokens, b.cow_copies) if cache else None)
    assert outs["torch", True] == outs["jax", True]
    assert outs["torch", True][0] == outs["torch", False][0]
    hits, cows = outs["torch", True][1]
    assert hits > 0 and cows >= 1


def test_adapter_store_trees_widths_and_steps_match_jax():
    """The store's raw and serving trees against JAX's (structure, shapes:
    the head bias spans V * K; mixed values), then a prefill chunk and a
    decode tick under a randomized store: the live rows' logits."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    m = cfg.num_tasks
    js = jserve.TaskAdapterStore(jm, jgraph.band_graph(m, 1), rank=4)
    ts = tserve.TaskAdapterStore(tm, graph.band_graph(m, 1), rank=4)
    assert tuple(ts.raw["task"]["head_bias"].shape) == (m, cfg.vocab_size * cfg.num_codebooks)
    js.randomize(scale=0.3)
    adapters_from_numpy(ts, jax.tree.map(np.asarray, js.raw))
    want = list(tree_lib.paths(jax.tree.map(np.asarray, js.serving)))
    got = list(tree_lib.paths(ts.serving))
    assert [(p, tuple(a.shape)) for p, a in got] == [(p, a.shape) for p, a in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-6, err_msg=p)
    rng = np.random.default_rng(5)
    b, c = 3, 5
    toks = rng.integers(0, cfg.vocab_size, (b, c, cfg.num_codebooks)).astype(np.int32)
    tids = np.array([1, 2, m], np.int32)  # the last: a dead lane's null id
    pos = np.array([0, 3, 7], np.int32)
    valid = np.ones((b, c), bool)
    valid[1, 3:] = False
    valid[2] = False
    jl, jc = jm.prefill_step(params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(tids)},
                             jm.init_cache(b, MAX_SEQ), jnp.asarray(pos), jnp.asarray(valid),
                             adapters=js.serving)
    tb = {"tokens": torch.as_tensor(toks), "task_ids": torch.as_tensor(tids)}
    with torch.no_grad():
        tl, tc = tm.prefill_step(tb, tm.init_cache(b, MAX_SEQ), torch.as_tensor(pos),
                                 torch.as_tensor(valid), adapters=ts.serving)
    _close(np.asarray(jl)[:2], tl[:2])
    live = np.array([True, True, False])
    pos2 = pos + valid.sum(1).astype(np.int32)
    step = toks[:, :1]
    jd, _ = jm.decode_step(params, {"tokens": jnp.asarray(step), "task_ids": jnp.asarray(tids)},
                           jc, jnp.asarray(pos2), live=jnp.asarray(live), adapters=js.serving)
    with torch.no_grad():
        td, _ = tm.decode_step({"tokens": torch.as_tensor(step), "task_ids": torch.as_tensor(tids)},
                               tc, torch.as_tensor(pos2), live=torch.as_tensor(live),
                               adapters=ts.serving)
    _close(np.asarray(jd)[:2], td[:2])


def test_sampling_draws_one_token_per_codebook_stably():
    """temperature > 0: (B, T, K) tokens in the vocabulary, each request's
    a pure function of (seed, uid, token index) and its logits: the same
    under another request order and slot count, another under another
    seed."""
    _, _, tm = _pair()
    cfg = tm.cfg
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (n, cfg.num_codebooks)).astype(np.int32)
               for n in (5, 9, 3, 7)]
    engine = tserve.ServeEngine(tm, max_seq=MAX_SEQ, prefill_chunk=4, num_slots=2)
    a = engine.generate({"tokens": prompts}, 5, seed=3, temperature=1.0,
                        request_ids=[10, 11, 12, 13])
    order = [2, 0, 3, 1]
    engine.num_slots = 3
    b = engine.generate({"tokens": [prompts[i] for i in order]}, 5, seed=3, temperature=1.0,
                        request_ids=[10 + i for i in order])
    assert a.shape == (4, 5, cfg.num_codebooks)
    assert a.min() >= 0 and a.max() < cfg.vocab_size
    np.testing.assert_array_equal(a[order], b)
    c = engine.generate({"tokens": prompts}, 5, seed=4, temperature=1.0,
                        request_ids=[10, 11, 12, 13])
    assert not np.array_equal(a, c)
    greedy = engine.generate({"tokens": prompts}, 5)
    assert not np.array_equal(a, greedy)


def test_launcher_batches_and_sgd_trace_match_jax():
    """The launcher's synthetic batch for audio repeats tokens and labels
    over the K codebooks, as the reference launcher does; three SGD steps
    of the graph-mixed update on such batches give the JAX trainer's loss
    and nll; the launcher itself trains the smoke config on the CPU."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    pipe = iter(TokenPipeline(cfg.vocab_size, seq_len=12, global_batch=8,
                              num_tasks=cfg.num_tasks, seed=0))
    jgmt = JaxGMT(jax_band(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    jstep = jax.jit(jax_make_train_step(jm, jax_sgd(0.05), jgmt))
    jstate = jax_init_state(jm, jax_sgd(0.05), jax.random.PRNGKey(0))._replace(params=params)
    gmt = GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    state = init_state(tm, sgd(0.05))
    step = make_train_step(tm, sgd(0.05), gmt)
    for _ in range(3):
        raw = next(pipe)
        batch = model_inputs(cfg, raw)
        assert batch["tokens"].shape == raw["tokens"].shape + (cfg.num_codebooks,)
        np.testing.assert_array_equal(batch["labels"][..., 1], raw["labels"] % cfg.vocab_size)
        jstate, jmet = jstep(jstate, _j(batch))
        state, met = step(state, batch_to_device(batch, "cpu"))
        np.testing.assert_allclose([float(met[k]) for k in ("loss", "nll")],
                                   [float(jmet[k]) for k in ("loss", "nll")], rtol=1e-5)
    vlm = get("pixtral_12b", smoke=True)
    extra = model_inputs(vlm, {"tokens": np.zeros((2, 4), np.int32)})
    assert extra["vision_embeds"].shape == (2, 4, vlm.d_model) and not extra["vision_mask"].any()
    model = launch_main(["--arch", ARCH, "--steps", "2", "--batch", "4", "--seq", "8",
                         "--device", "cpu", "--log-every", "1"])
    assert model.cfg.input_mode == "audio"
