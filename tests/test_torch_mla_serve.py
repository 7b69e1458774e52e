"""DeepSeek-V2 (MLA attention + MoE with a shared expert) through the
port's entry points against the JAX package's, on the deepseek_v2_236b
smoke config with the same weights (repro_torch.convert), CPU, float32,
JAX at matmul precision "highest". Stated tolerance: atol 2e-5, rtol 1e-5
on values; greedy tokens and dispatch counters equal (the smoke config
routes top-2, whose float32 combine is exact, so no margin rule is needed).

Covered: the weight round trip; ``forward`` / ``loss_fn``; the prefill and
decode steps with a ragged chunk and a dead lane, dense and paged, logits
and the latent caches; batcher greedy tokens dense and paged, the kernel
backend equal to the plain one (MLA resolves to plain, as in the
reference); the prefix cache with copy-on-write firing; a preemption that
swaps the latent pools out and back; the adapter store's trees and step
logits; a 3-step SGD loss trace with the graph-mixed update against the
JAX trainer."""
import dataclasses

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
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train import batch_to_device, init_state, make_train_step  # noqa: E402

ARCH = "deepseek_v2_236b"
ATOL, RTOL = 2e-5, 1e-5
MAX_SEQ = 32
SIDES = ("jax", "torch")
_CACHE = {}


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _pair(dropless=True, backend="kernel"):
    """JAX model + params (task tables randomized so per-task gathers show)
    and the port's model with the same weights on the CPU. Dropless
    capacity by default: the batchers compare dispatches of different
    composition against the one-request engine."""
    over = {"capacity_factor": float(get(ARCH, smoke=True).num_experts)} if dropless else {}
    if dropless not in _CACHE:
        jm = JaxLM(dataclasses.replace(jax_get(ARCH, smoke=True), **over))
        params = jm.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        params["task"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                          for k, v in params["task"].items()}
        _CACHE[dropless] = (jm, params)
    jm, params = _CACHE[dropless]
    cfg = dataclasses.replace(get(ARCH, smoke=True), attn_backend=backend, **over)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _close(want, got, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want, np.float32), atol=atol, rtol=RTOL)


def _batch(cfg, seed=1, b=3, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "task_ids": (np.arange(b) % cfg.num_tasks).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def test_weights_round_trip_exactly():
    jm, params, tm = _pair()
    tree = jax.tree.map(np.asarray, params)
    assert set(params_from_numpy(tree, tm.cfg)) == set(tm.state_dict())
    assert {"wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"} == set(tm.layers[0].attn)
    back = params_to_numpy(tm)
    assert [(p, np.shape(t)) for p, t in tree_lib.paths(back)] == [
        (p, np.shape(t)) for p, t in tree_lib.paths(tree)]
    for (p, a), (_, b) in zip(tree_lib.paths(back), tree_lib.paths(tree)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


@pytest.mark.parametrize("dropless", [False, True])
def test_forward_and_loss_match_jax(dropless):
    jm, params, tm = _pair(dropless)
    batch = _batch(tm.cfg)
    jl, jaux = jax.jit(jm.forward)(params, _jax(batch))
    jloss, jmet = jax.jit(jm.loss_fn)(params, _jax(batch))
    with torch.no_grad():
        tl, taux = tm.forward(_torch(batch))
        tloss, tmet = tm.loss_fn(_torch(batch))
    _close(jl, tl)
    assert float(taux) > 0
    _close([float(jloss), float(jmet["nll"]), float(jmet["aux"]), float(jaux)],
           np.array([float(tloss), float(tmet["nll"]), float(tmet["aux"]), float(taux)]))


def _table(spec, b, seed=0):
    ids = np.random.default_rng(seed).permutation(np.arange(1, spec.num_blocks))
    return ids[: b * spec.max_blocks_per_slot].reshape(b, -1).astype(np.int32)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_steps_match_jax(paged):
    """A ragged prefill chunk (one row with no valid token) then two decode
    ticks with a dead lane: the live rows' logits and every latent cache
    entry against JAX's (paged: the pools through shuffled block tables)."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    b, c = 3, 8
    jspec = jserve.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    tspec = tserve.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(tspec, b) if paged else None
    jt = None if table is None else jnp.asarray(table)
    tt = None if table is None else torch.from_numpy(table)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    tids = np.array([0, 3, 1], np.int32)
    pos = np.array([0, 5, 9], np.int32)
    valid = np.arange(c)[None, :] < np.array([8, 3, 0])[:, None]
    jc, tc = jm.init_cache(b, MAX_SEQ, jspec), tm.init_cache(b, MAX_SEQ, tspec)
    jl, jc = jm.prefill_step(params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(tids)},
                             jc, jnp.asarray(pos), jnp.asarray(valid), block_tables=jt)
    tl, tc = tm.prefill_step({"tokens": torch.from_numpy(toks), "task_ids": torch.from_numpy(tids)},
                             tc, torch.from_numpy(pos), torch.from_numpy(valid), block_tables=tt)
    _close(np.asarray(jl)[:2], tl[:2])
    pos = pos + valid.sum(1).astype(np.int32)
    live = np.array([True, False, True])
    nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
    for _ in range(2):
        jd, jc = jm.decode_step(params, {"tokens": jnp.asarray(nxt),
                                         "task_ids": jnp.asarray(tids)},
                                jc, jnp.asarray(pos), live=jnp.asarray(live), block_tables=jt)
        td, tc = tm.decode_step({"tokens": torch.from_numpy(nxt),
                                 "task_ids": torch.from_numpy(tids)},
                                tc, torch.from_numpy(pos), live=torch.from_numpy(live),
                                block_tables=tt)
        _close(np.asarray(jd)[live], td[torch.from_numpy(live)])
        pos = pos + live
        nxt = np.asarray(jd)[:, 0].argmax(-1).astype(np.int32)[:, None]
    for layer in range(cfg.num_layers):
        for want, got in zip(jc[0]["slot0"], tc[layer]):
            _close(np.asarray(want)[layer], got)


def _requests(side, lens=(5, 11, 3, 9), max_new=6, seed=0):
    cfg = get(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    api = jserve if side == "jax" else tserve
    return [api.Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
                        max_new=max_new, task_id=i % cfg.num_tasks)
            for i, n in enumerate(lens)]


def _batcher(side, backend="kernel", **kw):
    jm, params, tm = _pair(backend=backend)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_chunk", 4)
    if side == "jax":
        return jserve.ContinuousBatcher(jm, params, **kw)
    return tserve.ContinuousBatcher(tm, cuda_graphs=False, **kw)


def _spec(side, block_size=8, pool_tokens=4 * MAX_SEQ):
    api = jserve if side == "jax" else tserve
    return api.PagingSpec.sized(block_size, MAX_SEQ, pool_tokens=pool_tokens)


def _drive(b, reqs):
    for r in reqs:
        b.submit(r)
    return {r.uid: [int(t) for t in r.out] for r in b.run()}


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_matches_jax_and_kernel_equals_plain(paged):
    """Four requests over two slots (slot reuse, ragged chunks, dead lanes):
    the JAX batcher's greedy tokens and dispatch counts; the kernel backend
    serves what the plain one serves."""
    outs = {}
    for side, backend in (("jax", "kernel"), ("torch", "kernel"), ("torch", "plain")):
        kw = {"paging": _spec(side)} if paged else {}
        b = _batcher(side, backend, **kw)
        outs[side, backend] = (_drive(b, _requests(side)), b.decode_dispatches,
                               b.prefill_dispatches)
    assert outs["torch", "kernel"] == outs["jax", "kernel"] == outs["torch", "plain"]
    assert len(outs["jax", "kernel"][0]) == 4


def test_prefix_cache_with_copy_on_write_matches_jax():
    """Four requests over two slots behind a shared 13-token system prompt
    (not a whole number of 8-token blocks): the second wave shares the
    first wave's latent blocks and copies the partial one on write; tokens,
    hit counts and copies equal JAX's, and the tokens equal a run without
    the prefix cache."""
    rng = np.random.default_rng(6)
    system = rng.integers(0, 512, (13,)).astype(np.int32)
    tails = [rng.integers(0, 512, (n,)).astype(np.int32) for n in (4, 6, 3, 7)]
    outs = {}
    for side in SIDES:
        api = jserve if side == "jax" else tserve
        for prefix in (True, False):
            b = _batcher(side, paging=_spec(side), prefix_cache=prefix, prefill_chunk=8)
            reqs = [api.Request(uid=i, tokens=np.concatenate([system, t]), max_new=4,
                                task_id=1) for i, t in enumerate(tails)]  # one tenant
            got = _drive(b, reqs)
            stats = (b.prefix.hit_tokens, b.cow_copies) if prefix else None
            outs[side, prefix] = (got, stats)
    assert outs["torch", True] == outs["jax", True]
    assert outs["torch", True][0] == outs["torch", False][0]
    hits, cows = outs["torch", True][1]
    assert hits > 0 and cows >= 1


def test_preemption_swaps_the_latent_pools_as_jax_does():
    """A priority-10 hog swapped out of a tight pool for a priority-0
    request, then restored: tokens and swap counters equal JAX's and a
    roomy pool's; the snapshot holds two pages tensors, the latents
    (2 layers, blocks, 8, kv_lora) and the rotary keys (…, qk_rope), equal
    to JAX's pages."""
    cfg = get(ARCH, smoke=True)

    def pressure(side, pool_tokens, preempt, snaps):
        b = _batcher(side, paging=_spec(side, 8, pool_tokens), policy="priority",
                     preempt=preempt, prefill_chunk=8)
        if preempt:
            out = b._swap_out_fn

            def keep(*args):
                snaps.append((list(args[1]), out(*args)))
                return snaps[-1][1]

            b._swap_out_fn = keep
        rng = np.random.default_rng(11)
        api = jserve if side == "jax" else tserve
        b.submit(api.Request(uid=0, priority=10, max_new=16,
                             tokens=rng.integers(1, cfg.vocab_size, (8,)).astype(np.int32)))
        b.step()
        b.step()
        b.submit(api.Request(uid=1, priority=0, max_new=6,
                             tokens=rng.integers(1, cfg.vocab_size, (6,)).astype(np.int32)))
        b.run()
        return {r.uid: [int(t) for t in r.out] for r in b.finished}, b

    snaps = {side: [] for side in SIDES}
    (jt, jb), (tt, tb) = (pressure(side, 4 * 8, True, snaps[side]) for side in SIDES)
    assert tt == jt
    assert (tb.swap_outs, tb.swap_ins) == (jb.swap_outs, jb.swap_ins) == (1, 1)
    assert pressure("torch", 8 * 8, False, [])[0] == tt
    ((_, jsaved),), ((blocks, (pages, columns)),) = snaps["jax"], snaps["torch"]
    assert columns == [] and len(pages) == 2
    n = len(blocks)
    assert tuple(pages[0].shape) == (cfg.num_layers, n, 8, cfg.kv_lora)
    assert tuple(pages[1].shape) == (cfg.num_layers, n, 8, cfg.qk_rope)
    jc, jr = (np.asarray(t)[:, :n] for t in jsaved[0]["slot0"])  # (P, max_blocks, 8, ...)
    np.testing.assert_allclose(pages[0].numpy(), jc, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pages[1].numpy(), jr, atol=ATOL, rtol=RTOL)


def test_adapter_store_trees_and_steps_match_jax():
    """The store's raw and serving trees against JAX's store (structure,
    shapes, mixed values), then a prefill chunk and a decode tick under a
    randomized store: the live rows' logits within tolerance."""
    jm, params, tm = _pair()
    m = tm.cfg.num_tasks
    js = jserve.TaskAdapterStore(jm, jgraph.band_graph(m, 1), rank=4)
    ts = tserve.TaskAdapterStore(tm, graph.band_graph(m, 1), rank=4)
    js.randomize(scale=0.3)
    adapters_from_numpy(ts, jax.tree.map(np.asarray, js.raw))
    want = list(tree_lib.paths(jax.tree.map(np.asarray, js.serving)))
    got = list(tree_lib.paths(ts.serving))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-6, err_msg=p)
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
    tb = {"tokens": torch.as_tensor(toks), "task_ids": torch.as_tensor(tids)}
    tl, tc = tm.prefill_step(tb, tm.init_cache(b, MAX_SEQ), torch.as_tensor(pos),
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


def test_sgd_loss_trace_matches_jax_trainer():
    """Three make_train_step steps with SGD and the graph-mixed update
    (binding capacity): loss, nll and aux each step within tolerance of
    the JAX trainer's; the router, the per-task router bias and the MLA
    key up-projection move."""
    jm, params, tm = _pair(dropless=False)
    cfg = tm.cfg
    pipe = iter(TokenPipeline(cfg.vocab_size, seq_len=16, global_batch=8,
                              num_tasks=cfg.num_tasks, seed=0))
    jgmt = JaxGMT(jax_band(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    jstep = jax.jit(jax_make_train_step(jm, jax_sgd(0.05), jgmt))
    jstate = jax_init_state(jm, jax_sgd(0.05), jax.random.PRNGKey(0))._replace(params=params)
    gmt = GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    state = init_state(tm, sgd(0.05))
    step = make_train_step(tm, sgd(0.05), gmt)
    watched = ("layers.0.moe.router", "task.router_bias", "layers.1.attn.w_uk")
    before = {n: tm.get_parameter(n).detach().clone() for n in watched}
    for _ in range(3):
        batch = next(pipe)
        jstate, jmet = jstep(jstate, _jax(batch))
        state, met = step(state, batch_to_device(batch, "cpu"))
        _close([float(jmet[k]) for k in ("loss", "nll", "aux")],
               np.array([float(met[k]) for k in ("loss", "nll", "aux")]))
        assert float(met["aux"]) > 0
    for n in watched:
        assert not torch.equal(tm.get_parameter(n), before[n]), n
