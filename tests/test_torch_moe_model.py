"""The port's mixture-of-experts model (repro_torch.models.TransformerLM on
the mixtral_8x22b smoke config, sliding window shrunk to 8 as the
reference's tests shrink it) against the JAX package's, CPU, float32, JAX at
matmul precision "highest", the same weights through repro_torch.convert:
``forward`` logits (atol 1e-4) and aux (rtol 1e-5), ``loss_fn`` (rtol
1e-5); prefill then decode against the full forward (atol 1e-4, the port
of tests/test_arch_smoke.py::test_prefill_decode_consistency); greedy
serving, dense and paged, token for token against the JAX batcher and
engine (dropless capacity, where the dispatch composition cannot move a
route); scan against parallel prefill; one SGD ``make_train_step`` with the
graph-mixed update (losses rtol 1e-5, every parameter atol 1e-5); and a
``TaskAdapterStore`` with the ``router_bias`` leaf (layout, and step logits
under a randomized store, atol 1e-4)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.core import GraphMultiTask as JaxGMT  # noqa: E402
from repro.core import band_graph as jax_band  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.serve import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serve import PagingSpec as JaxPagingSpec  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import TaskAdapterStore as JaxStore  # noqa: E402
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
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    PagingSpec,
    Request,
    ServeEngine,
    TaskAdapterStore,
)
from repro_torch.train import batch_to_device, init_state, make_train_step  # noqa: E402

ARCH = "mixtral_8x22b"
WINDOW = 8
MAX_SEQ = 32
B, S = 3, 16
_CACHE = {}


def _pair(dropless=False, backend="kernel"):
    """JAX model + params (task tables randomized, the router bias strongly
    enough to move routes) and the port's model with the same weights."""
    key = dropless
    over = {"sliding_window": WINDOW}
    if dropless:
        over["capacity_factor"] = float(get(ARCH, smoke=True).num_experts)
    if key not in _CACHE:
        jm = JaxLM(dataclasses.replace(jax_get(ARCH, smoke=True), **over))
        params = jm.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        params["task"] = {
            k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                           * (1.0 if k == "router_bias" else 0.1))
            for k, v in params["task"].items()
        }
        _CACHE[key] = (jm, params)
    jm, params = _CACHE[key]
    cfg = dataclasses.replace(get(ARCH, smoke=True), attn_backend=backend, **over)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _batch(cfg, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "task_ids": (np.arange(b) % cfg.num_tasks).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def test_converted_state_covers_every_moe_weight():
    jm, params, tm = _pair()
    tree = jax.tree.map(np.asarray, params)
    assert set(params_from_numpy(tree, tm.cfg)) == set(tm.state_dict())
    assert tm.task["router_bias"].shape == (tm.cfg.num_tasks, tm.cfg.num_experts)
    assert tm.layers[0].moe["router"].dtype == torch.float32
    back = params_to_numpy(tm)
    got = [(p, np.shape(t)) for p, t in tree_lib.paths(back)]
    assert got == [(p, np.shape(t)) for p, t in tree_lib.paths(tree)]
    for (p, a), (_, b) in zip(tree_lib.paths(back), tree_lib.paths(tree)):
        np.testing.assert_array_equal(a, b, err_msg=p)


@pytest.mark.parametrize("dropless", [False, True])
def test_forward_aux_and_loss_match_jax(dropless):
    jm, params, tm = _pair(dropless)
    batch = _batch(tm.cfg)
    with jax.default_matmul_precision("highest"):
        jl, jaux = jax.jit(jm.forward)(params, _jax(batch))
        jloss, jmet = jax.jit(jm.loss_fn)(params, _jax(batch))
    with torch.no_grad():
        tl, taux = tm.forward(_torch(batch))
        tloss, tmet = tm.loss_fn(_torch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose([float(tloss), float(tmet["nll"]), float(tmet["aux"])],
                               [float(jloss), float(jmet["nll"]), float(jmet["aux"])],
                               rtol=1e-5)


def test_prefill_then_decode_matches_forward():
    """prefill_step over t_0..t_{n-2}, then decode_step on t_{n-1}: its
    logits equal the full forward's last row (dropless capacity, so the
    batched pass and the one-token pass route alike), in the port and
    against the JAX forward; the window (8) masks at n = 16."""
    jm, params, tm = _pair(dropless=True)
    batch = _batch(tm.cfg, seed=2)
    with jax.default_matmul_precision("highest"):
        jl, _ = jax.jit(jm.forward)(params, _jax(batch))
    tb = _torch(batch)
    with torch.no_grad():
        fl, _ = tm.forward(tb)
    caches = tm.init_cache(B, MAX_SEQ)
    tids = tb["task_ids"]
    _, caches = tm.prefill_step({"tokens": tb["tokens"][:, :-1], "task_ids": tids}, caches,
                                torch.zeros(B, dtype=torch.int32),
                                torch.ones((B, S - 1), dtype=torch.bool))
    dl, _ = tm.decode_step({"tokens": tb["tokens"][:, -1:], "task_ids": tids}, caches,
                           torch.full((B,), S - 1, dtype=torch.int32))
    np.testing.assert_allclose(dl[:, 0].numpy(), fl[:, -1].numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(dl[:, 0].numpy(), np.asarray(jl)[:, -1], atol=1e-4, rtol=0)


def _requests(cfg, lens=(5, 11, 3, 9), max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, tokens=rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
                 max_new=max_new, task_id=i % cfg.num_tasks) for i, n in enumerate(lens)]


def _drive(batcher, req_cls, reqs):
    for r in reqs:
        batcher.submit(req_cls(**r))
    return {r.uid: list(map(int, r.out)) for r in batcher.run()}


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_serving_matches_jax(paged):
    """Four requests over two slots (slot reuse, ragged chunks, dead lanes
    in every dispatch): the same greedy tokens and dispatch counts."""
    jm, params, tm = _pair(dropless=True)
    kw = dict(num_slots=2, max_seq=MAX_SEQ, prefill_chunk=4)
    jb = JaxBatcher(jm, params, paging=JaxPagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ)
                    if paged else None, **kw)
    tb = ContinuousBatcher(tm, paging=PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ)
                           if paged else None, **kw)
    reqs = _requests(tm.cfg)
    want = _drive(jb, JaxRequest, reqs)
    got = _drive(tb, Request, reqs)
    assert got == want and len(got) == 4
    assert (tb.decode_dispatches, tb.prefill_dispatches) == (jb.decode_dispatches,
                                                             jb.prefill_dispatches)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_engine_generate_matches_jax(backend):
    jm, params, tm = _pair(dropless=True, backend=backend)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, tm.cfg.vocab_size, (3, 12)).astype(np.int32),
             "task_ids": np.array([0, 1, 3], np.int32)}
    want = JaxEngine(jm, params, max_seq=MAX_SEQ, prefill_chunk=4).generate(batch, 8)
    got = ServeEngine(tm, max_seq=MAX_SEQ, prefill_chunk=4).generate(batch, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [None, 8])
def test_scan_prefill_equals_parallel(block):
    """Under dropless capacity the per-token scan and the parallel chunk
    give the same tokens (the step module's MoE caveat), dense and paged,
    in the port and in JAX (tests/test_serve_prefill.py's mixtral cases)."""
    jm, params, tm = _pair(dropless=True)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, tm.cfg.vocab_size, (2, 10)).astype(np.int32)}
    kw = dict(max_seq=MAX_SEQ, prefill_chunk=4)
    par = ServeEngine(tm, **kw, paging=block and PagingSpec.sized(block, MAX_SEQ, 4 * MAX_SEQ)
                      ).generate(batch, 6)
    scan = ServeEngine(tm, **kw, prefill_mode="scan",
                       paging=block and PagingSpec.sized(block, MAX_SEQ, 4 * MAX_SEQ)
                       ).generate(batch, 6)
    np.testing.assert_array_equal(par, scan)
    want = JaxEngine(jm, params, **kw, prefill_mode="scan",
                     paging=block and JaxPagingSpec.sized(block, MAX_SEQ, 4 * MAX_SEQ)
                     ).generate(batch, 6)
    np.testing.assert_array_equal(scan, want)


def test_sgd_train_step_matches_jax():
    """One make_train_step with SGD and the graph-mixed update, binding
    capacity: loss, nll and aux, and every parameter elementwise. The
    router and the per-task router bias train (their gradients are
    nonzero), and GraphMultiTask mixes task.router_bias."""
    jm, params, tm = _pair()
    cfg = tm.cfg
    pipe = TokenPipeline(cfg.vocab_size, seq_len=16, global_batch=8,
                         num_tasks=cfg.num_tasks, seed=0)
    batch = next(iter(pipe))
    jgmt = JaxGMT(jax_band(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    jopt = jax_sgd(0.05)
    jstep = jax.jit(jax_make_train_step(jm, jopt, jgmt))
    jstate = jax_init_state(jm, jopt, jax.random.PRNGKey(0))
    jstate = jstate._replace(params=params)
    gmt = GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    state = init_state(tm, sgd(0.05))
    _, task = gmt.partition(state.params)
    assert task["task.router_bias"] is tm.task["router_bias"]
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    with jax.default_matmul_precision("highest"):
        jstate, jmet = jstep(jstate, _jax(batch))
    state, met = make_train_step(tm, sgd(0.05), gmt)(state, batch_to_device(batch, "cpu"))
    np.testing.assert_allclose([float(met[k]) for k in ("loss", "nll", "aux")],
                               [float(jmet[k]) for k in ("loss", "nll", "aux")], rtol=1e-5)
    assert float(met["aux"]) > 0
    want = params_from_numpy(jax.tree.map(np.asarray, jstate.params), tm.cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    for name in ("layers.0.moe.router", "layers.1.moe.router", "task.router_bias"):
        assert not torch.equal(tm.get_parameter(name), before[name]), name


def _stores(jm, tm, scale=0.3):
    m = tm.cfg.num_tasks
    js = JaxStore(jm, jgraph.band_graph(m, 1), rank=4)
    ts = TaskAdapterStore(tm, graph.band_graph(m, 1), rank=4)
    js.randomize(scale=scale)
    adapters_from_numpy(ts, jax.tree.map(np.asarray, js.raw))
    return js, ts


def test_adapter_store_router_bias_matches_jax():
    jm, params, tm = _pair()
    js, ts = _stores(jm, tm)
    got = [(p, tuple(t.shape)) for p, t in tree_lib.paths(ts.serving)]
    assert got == [(p, np.shape(t)) for p, t in tree_lib.paths(
        jax.tree.map(np.asarray, js.serving))]
    assert ts.raw["task"]["router_bias"].shape == (tm.cfg.num_tasks, tm.cfg.num_experts)
    rng = np.random.default_rng(5)
    b, c = 3, 5
    toks = rng.integers(0, tm.cfg.vocab_size, (b, c)).astype(np.int32)
    tids = np.array([1, 2, tm.cfg.num_tasks], np.int32)  # the last: a dead lane's null id
    pos = np.array([0, 3, 7], np.int32)
    valid = np.ones((b, c), bool)
    valid[1, 3:] = False
    valid[2] = False
    with jax.default_matmul_precision("highest"):
        jl, jc = jm.prefill_step(params, {"tokens": jnp.asarray(toks),
                                          "task_ids": jnp.asarray(tids)},
                                 jm.init_cache(b, MAX_SEQ), jnp.asarray(pos),
                                 jnp.asarray(valid), adapters=js.serving)
        live = np.array([True, True, False])
        pos2 = pos + valid.sum(1).astype(np.int32)
        jd, _ = jm.decode_step(params, {"tokens": jnp.asarray(toks[:, :1]),
                                        "task_ids": jnp.asarray(tids)},
                               jc, jnp.asarray(pos2), live=jnp.asarray(live),
                               adapters=js.serving)
    tb = {"tokens": torch.as_tensor(toks), "task_ids": torch.as_tensor(tids)}
    tl, tc = tm.prefill_step(tb, tm.init_cache(b, MAX_SEQ), torch.as_tensor(pos),
                             torch.as_tensor(valid), adapters=ts.serving)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=1e-4)
    db = {"tokens": torch.as_tensor(toks[:, :1]), "task_ids": torch.as_tensor(tids)}
    td, _ = tm.decode_step(db, tc, torch.as_tensor(pos2), live=torch.as_tensor(live),
                           adapters=ts.serving)
    np.testing.assert_allclose(td[:2].numpy(), np.asarray(jd)[:2], atol=1e-4)
    # the router-bias delta alone moves the routed rows
    rb = ts.serving["task"]["router_bias"]
    saved = rb.clone()
    rb.zero_()
    tz, _ = tm.prefill_step(tb, tm.init_cache(b, MAX_SEQ), torch.as_tensor(pos),
                            torch.as_tensor(valid), adapters=ts.serving)
    rb.copy_(saved)
    assert (tz[:2] - tl[:2]).abs().max() > 1e-4
