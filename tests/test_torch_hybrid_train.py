"""The Mamba2 hybrid (zamba2_7b's smoke config: one mamba2 layer and one
shared-attention invocation) trained through the port's
``train/trainer.make_train_step`` against the JAX package's, CPU, float32,
JAX at matmul precision "highest", on the same numpy weights (random task
tables, so the graph-mixed update acts from step 0) and TokenPipeline
batches of 4 x 64 (two 32-token SSD chunks): AdamW with the graph-mixed
update, 3 steps, the loss, the nll and each leaf's norm within 1e-4
relative; parameters updated in place (the mixer's a_log, dt_bias, conv_w
and the shared block's weights move); a batcher built before training
serves the trained weights; and large-dt weights, where the chunked SSD's
exp(diff) overflows above the diagonal of a 32-token chunk: the reference
(which masks after the exp) leaves non-finite leaves after one step (0 *
inf in the backward), the port (which masks before it, a deliberate
divergence) the same loss and the reference's step at 8-token chunks,
where its arithmetic does not overflow. JAX compiles each train step once,
in a module-scoped fixture."""
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
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.trainer import TrainState as JaxTrainState  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params, params_from_numpy  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine  # noqa: E402
from repro_torch.train import batch_to_device, init_state, make_train_step  # noqa: E402

ARCH = "zamba2_7b"
STEPS = 3
SEQ, BATCH = 64, 4
LR = 1e-3
RTOL = 1e-4
BIG_DT_BIAS = 4.0  # dt ~ 4 a step: 31 steps of a 32-token chunk reach exp(124) > f32 max
SMALL_CHUNK = 8  # 7 steps: exp(28), no overflow


def _cfg():
    return get(ARCH, smoke=True)


def _batches(n=STEPS):
    cfg = _cfg()
    pipe = TokenPipeline(cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                         num_tasks=cfg.num_tasks, seed=0)
    return [b for _, b in zip(range(n), pipe)]


def _numpy_params(dt_bias=None):
    """JAX smoke params (key 0) as numpy, with random task tables and,
    given ``dt_bias``, every mamba layer's dt_bias set to it."""
    jm = JaxLM(jax_get(ARCH, smoke=True))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    params["task"] = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                      for k, v in params["task"].items()}
    if dt_bias is not None:
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: np.full_like(x, dt_bias) if "dt_bias" in jax.tree_util.keystr(path)
            else x, params)
    return jm, params


def _gmt():
    return GraphMultiTask(band_graph(_cfg().num_tasks, 1), eta=0.1, tau=1.0)


@pytest.fixture(scope="module")
def reference():
    """The JAX train step (compiled once) run from the lockstep weights and
    from the large-dt weights: per step (loss, nll) and the final params."""
    jm, params = _numpy_params()
    cfg = _cfg()
    jopt = jax_adamw(LR, weight_decay=0.01)
    jgmt = JaxGMT(jax_band(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    jstep = jax.jit(jax_make_train_step(jm, jopt, jgmt))

    def run(p, batches):
        p = jax.tree.map(jnp.asarray, p)
        state = JaxTrainState(p, jopt.init(p), jnp.zeros((), jnp.int32))
        trace = []
        for batch in batches:
            with jax.default_matmul_precision("highest"):
                state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
            trace.append((float(m["loss"]), float(m["nll"])))
        return trace, jax.tree.map(np.asarray, state.params)

    big = _numpy_params(BIG_DT_BIAS)[1]
    out = {"lockstep": run(params, _batches()), "big_dt": run(big, _batches(1)),
           "params": params, "big_params": big}
    # the same weights through the reference at a chunk its exp survives
    jm = JaxLM(dataclasses.replace(jax_get(ARCH, smoke=True), mamba_chunk=SMALL_CHUNK))
    jstep = jax.jit(jax_make_train_step(jm, jopt, jgmt))
    out["big_dt_small_chunk"] = run(big, _batches(1))
    return out


def _port(params, seed=0):
    model = TransformerLM(_cfg(), device="cpu", seed=seed)
    return load_numpy_params(model, params)


def _run_port(model, batches):
    opt = adamw(LR, weight_decay=0.01)
    step = make_train_step(model, opt, _gmt())
    state = init_state(model, opt)
    trace = []
    for batch in batches:
        state, m = step(state, batch_to_device(batch, "cpu"))
        trace.append((float(m["loss"]), float(m["nll"])))
    return trace


def test_hybrid_train_steps_lockstep_with_jax(reference):
    want, jparams = reference["lockstep"]
    model = _port(reference["params"])
    got = _run_port(model, _batches())
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1][0] < got[0][0]  # it trains
    ref = params_from_numpy(jparams, model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(float(p.detach().norm()), float(ref[name].norm()),
                                   rtol=RTOL, err_msg=name)
    task = [n for n in ref if n.startswith("task.")]
    assert task and all(not np.allclose(ref[n].numpy(), reference["params"]["task"][
        n.split(".")[1]]) for n in task)


def test_hybrid_parameters_update_in_place(reference):
    model = _port(reference["params"])
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _run_port(model, _batches())
    assert {n: p.data_ptr() for n, p in model.named_parameters()} == ptrs
    moved = {n for n, p in model.named_parameters() if not torch.equal(before[n], p)}
    for leaf in ("mamba.a_log", "mamba.dt_bias", "mamba.conv_w", "mamba.w_in"):
        assert any(n.endswith(leaf) for n in moved), leaf
    assert {n for n in ptrs if n.startswith("shared_attn.")} <= moved


def test_hybrid_train_then_serve(reference):
    """A batcher built before training serves the trained weights: the same
    greedy tokens as a fresh engine on a copy of them, unlike the untrained
    model's."""
    cfg = _cfg()
    model = _port(reference["params"])
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    tids = [0, 1, 3]
    early = ContinuousBatcher(model, num_slots=2, max_seq=32, prefill_chunk=4)
    opt = sgd(0.05)
    step, state = make_train_step(model, opt, _gmt()), init_state(model, opt)
    for batch in _batches():
        state, _ = step(state, batch_to_device(batch, "cpu"))
    for uid, (p, t) in enumerate(zip(prompts, tids)):
        early.submit(Request(uid=uid, tokens=p, max_new=6, task_id=t))
    got = {r.uid: list(r.out) for r in early.run()}
    fresh = TransformerLM(cfg, device="cpu", seed=9)
    fresh.load_state_dict(model.state_dict())
    batch = {"tokens": prompts, "task_ids": np.array(tids, np.int32)}
    want = ServeEngine(fresh, max_seq=32, prefill_chunk=4).generate(batch, 6)
    assert [got[u] for u in range(3)] == [list(r) for r in want]
    untrained = ServeEngine(_port(reference["params"]), max_seq=32,
                            prefill_chunk=4).generate(batch, 6)
    assert not np.array_equal(untrained, want)


def test_hybrid_large_dt_step_stays_finite_where_the_reference_overflows(reference):
    """dt_bias 4 on every mamba layer: exp(diff) overflows above the
    diagonal of a 32-token chunk. The reference's step there leaves some
    leaves non-finite (its masked exp gives 0 * inf in the backward); the
    port's gives the same loss and every leaf of the reference's step at
    8-token chunks, where no exp overflows (the SSD does not depend on the
    chunk)."""
    (want,), jparams = reference["big_dt"]
    (want_small,), jparams_small = reference["big_dt_small_chunk"]
    model = _port(reference["big_params"])
    (got,) = _run_port(model, _batches(1))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, want_small, rtol=RTOL)
    ref = params_from_numpy(jparams, model.cfg)
    overflowed = sorted(n for n, t in ref.items() if not torch.isfinite(t).all())
    assert "layers.0.mamba.dt_bias" in overflowed  # the reference's 0 * inf
    small = params_from_numpy(jparams_small, model.cfg)
    assert all(torch.isfinite(t).all() for t in small.values())
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
        np.testing.assert_allclose(float(p.detach().norm()), float(small[name].norm()),
                                   rtol=RTOL, err_msg=name)
    print(f"large dt: loss {got[0]:.6f} (reference {want[0]:.6f}, at {SMALL_CHUNK}-token "
          f"chunks {want_small[0]:.6f}); non-finite after the reference's step: {overflowed}; "
          "after the port's: none")
