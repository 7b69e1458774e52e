"""The port's trainer (repro_torch.train) against the JAX package's
(repro.train), CPU, float32, JAX at matmul precision "highest": the
reference's tests/test_train_serve.py training tests ported; 10-step
lockstep with repro.train.train_loop and with make_train_step under
microbatching (strided split, float32 accumulation, the whole-batch
fallback) and the explicit graph penalty (losses rtol 1e-5, parameters
atol 1e-5); parameters updated in place; train, then serve. The
30-step loss-decrease test lives in test_torch_train_loop.py, a file of
its own so that the test runner's per-file workers spread the two."""
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
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402
from repro.train.trainer import init_state as jax_init_state  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine  # noqa: E402
from repro_torch.train import batch_to_device, init_state, make_train_step, train_loop  # noqa: E402

STEPS = 10


def _pipe(cfg, seq=16, batch=8):
    return TokenPipeline(cfg.vocab_size, seq_len=seq, global_batch=batch,
                         num_tasks=cfg.num_tasks, seed=0)


def _gmt(cfg, eta=0.1, tau=1.0):
    return GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=eta, tau=tau)


def test_multitask_mixing_changes_task_params_only():
    cfg = get("qwen2_5_14b", smoke=True)
    params = dict(TransformerLM(cfg, device="cpu", seed=1).named_parameters())
    with torch.no_grad():  # distinct task values so mixing has an effect
        params["task.final_gain"].copy_(
            torch.arange(cfg.num_tasks, dtype=torch.float32)[:, None].expand(-1, cfg.d_model))
    gmt = GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=0.5, tau=2.0)
    with torch.no_grad():
        mixed = gmt.mix_task_params(params)
    assert torch.equal(mixed["embed"], params["embed"])
    before = params["task.final_gain"][:, 0].detach().numpy()
    after = mixed["task.final_gain"][:, 0].numpy()
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, gmt.mixing_matrix().T @ before, rtol=1e-5, atol=1e-5)


def _pair(arch="multitask_lm"):
    jm = JaxLM(jax_get(arch, smoke=True))
    params = jm.init(jax.random.PRNGKey(0))
    tm = load_numpy_params(TransformerLM(get(arch, smoke=True), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _params_close(jparams, tm, atol=1e-5):
    want = params_from_numpy(jax.tree.map(np.asarray, jparams), tm.cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


def _norms_close(jparams, tm, init, rtol=1e-5):
    """Each leaf's Frobenius norm within ``rtol`` of the reference's. AdamW's
    parameters are held this way (and by the loss trace), not elementwise:
    where a gradient is near zero, the two frameworks' summation orders
    change it by tens of percent and Adam turns it into a step of up to lr
    either way (measured: one element of 8192 7.2e-5 apart after 10 steps
    at lr 1e-3, its gradient 1e-8 against eps 1e-8)."""
    want = params_from_numpy(jax.tree.map(np.asarray, jparams), tm.cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(float(p.detach().norm()), float(want[name].norm()),
                                   rtol=rtol, err_msg=name)


# SGD with momentum is held elementwise: its step is linear in the gradient
OPTIMIZERS = {"sgd": (lambda: jax_sgd(0.05, 0.9), lambda: sgd(0.05, 0.9),
                      lambda jp, tm, init: _params_close(jp, tm)),
              "adamw": (lambda: jax_adamw(1e-3, weight_decay=0.01),
                        lambda: adamw(1e-3, weight_decay=0.01), _norms_close)}


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_train_loop_lockstep_with_jax(opt_name):
    make_jax, make_torch, close = OPTIMIZERS[opt_name]
    jm, params, tm = _pair()
    cfg = tm.cfg
    jgmt = JaxGMT(jax_band(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    with jax.default_matmul_precision("highest"):
        jstate, jhist = jax_train_loop(jm, make_jax(), iter(_pipe(cfg)), STEPS,
                                       key=jax.random.PRNGKey(0), multitask=jgmt,
                                       log_every=1)
    state, hist = train_loop(tm, make_torch(), iter(_pipe(cfg)), STEPS,
                             multitask=_gmt(cfg), log_every=1)
    assert state.step == STEPS and int(jstate.step) == STEPS
    for h, jh in zip(hist, jhist, strict=True):
        assert h["step"] == jh["step"]
        np.testing.assert_allclose([h["loss"], h["nll"]], [jh["loss"], jh["nll"]], rtol=1e-5)
    close(jstate.params, tm, params)


@pytest.mark.parametrize("microbatches,penalty", [(2, 0.0), (1, 0.5), (2, 0.5), (3, 0.5)])
@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_train_step_lockstep_with_jax(opt_name, microbatches, penalty):
    """make_train_step on both sides: 2 strided microbatches accumulated in
    float32, the explicit graph penalty, and 3 (8 % 3 != 0: the whole
    batch in one pass, as the reference falls back)."""
    make_jax, make_torch, close = OPTIMIZERS[opt_name]
    jm, params, tm = _pair()
    cfg = tm.cfg
    kw = dict(graph_penalty_weight=penalty, microbatches=microbatches)
    jgmt = JaxGMT(jax_band(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    jopt, opt = make_jax(), make_torch()
    jstep = jax.jit(jax_make_train_step(jm, jopt, jgmt, **kw))
    jstate = jax_init_state(jm, jopt, jax.random.PRNGKey(0))
    step = make_train_step(tm, opt, _gmt(cfg), **kw)
    state = init_state(tm, opt)
    for i, batch in zip(range(STEPS), _pipe(cfg)):
        with jax.default_matmul_precision("highest"):
            jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch_to_device(batch, "cpu"))
        np.testing.assert_allclose([float(m["loss"]), float(m["nll"])],
                                   [float(jm_["loss"]), float(jm_["nll"])], rtol=1e-5,
                                   err_msg=f"step {i}")
    close(jstate.params, tm, params)


def test_parameters_update_in_place():
    cfg = get("multitask_lm", smoke=True)
    model = TransformerLM(cfg, device="cpu", seed=2)
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, _ = train_loop(model, adamw(1e-3), iter(_pipe(cfg)), 3, multitask=_gmt(cfg))
    assert {n: p.data_ptr() for n, p in model.named_parameters()} == ptrs
    assert all(state.params[n] is p for n, p in model.named_parameters())
    assert all(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_train_then_serve():
    """A batcher built before training serves the trained weights: the same
    greedy tokens as a fresh engine on a copy of them, and as the JAX
    engine on them (converted back through params_to_numpy)."""
    cfg = get("multitask_lm", smoke=True)
    model = TransformerLM(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    tids = [0, 3, 7]
    early = ContinuousBatcher(model, num_slots=2, max_seq=32, prefill_chunk=4)
    train_loop(model, adamw(1e-2), iter(_pipe(cfg)), 5, multitask=_gmt(cfg))
    for uid, (p, t) in enumerate(zip(prompts, tids)):
        early.submit(Request(uid=uid, tokens=p, max_new=6, task_id=t))
    got = {r.uid: list(r.out) for r in early.run()}
    fresh = TransformerLM(cfg, device="cpu", seed=9)
    fresh.load_state_dict(model.state_dict())
    batch = {"tokens": prompts, "task_ids": np.array(tids, np.int32)}
    want = ServeEngine(fresh, max_seq=32, prefill_chunk=4).generate(batch, 6)
    assert [got[u] for u in range(3)] == [list(r) for r in want]
    untrained = ServeEngine(TransformerLM(cfg, device="cpu", seed=3), max_seq=32,
                            prefill_chunk=4).generate(batch, 6)
    assert not np.array_equal(untrained, want)  # training changed the model's answers
    jm = JaxLM(dataclasses.replace(jax_get("multitask_lm", smoke=True)))
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(model))
    jwant = JaxEngine(jm, jparams, max_seq=32, prefill_chunk=4).generate(batch, 6)
    np.testing.assert_array_equal(np.asarray(jwant), want)
