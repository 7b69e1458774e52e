"""The port's chunkwise-parallel mLSTM (``repro_torch.models.xlstm.
mlstm_chunkwise``, the training forward's mLSTM under
``cfg.xlstm_parallel``) against the port's sequential cell and the JAX
package's ``mlstm_chunkwise``, on the same weights (the JAX init, through
numpy) and inputs (numpy seeds), CPU, float32, JAX at matmul precision
"highest". Stated tolerances, the reference's own (tests/test_blocks.py):
values and boundary states within atol 2e-5 for chunks of 8, 16 and 48 over
48 tokens; gradients within rtol 1e-3, atol 1e-4. From a carried state and
under a prefill mask it is JAX's chunkwise within atol 2e-5, rtol 1e-5. At
the model level the flag's logits are JAX's within atol 2e-5 (the blocks'
tolerance, through two layers) and its loss within rtol 1e-5, and
serving keeps the sequential cell whatever the flag says (the reference's
prefill does): the flag changes no served logit."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _params(seed, d, nh):
    jp = jx.init_mlstm(jax.random.PRNGKey(seed), d, nh)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_chunkwise_matches_the_sequential_cell_and_jax(chunk):
    """tests/test_blocks.py::test_mlstm_chunkwise_parallel_matches_sequential
    on the port: values and boundary states against the port's cell, and
    against JAX's chunkwise at the same chunk."""
    rng = np.random.default_rng(8)
    d, nh = 32, 2
    jp, tp = _params(8, d, nh)
    x = rng.standard_normal((2, 48, d)).astype(np.float32) * 0.4
    y0, st0 = tx.mlstm_full(tp, torch.from_numpy(x), n_heads=nh)
    y1, st1 = tx.mlstm_chunkwise(tp, torch.from_numpy(x), n_heads=nh, chunk=chunk)
    jy, jst = jx.mlstm_chunkwise(jp, jnp.asarray(x), n_heads=nh, chunk=chunk)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    for a, b, c in zip(st1, st0, jst):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL, rtol=0)


def test_chunkwise_from_a_state_under_a_mask_matches_jax():
    """A carried (C, n, m) and a contiguous-prefix ``valid`` mask (invalid
    tokens exact no-ops), over a T the chunk does not divide (one chunk):
    JAX's chunkwise, and the port's cell."""
    rng = np.random.default_rng(3)
    d, nh = 32, 4
    jp, tp = _params(3, d, nh)
    _, st = jx.mlstm_full(jp, jnp.asarray(rng.standard_normal((2, 5, d)).astype(np.float32)),
                          n_heads=nh)
    st_np = [np.asarray(t) for t in st]
    x = rng.standard_normal((2, 12, d)).astype(np.float32) * 0.5
    valid = np.ones((2, 12), bool)
    valid[1, 7:] = False
    for chunk in (4, 5):
        jy, jst = jx.mlstm_chunkwise(jp, jnp.asarray(x), n_heads=nh, chunk=chunk,
                                     state=tuple(map(jnp.asarray, st_np)),
                                     valid=jnp.asarray(valid))
        ty, tst = tx.mlstm_chunkwise(tp, torch.from_numpy(x), n_heads=nh, chunk=chunk,
                                     state=tuple(map(torch.from_numpy, st_np)),
                                     valid=torch.from_numpy(valid))
        sy, sst = tx.mlstm_full(tp, torch.from_numpy(x), n_heads=nh,
                                state=tuple(map(torch.from_numpy, st_np)),
                                valid=torch.from_numpy(valid))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=1e-5)
        np.testing.assert_allclose(ty[:, :7].numpy(), sy[:, :7].numpy(), atol=ATOL, rtol=1e-5)
        for a, b, c in zip(tst, jst, sst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=1e-5)
            np.testing.assert_allclose(a.numpy(), c.numpy(), atol=ATOL, rtol=1e-5)


def test_chunkwise_grads_match_the_sequential_cell_and_jax():
    """tests/test_blocks.py::test_mlstm_chunkwise_grads_match on the port:
    torch autograd through the chunkwise form against the cell's, and
    against jax.grad of JAX's chunkwise, rtol 1e-3 / atol 1e-4."""
    rng = np.random.default_rng(9)
    d, nh = 16, 2
    jp, _ = _params(9, d, nh)
    x = rng.standard_normal((1, 16, d)).astype(np.float32) * 0.3

    def grads(fn, **kw):
        tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jp.items()}
        y, _ = fn(tp, torch.from_numpy(x), n_heads=nh, **kw)
        (y * y).sum().backward()
        return {k: t.grad.numpy() for k, t in tp.items()}

    g0 = grads(tx.mlstm_full)
    g1 = grads(tx.mlstm_chunkwise, chunk=8)
    jg = jax.grad(lambda p: jnp.sum(jx.mlstm_chunkwise(p, jnp.asarray(x), n_heads=nh,
                                                       chunk=8)[0] ** 2))(jp)
    for k in jp:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(g1[k], np.asarray(jg[k]), rtol=1e-3, atol=1e-4)


def _pair(**overrides):
    cfg_j = dataclasses.replace(jax_get("xlstm_350m", smoke=True), **overrides)
    jm = JaxLM(cfg_j)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get("xlstm_350m", smoke=True), **overrides)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def test_model_forward_under_the_flag_matches_jax_and_trains():
    """``xlstm_parallel=True`` (chunk xlstm_chunk or 64; here 8 over 24
    tokens): logits equal JAX's forward under the same flag and the
    sequential forward's within 2e-5, the loss JAX's within rtol 1e-5; the backward
    gives finite gradients to every mLSTM weight."""
    jm, params, tm = _pair(xlstm_parallel=True, xlstm_chunk=8)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "task_ids": np.array([0, 1], np.int32)}
    jl, _ = jax.jit(jm.forward)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    jloss, _ = jax.jit(jm.loss_fn)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = tm.loss_fn(tb)
    loss.backward()
    with torch.no_grad():
        tl, _ = tm.forward(tb)
        tm.cfg = dataclasses.replace(tm.cfg, xlstm_parallel=False)
        sl, _ = tm.forward(tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), sl.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = [p.grad for n, p in tm.named_parameters() if ".mlstm." in n]
    assert grads and all(g is not None and torch.isfinite(g).all() for g in grads)


def test_serving_keeps_the_sequential_cell_under_the_flag():
    """The reference's prefill runs the sequential cell whatever
    ``xlstm_parallel`` says (tests/test_serve_prefill.py), and so do the
    port's steps: a prefill chunk and a decode step give bit-identical
    logits and states with the flag on and off."""
    from repro_torch.serve.step import make_serve_step

    _, _, tm = _pair()
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 8)).astype(np.int64))
    runs = []
    for flag in (False, True):
        tm.cfg = dataclasses.replace(tm.cfg, xlstm_parallel=flag)
        decode, prefill = make_serve_step(tm)
        caches = tm.init_cache(2, 16)
        last, caches, pos = prefill(toks, torch.zeros(2, dtype=torch.long), caches,
                                    torch.zeros(2, dtype=torch.int32),
                                    torch.ones((2, 8), dtype=torch.bool), np.ones(2, bool))
        nxt, logits, caches = decode(last.argmax(-1), torch.zeros(2, dtype=torch.long), caches,
                                     pos, torch.ones(2, dtype=torch.bool))
        runs.append((last, logits, [t.clone() for e in caches for t in e]))
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
