"""The port's xLSTM blocks (``repro_torch.models.xlstm``: mLSTM, sLSTM)
against the JAX package's (``repro.models.xlstm``) on the same weights (the
JAX init, through numpy) and inputs (numpy seeds), CPU, float32, JAX at
matmul precision "highest". Stated tolerance: atol 2e-5, rtol 1e-5 on
values; the chunked (rematerialized) loop against the plain one as the
reference's own tests hold it (tests/test_blocks.py: values rtol 1e-5,
gradients 2e-4, sLSTM 1e-5).

What must hold exactly is exact: an invalid prefill token and a dead
decode lane leave the state bit for bit (from a fresh state too, whose
stabilizer -1e30 makes exp(-m) infinite: no NaN), the step writes the
state in place, the xLSTM weights stay float32 in a bfloat16 model, and
the cache starts (and is reset) at the reference's values."""
import dataclasses
import types

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
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

ATOL, RTOL = 2e-5, 1e-5
D, NH = 64, 2
KINDS = ("mlstm", "slstm")


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _params(kind, seed=0, d=D, nh=NH):
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    jp = init(jax.random.PRNGKey(seed), d, nh)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _fns(kind):
    if kind == "mlstm":
        return jx.mlstm_full, tx.mlstm_full, jx.mlstm_step, tx.mlstm_step
    return jx.slstm_full, tx.slstm_full, jx.slstm_step, tx.slstm_step


def _state(kind, rng, b, d=D, nh=NH):
    """A state reached by running the block over a random prefix (so m is
    finite and the memory is nonzero), as numpy arrays."""
    jp, _ = _params(kind, seed=7, d=d, nh=nh)
    x = rng.standard_normal((b, 5, d)).astype(np.float32) * 0.5
    _, st = _fns(kind)[0](jp, jnp.asarray(x), n_heads=nh)
    return [np.array(t) for t in st]


def _close(want, got):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fresh", [True, False])
def test_full_matches_jax_with_state_and_valid(kind, fresh):
    """The block over a ragged batch (rows of 12, 5 and 0 valid tokens),
    from a fresh state or a threaded one: the outputs of the valid tokens
    and the final states."""
    jfull, tfull, _, _ = _fns(kind)
    jp, tp = _params(kind)
    rng = np.random.default_rng(1)
    b, t = 3, 12
    x = rng.standard_normal((b, t, D)).astype(np.float32) * 0.5
    valid = np.arange(t)[None, :] < np.array([12, 5, 0])[:, None]
    st = None if fresh else _state(kind, rng, b)
    jy, js = jfull(jp, jnp.asarray(x), n_heads=NH, valid=jnp.asarray(valid),
                   state=None if st is None else tuple(map(jnp.asarray, st)))
    ty, ts = tfull(tp, torch.from_numpy(x), n_heads=NH, valid=torch.from_numpy(valid),
                   state=None if st is None else tuple(map(torch.from_numpy, st)))
    assert torch.isfinite(ty).all()
    _close(np.asarray(jy)[valid], ty[torch.from_numpy(valid)])
    for want, got in zip(js, ts):
        _close(want, got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fresh", [True, False])
def test_invalid_tokens_are_exact_noops(kind, fresh):
    """A row with no valid token ends with its state bit for bit, from a
    fresh state (mLSTM's m at -1e30: logsigmoid(+inf), exp(-inf) and the
    infinite exp(-m) give exact zeros and ones, never a NaN) and from a
    used one; the other rows are unaffected by it."""
    _, tfull, _, _ = _fns(kind)
    _, tp = _params(kind)
    rng = np.random.default_rng(2)
    b, t = 2, 6
    x = torch.from_numpy(rng.standard_normal((b, t, D)).astype(np.float32))
    if fresh:
        st = tx.mlstm_init_state(b, NH, 2 * D // NH) if kind == "mlstm" else \
            tx.slstm_init_state(b, NH, D // NH)
    else:
        st = tuple(map(torch.from_numpy, _state(kind, rng, b)))
    valid = torch.tensor([[True] * t, [False] * t])
    y, new = tfull(tp, x, n_heads=NH, valid=valid, state=st)
    assert torch.isfinite(y).all()
    for old, nt in zip(st, new):
        assert torch.equal(nt[1], old[1])
        assert torch.isfinite(nt).all()
    y0, new0 = tfull(tp, x[:1], n_heads=NH, state=tuple(s[:1] for s in st))
    np.testing.assert_allclose(y[:1].numpy(), y0.numpy(), atol=ATOL, rtol=RTOL)
    for a, b_ in zip(new, new0):
        np.testing.assert_allclose(a[:1].numpy(), b_.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_step_matches_jax_in_place_and_freezes_dead_lanes(kind):
    """Three decode steps with lane 1 dead: the live lanes' outputs and
    states against JAX's; lane 1's state bit for bit; the state tensors are
    the ones passed in (written in place)."""
    _, _, jstep, tstep = _fns(kind)
    jp, tp = _params(kind)
    rng = np.random.default_rng(3)
    b = 3
    st = _state(kind, rng, b)
    js = tuple(map(jnp.asarray, st))
    ts = tuple(torch.from_numpy(s.copy()) for s in st)
    ptrs = [t.data_ptr() for t in ts]
    live = np.array([True, False, True])
    for _ in range(3):
        x = rng.standard_normal((b, 1, D)).astype(np.float32)
        jy, js = jstep(jp, jnp.asarray(x), js, n_heads=NH, live=jnp.asarray(live))
        ty, out = tstep(tp, torch.from_numpy(x), ts, n_heads=NH, live=torch.from_numpy(live))
        assert out is ts and [t.data_ptr() for t in ts] == ptrs
        _close(np.asarray(jy)[live], ty[torch.from_numpy(live)])
    for want, got, first in zip(js, ts, st):
        _close(want, got)
        assert np.array_equal(got[1].numpy(), first[1])


def test_mlstm_chunk_matches_plain_values_and_grads():
    """``xlstm_chunk`` is a remat boundary: chunk 8 over T = 32 gives chunk
    0's loss and gradients (tests/test_blocks.py:116 on the port)."""
    _, tp = _params("mlstm", seed=5, d=32)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32)).astype(np.float32) * 0.3)

    def loss_and_grads(chunk):
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        y, _ = tx.mlstm_full(p, x, n_heads=2, chunk=chunk)
        loss = (y * y).sum()
        loss.backward()
        return float(loss.detach()), [p[k].grad for k in sorted(p)]

    v0, g0 = loss_and_grads(0)
    v1, g1 = loss_and_grads(8)
    np.testing.assert_allclose(v1, v0, rtol=1e-5)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-4)


def test_slstm_chunk_matches_plain_and_jax():
    """tests/test_blocks.py:137 on the port: sLSTM at chunk 8 over T = 24
    equals chunk 0, and both equal JAX's."""
    jp, tp = _params("slstm", seed=6, d=16)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32) * 0.3
    y0, _ = tx.slstm_full(tp, torch.from_numpy(x), n_heads=2, chunk=0)
    y1, _ = tx.slstm_full(tp, torch.from_numpy(x), n_heads=2, chunk=8)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), atol=1e-5)
    jy, _ = jx.slstm_full(jp, jnp.asarray(x), n_heads=2, chunk=8)
    _close(jy, y1)


def test_model_chunk_changes_no_value_and_trains():
    """At the model level, ``xlstm_chunk`` 4 over 16 tokens: the same loss
    and the same gradients as chunk 0, with and without layer remat."""
    base = get("xlstm_350m", smoke=True)
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (2, 17)).astype(np.int64))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = []
    for chunk, remat in ((0, False), (4, False), (4, True)):
        model = TransformerLM(dataclasses.replace(base, xlstm_chunk=chunk, remat=remat),
                              device="cpu", seed=0)
        loss, _ = model.loss_fn(batch)
        loss.backward()
        # the task tables take no gradient without task ids
        runs.append((float(loss.detach()), [p.grad.clone() for p in model.parameters()
                                   if p.grad is not None]))
    assert len(runs[0][1]) == 3 + (1 + 7) + (1 + 4)  # embed, head, final norm; two blocks
    for loss, grads in runs[1:]:
        np.testing.assert_allclose(loss, runs[0][0], rtol=1e-6)
        for a, b in zip(grads, runs[0][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-6)


def test_block_weights_stay_float32_in_a_bfloat16_model():
    """The reference's init_mlstm / init_slstm take no dtype: in a bf16
    model the mixers' weights are float32 and only the block norms (and the
    embedding, head, final norm) follow the model; the bf16 forward is
    finite."""
    jm = JaxLM(jax_get("xlstm_350m", smoke=True), dtype=jnp.bfloat16)
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    model = TransformerLM(get("xlstm_350m", smoke=True), device="cpu", dtype=torch.bfloat16)
    stage = jparams["stages"][0]
    for j, kind in enumerate(model.kinds):
        mixer = getattr(model.layers[j], kind)
        for name, p in mixer.items():
            assert p.dtype == torch.float32 == getattr(torch, str(stage[f"slot{j}"][kind][name]
                                                                  .dtype)), (kind, name)
        assert model.layers[j].norm["gain"].dtype == torch.bfloat16
    assert model.embed.dtype == torch.bfloat16
    with torch.no_grad():
        logits, _ = model.forward({"tokens": torch.ones((1, 6), dtype=torch.long)})
    assert torch.isfinite(logits).all()


def test_cache_starts_and_resets_at_the_reference_values():
    """mLSTM (C, n, m) with m at -1e30, sLSTM (c, n, h, m) zeros, all
    float32, at the head widths of the reference (mLSTM: 2 * d_model /
    heads, 512 at full width; sLSTM: d_model / heads); a reset restores the
    reset rows of every entry to JAX's reset value and leaves the others."""
    jm = JaxLM(jax_get("xlstm_350m", smoke=True))
    tm = TransformerLM(get("xlstm_350m", smoke=True), device="cpu")
    reset = np.array([False, True, True])
    jc = jax.tree.map(jnp.ones_like, jm.init_cache(3, 8))
    jc = jm.reset_slot_state(jc, jnp.asarray(reset), 8)
    fresh = tm.init_cache(3, 8)
    assert [t.dtype for e in fresh for t in e] == [torch.float32] * 7
    assert fresh[0][2].eq(-1e30).all() and not any(t.any() for t in fresh[0][:2])
    tc = tm.init_cache(3, 8)
    for entry in tc:
        for t in entry:
            t.fill_(1.0)
    assert tm.reset_slot_state(tc, reset) is tc
    for layer, slot in ((0, "slot0"), (1, "slot1")):
        for got, want in zip(tc[layer], jc[0][slot]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    full = types.SimpleNamespace(cfg=get("xlstm_350m"), dtype=torch.float32)
    shapes = [s for s, _, _ in TransformerLM._cache_spec(full, "mlstm", 4, 1)]
    assert shapes == [(4, 4, 512, 512), (4, 4, 512), (4, 4)]
    shapes = [s for s, _, _ in TransformerLM._cache_spec(full, "slstm", 4, 1)]
    assert shapes == [(4, 4, 256)] * 3 + [(4, 4)]

