"""The port's Mamba2 layer (``repro_torch.models.mamba2``) and the Zamba2
hybrid stack built on it, against the JAX package's on the same inputs and
weights (numpy seeds; CPU, float32, JAX at matmul precision "highest").

Tolerances: the port against JAX on one layer, 1e-5 (the same f32 ops,
summed in other orders); the chunked SSD against the token-by-token
recurrence, 1e-4 (another association of the same sums: decays applied
as cumulative products inside a chunk); chunk sizes against each other,
1e-5; the hybrid's logits against JAX's, 1e-4 (two layers of f32 products
over d_model 256). What must hold exactly is exact: a row with no valid
token keeps its state bit for bit, a dead decode lane keeps its state bit
for bit, the state is written in place (same storage), and the weights
round-trip through ``params_to_numpy`` unchanged."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    load_numpy_params,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models.layers import freeze_dead_slots  # noqa: E402

D_MODEL, D_STATE, HD = 32, 8, 8
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _layer(seed=3):
    """(JAX params, port params) of one Mamba2 layer with non-trivial decay,
    dt bias and skip (the reference's init leaves them 0, 0 and 1)."""
    p = jmamba.init_mamba2(jax.random.PRNGKey(seed), D_MODEL, D_STATE, HD, jnp.float32)
    rng = np.random.default_rng(seed)
    nh = tmamba.dims(D_MODEL, D_STATE, HD)[1]
    p = dict(p, a_log=jnp.asarray(rng.uniform(-1, 0.5, nh), jnp.float32),
             dt_bias=jnp.asarray(rng.uniform(-2, 0, nh), jnp.float32),
             d_skip=jnp.asarray(rng.uniform(0.5, 1.5, nh), jnp.float32),
             norm_gain=jnp.asarray(rng.standard_normal(2 * D_MODEL) * 0.1, jnp.float32))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(b, s, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, D_MODEL)).astype(np.float32) * 0.5


def _state(b, seed=1):
    rng = np.random.default_rng(seed)
    _, nh, conv = tmamba.dims(D_MODEL, D_STATE, HD)
    return (rng.standard_normal((b, tmamba.CONV_K - 1, conv)).astype(np.float32),
            rng.standard_normal((b, nh, HD, D_STATE)).astype(np.float32) * 0.3)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# ----------------------------------------------------------- one layer
@pytest.mark.parametrize("threaded", [False, True])
def test_mamba2_full_matches_jax(threaded):
    """Chunked SSD over 24 tokens in chunks of 8, from a zero state or with
    a state threaded in and ragged valid prefixes (one row all invalid)."""
    jp, tp = _layer()
    x = _x(3, 24)
    kw = {}
    if threaded:
        st = _state(3)
        valid = np.arange(24)[None, :] < np.array([24, 11, 0])[:, None]
        jy, (jt, js) = jmamba.mamba2_full(jp, jnp.asarray(x), d_state=D_STATE, head_dim=HD,
                                          chunk=8, state=tuple(map(jnp.asarray, st)),
                                          valid=jnp.asarray(valid))
        kw = dict(state=_t(*st), valid=torch.from_numpy(valid))
    else:
        jy, (jt, js) = jmamba.mamba2_full(jp, jnp.asarray(x), d_state=D_STATE, head_dim=HD,
                                          chunk=8)
    ty, (tt, ts) = tmamba.mamba2_full(tp, torch.from_numpy(x), d_state=D_STATE, head_dim=HD,
                                      chunk=8, **kw)
    _close(jy, ty)
    _close(jt, tt)
    _close(js, ts)
    assert ts.dtype == torch.float32


def test_mamba2_step_matches_jax_and_freezes_dead_lanes_in_place():
    jp, tp = _layer()
    st = _state(3)
    live = np.array([True, False, True])
    x = _x(3, 1, seed=5)
    jy, (jt, js) = jmamba.mamba2_step(jp, jnp.asarray(x), tuple(map(jnp.asarray, st)),
                                      d_state=D_STATE, head_dim=HD, live=jnp.asarray(live))
    state = _t(*st)
    ptrs = [t.data_ptr() for t in state]
    ty, out = tmamba.mamba2_step(tp, torch.from_numpy(x), state, d_state=D_STATE, head_dim=HD,
                                 live=torch.from_numpy(live))
    assert out is state and [t.data_ptr() for t in out] == ptrs  # written in place
    _close(np.asarray(jy)[live], ty.numpy()[live])
    _close(jt, out[0])
    _close(js, out[1])
    for got, old in zip(out, st):  # the dead lane keeps its state bit for bit
        np.testing.assert_array_equal(got[1].numpy(), old[1])


def test_mamba2_full_matches_token_by_token_steps():
    """The chunked SSD (chunks of 8) == mamba2_step over the tokens, from a
    threaded-in state: outputs and final (conv_tail, ssm)."""
    _, tp = _layer()
    x = torch.from_numpy(_x(2, 24, seed=2))
    st = _state(2, seed=4)
    y_full, (tail_f, ssm_f) = tmamba.mamba2_full(tp, x, d_state=D_STATE, head_dim=HD,
                                                 chunk=8, state=_t(*st))
    state = _t(*st)
    ys = [tmamba.mamba2_step(tp, x[:, t:t + 1], state, d_state=D_STATE, head_dim=HD)[0]
          for t in range(24)]
    _close(y_full, torch.cat(ys, dim=1), 1e-4)
    _close(tail_f, state[0], 1e-4)
    _close(ssm_f, state[1], 1e-4)


def test_mamba2_chunk_size_invariance():
    """Chunks of 8, 16 and 32 over 32 tokens (and a length no chunk
    divides, which runs as one chunk) give the same outputs and states."""
    _, tp = _layer()
    x = torch.from_numpy(_x(1, 32, seed=6))
    runs = [tmamba.mamba2_full(tp, x, d_state=D_STATE, head_dim=HD, chunk=c)
            for c in (8, 16, 32, 12)]
    for y, (tail, ssm) in runs[1:]:
        _close(runs[0][0], y)
        _close(runs[0][1][0], tail)
        _close(runs[0][1][1], ssm)


def test_valid_prefix_threads_the_state_and_an_invalid_row_is_a_no_op():
    """A row's valid prefix of n tokens leaves the state that running those
    n tokens alone leaves (the conv tail taken at the last valid token), and
    a row with no valid token gets its state back bit for bit."""
    _, tp = _layer()
    x = torch.from_numpy(_x(3, 16, seed=8))
    st = _state(3, seed=9)
    n = [16, 5, 0]
    valid = torch.arange(16)[None, :] < torch.tensor(n)[:, None]
    _, (tail, ssm) = tmamba.mamba2_full(tp, x, d_state=D_STATE, head_dim=HD, chunk=8,
                                        state=_t(*st), valid=valid)
    one = tuple(t[1:2] for t in _t(*st))
    _, (tail1, ssm1) = tmamba.mamba2_full(tp, x[1:2, :5], d_state=D_STATE, head_dim=HD,
                                          chunk=8, state=one)
    _close(tail[1:2], tail1, 1e-6)
    _close(ssm[1:2], ssm1, 1e-5)
    np.testing.assert_array_equal(tail[2].numpy(), st[0][2])
    np.testing.assert_array_equal(ssm[2].numpy(), st[1][2])


def test_freeze_dead_slots_writes_into_the_old_storage():
    old = (torch.zeros(3, 2), torch.ones(3, 4, 2))
    new = (torch.full((3, 2), 5.0), torch.full((3, 4, 2), 7.0))
    ptrs = [t.data_ptr() for t in old]
    out = freeze_dead_slots(new, old, torch.tensor([True, False, True]))
    assert out is old and [t.data_ptr() for t in out] == ptrs
    assert out[0][[0, 2]].eq(5).all() and out[0][1].eq(0).all()
    assert out[1][[0, 2]].eq(7).all() and out[1][1].eq(1).all()
    freeze_dead_slots(new, old, None)
    assert out[0].eq(5).all() and out[1].eq(7).all()


# ------------------------------------------------------- the hybrid stack
# the smoke config (one ('mamba', 'shared_attn') period), and a deeper cut of
# the same widths whose 5 layers are one ('mamba', 'mamba', 'shared_attn')
# period plus a 2-layer mamba remainder: two stages, as Zamba2-7B's 81 layers
HYBRIDS = {
    "smoke": lambda c: c,
    "remainder": lambda c: dataclasses.replace(
        c, num_layers=5, pattern=("mamba", "mamba", "shared_attn")),
}


@functools.lru_cache(maxsize=None)
def _hybrid(name):
    jcfg = HYBRIDS[name](jax_get("zamba2_7b", smoke=True))
    tcfg = HYBRIDS[name](get("zamba2_7b", smoke=True))
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return jm, params, tree, load_numpy_params(TransformerLM(tcfg, device="cpu"), tree)


def test_zamba2_config_mirrors_jax_and_lays_out_81_layers():
    for smoke in (False, True):
        j, t = jax_get("zamba2_7b", smoke=smoke), get("zamba2_7b", smoke=smoke)
        for f in dataclasses.fields(t):
            if f.name != "attn_backend":
                assert getattr(t, f.name) == getattr(j, f.name), (smoke, f.name)
        assert (t.period, t.num_periods, t.remainder) == (j.period, j.num_periods, j.remainder)
    cfg = get("zamba2_7b")
    kinds = cfg.layer_kinds()
    assert (cfg.period, cfg.num_periods, cfg.remainder) == (6, 13, ("mamba",) * 3)
    assert len(kinds) == 81 and kinds.count("shared_attn") == 13
    assert [i for i, k in enumerate(kinds) if k == "shared_attn"] == list(range(5, 78, 6))


@pytest.mark.parametrize("name", list(HYBRIDS))
def test_hybrid_forward_logits_match_jax(name):
    jm, params, tree, tm = _hybrid(name)
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jm.forward(params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray([1, 3])})
    with torch.no_grad():
        tl, aux = tm.forward({"tokens": torch.from_numpy(toks),
                              "task_ids": torch.tensor([1, 3])})
    _close(jl, tl, 1e-4)
    assert float(aux) == 0.0


@pytest.mark.parametrize("name", list(HYBRIDS))
def test_hybrid_weights_map_layer_by_layer_and_round_trip(name):
    """stages/0/slot{j} of period i is layer period * i + j, stages/1/slot{j}
    the remainder's layer j; the one shared block comes from the top-level
    tree; params_to_numpy gives the JAX tree back exactly."""
    _, _, tree, tm = _hybrid(name)
    cfg = tm.cfg
    state = params_from_numpy(tree, cfg)
    assert set(state) == set(tm.state_dict())
    w = tree["stages"][0]["slot1"]["mamba"]["w_in"] if name == "remainder" else None
    if w is not None:  # period 0 of a 3-layer pattern: slot 1 is layer 1
        np.testing.assert_array_equal(state["layers.1.mamba.w_in"].numpy(), w[0])
        rem = tree["stages"][1]["slot1"]["norm"]["gain"][0]
        np.testing.assert_array_equal(state["layers.4.norm.gain"].numpy(), rem)
    np.testing.assert_array_equal(state["shared_attn.attn.wq"].numpy(),
                                  tree["shared_attn"]["attn"]["wq"])
    assert tm.layers[cfg.period - 1].state_dict() == {}  # a shared position owns nothing
    back = params_to_numpy(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a stage the layout does not have: the smoke config has one stage
    extra = {"stages": [{}, {"slot0": {"mamba": {"w": np.zeros((1, 2), np.float32)}}}]}
    with pytest.raises(ValueError, match="not a stage leaf"):
        params_from_numpy(extra, get("zamba2_7b", smoke=True))


def test_hybrid_prefill_and_decode_steps_match_jax():
    """A ragged prefill chunk (one row with no valid token) then decode
    ticks with a dead lane: logits of the live rows and every cache entry
    against JAX's; the all-invalid and dead rows keep their recurrent state
    bit for bit."""
    jm, params, _, tm = _hybrid("remainder")
    cfg = tm.cfg
    b, max_seq = 3, 48
    jc, tc = jm.init_cache(b, max_seq), tm.init_cache(b, max_seq)
    rng = np.random.default_rng(1)
    pos = np.array([0, 4, 9], np.int32)
    valid = np.arange(8)[None, :] < np.array([8, 3, 0])[:, None]
    toks = rng.integers(0, cfg.vocab_size, (b, 8)).astype(np.int32)
    frozen = [t[2].clone() for i, e in enumerate(tc) if tm.kinds[i] == "mamba" for t in e]
    jl, jc = jm.prefill_step(params, {"tokens": jnp.asarray(toks)}, jc, jnp.asarray(pos),
                             jnp.asarray(valid))
    tl, tc = tm.prefill_step({"tokens": torch.from_numpy(toks)}, tc, torch.from_numpy(pos),
                             torch.from_numpy(valid))
    _close(np.asarray(jl)[:2], tl[:2].numpy(), 1e-4)
    after = [t[2] for i, e in enumerate(tc) if tm.kinds[i] == "mamba" for t in e]
    assert all(torch.equal(a, f) for a, f in zip(after, frozen))
    pos = pos + valid.sum(1).astype(np.int32)
    live = np.array([True, False, True])
    for _ in range(3):
        frozen = [t[1].clone() for i, e in enumerate(tc) if tm.kinds[i] == "mamba" for t in e]
        t1 = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jc = jm.decode_step(params, {"tokens": jnp.asarray(t1)}, jc, jnp.asarray(pos),
                                live=jnp.asarray(live))
        tl, tc = tm.decode_step({"tokens": torch.from_numpy(t1)}, tc, torch.from_numpy(pos),
                                live=torch.from_numpy(live))
        _close(np.asarray(jl)[live], tl.numpy()[live], 1e-4)
        after = [t[1] for i, e in enumerate(tc) if tm.kinds[i] == "mamba" for t in e]
        assert all(torch.equal(a, f) for a, f in zip(after, frozen))
        pos = pos + live
    # every cache entry of the live rows, in layer order: JAX keeps (P, B, ...)
    # leaves per stage slot
    want = []
    for si, (first, per) in enumerate(((0, cfg.period), (cfg.num_periods * cfg.period, 0))):
        reps = cfg.num_periods if per else 1
        for i in range(reps):
            for j in range(cfg.period if per else len(cfg.remainder)):
                want.append((first + (per or 1) * i + j,
                             [np.asarray(t)[i] for t in jc[si][f"slot{j}"]]))
    for layer, leaves in want:
        for got, ref in zip(tc[layer], leaves):
            _close(ref[[0, 2]], got[[0, 2]].numpy(), 1e-4)
