"""Parity of the port's mixture of experts (repro_torch.models.moe.apply_moe)
with the JAX package's (repro.models.moe.apply_moe), CPU, JAX at matmul
precision "highest", the same weights and inputs from numpy seeds: outputs
(float32 atol 2e-6; bfloat16 atol 2e-2, its one-ulp flips of the f32 sums
cast back) and the load-balance aux (rtol 1e-6) over dispatch groups 1, 2
and 4, shared experts 0 and 1, binding (0.5) and dropless capacity, a
router bias, dropless capacity against a per-token reference (the port of
tests/test_blocks.py's), the live mask (dead lanes take no capacity and cannot move a
live token, the port of tests/test_serve_batching.py::
test_moe_dead_slots_do_not_steal_capacity_or_flip_routing), and a NaN in a
dead lane. The inputs are float32 normal draws, where tied router
probabilities, whose top-k order may differ between torch and JAX, do not
occur."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.convert import _tensor  # noqa: E402
from repro_torch.models.moe import apply_moe, init_moe  # noqa: E402

D, FF, E, K = 64, 96, 4, 2
ATOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _params(shared, dtype=jnp.float32):
    p = jax_moe.init_moe(jax.random.PRNGKey(shared), D, FF, E, shared, dtype)

    def tt(t):
        return {k: tt(v) if isinstance(v, dict) else _tensor(np.asarray(v)) for k, v in t.items()}

    return p, tt(p)


def _run(p, pt, x, **kw):
    """Both packages on the same inputs: ((out, aux) JAX, (out, aux) port),
    as float32 numpy."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    static = {k: v for k, v in jkw.items() if not isinstance(v, jax.Array)}
    arrays = {k: v for k, v in jkw.items() if isinstance(v, jax.Array)}
    fn = jax.jit(lambda p, x, a: jax_moe.apply_moe(p, x, top_k=K, **static, **a))
    with jax.default_matmul_precision("highest"):
        jo, ja = fn(p, jnp.asarray(x, p["wg"].dtype), arrays)
    to, ta = apply_moe(pt, _tensor(np.asarray(jnp.asarray(x, p["wg"].dtype))), top_k=K, **tkw)
    return ((np.asarray(jo.astype(jnp.float32)), float(ja)),
            (to.float().numpy(), float(ta)))


@pytest.mark.parametrize("capacity", [0.5, float(E)])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_apply_moe_matches_jax(groups, shared, capacity):
    p, pt = _params(shared)
    rng = np.random.default_rng(groups * 10 + shared)
    x = rng.standard_normal((4, 6, D)).astype(np.float32)
    (jo, ja), (to, ta) = _run(p, pt, x, capacity_factor=capacity, groups=groups)
    np.testing.assert_allclose(to, jo, atol=ATOL["float32"], rtol=0)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    assert ta > 0


def _per_token_reference(pt, x, top_k):
    """Every token through its top-k experts one at a time, no capacity (the
    port of tests/test_blocks.py's dense reference), in torch."""
    xf = torch.from_numpy(x).reshape(-1, D)
    probs = torch.softmax(xf @ pt["router"], dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(top_k):
            ei = int(idx[t, j])
            h = torch.nn.functional.silu(xf[t] @ pt["wg"][ei]) * (xf[t] @ pt["wi"][ei])
            out[t] += gate[t, j] * (h @ pt["wo"][ei])
    if "shared" in pt:
        s = pt["shared"]
        out += (torch.nn.functional.silu(xf @ s["wg"]) * (xf @ s["wi"])) @ s["wo"]
    return out.reshape(x.shape).numpy()


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_dropless_equals_per_token_reference(groups, shared):
    """Dropless capacity: the sort-based dispatch equals every token running
    its top-k experts exactly (atol 2e-5)."""
    p, pt = _params(shared)
    x = np.random.default_rng(20 + groups).standard_normal((2, 8, D)).astype(np.float32)
    (_, _), (got, aux) = _run(p, pt, x, capacity_factor=float(E), groups=groups)
    np.testing.assert_allclose(got, _per_token_reference(pt, x, K), atol=2e-5, rtol=0)
    assert aux > 0


def test_binding_capacity_drops_tokens():
    """At capacity 0.5 some assignments are dropped: the output differs from
    the dropless one, in both packages alike (held above)."""
    p, pt = _params(0)
    x = np.random.default_rng(7).standard_normal((2, 8, D)).astype(np.float32)
    (_, _), (tight, _) = _run(p, pt, x, capacity_factor=0.5)
    (_, _), (dropless, _) = _run(p, pt, x, capacity_factor=float(E))
    assert np.abs(tight - dropless).max() > 1e-3
    assert (np.abs(tight).sum(-1) == 0).any()  # a token lost both its experts


@pytest.mark.parametrize("groups", [1, 2])
def test_router_bias_matches_jax(groups):
    p, pt = _params(1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    bias = (rng.standard_normal((2, 5, E)) * 2).astype(np.float32)
    (jo, ja), (to, ta) = _run(p, pt, x, router_bias=bias, groups=groups, capacity_factor=1.0)
    np.testing.assert_allclose(to, jo, atol=ATOL["float32"], rtol=0)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    (_, _), (unbiased, _) = _run(p, pt, x, groups=groups, capacity_factor=1.0)
    assert np.abs(to - unbiased).max() > 1e-3  # the bias moved the routing


@pytest.mark.parametrize("live_ndim", [1, 2])
def test_live_mask_matches_jax(live_ndim):
    p, pt = _params(0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, D)).astype(np.float32)
    live = np.array([True, False, True, False])
    if live_ndim == 2:  # a (B, C) valid mask of left-packed prompt rows
        live = np.array([[1, 1, 0], [0, 0, 0], [1, 1, 1], [1, 0, 0]], bool)
    (jo, ja), (to, ta) = _run(p, pt, x, live=live, capacity_factor=1.0)
    np.testing.assert_allclose(to, jo, atol=ATOL["float32"], rtol=0)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    dead = ~np.broadcast_to(live if live.ndim == 2 else live[:, None], (4, 3))
    assert (to[dead] == 0).all()  # dead rows come out zero (no shared experts)


def test_moe_dead_slots_do_not_steal_capacity_or_flip_routing():
    """Under binding capacity, what the dead lanes hold must not change any
    live lane's output: live rows equal a run where the dead lanes hold other
    content (port of the reference's serving test)."""
    p, pt = _params(0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 1, D)).astype(np.float32)
    live = np.array([True, False, True, False, False, True])
    (_, _), (a, _) = _run(p, pt, x, live=live, capacity_factor=0.5)
    x2 = x.copy()
    x2[~live] = rng.standard_normal(x2[~live].shape).astype(np.float32) * 10
    (jb, _), (b, _) = _run(p, pt, x2, live=live, capacity_factor=0.5)
    np.testing.assert_array_equal(a[live], b[live])
    np.testing.assert_allclose(b, jb, atol=ATOL["float32"], rtol=0)
    # without the mask the dead lanes compete for capacity: some live row moves
    (_, _), (c, _) = _run(p, pt, x2, capacity_factor=0.5)
    assert np.abs(c[live] - a[live]).max() > 1e-3


def test_nan_in_a_dead_lane_stays_out_of_live_rows():
    p, pt = _params(1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 1, D)).astype(np.float32)
    live = np.array([True, True, False, True])
    (_, _), (clean, _) = _run(p, pt, x, live=live, capacity_factor=0.5)
    x[2] = np.nan
    (jo, _), (to, _) = _run(p, pt, x, live=live, capacity_factor=0.5)
    assert np.isfinite(to[live]).all()
    np.testing.assert_array_equal(to[live], clean[live])
    np.testing.assert_allclose(to[live], jo[live], atol=ATOL["float32"], rtol=0)


def test_apply_moe_bfloat16_matches_jax():
    p, pt = _params(1, jnp.bfloat16)
    assert pt["router"].dtype == torch.float32 and pt["wg"].dtype == torch.bfloat16
    x = np.random.default_rng(8).standard_normal((3, 5, D)).astype(np.float32)
    live = np.array([True, True, False])
    (jo, ja), (to, ta) = _run(p, pt, x, live=live, capacity_factor=1.0)
    np.testing.assert_allclose(to, jo, atol=ATOL["bfloat16"], rtol=0)
    np.testing.assert_allclose(ta, ja, rtol=1e-5)
    assert (to == jo).mean() > 0.95  # most entries agree to the bit


def test_init_moe_layout_matches_jax():
    gen = torch.Generator().manual_seed(0)
    got = init_moe(D, FF, E, 1, torch.bfloat16, gen)
    want, _ = _params(1, jnp.bfloat16)
    for k in ("router", "wg", "wi", "wo"):
        assert tuple(got[k].shape) == want[k].shape, k
    assert got["router"].dtype == torch.float32 and got["wo"].dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in got["shared"].items()} == {
        k: v.shape for k, v in want["shared"].items()}
    assert "shared" not in init_moe(D, FF, E, 0, torch.float32, gen)
