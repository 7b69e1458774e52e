"""Parity of the port's building blocks (repro_torch.models.layers) with the
JAX package's (repro.models.layers): the same seeded numpy inputs through
both, on the CPU in float32, atol 1e-5."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5


def _pair(rng, *shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


def test_matmul_accumulates_like_jax():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, 2, 5, 64)
    wj, wt = _pair(rng, 64, 48, scale=0.1)
    _close(jl.matmul(xj, wj), tl.matmul(xt, wt))
    assert tl.matmul(xt, wt).dtype == torch.float32


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm(kind):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, 3, 4, 96, scale=2.0)
    xj, xt = xj + 0.5, xt + 0.5  # nonzero mean: the layernorms subtract it
    params_j, params_t = {}, {}
    if kind == "rmsnorm":
        gj, gt = _pair(rng, 96, scale=0.1)
        params_j, params_t = {"gain": gj}, {"gain": gt}
    elif kind == "layernorm":
        gj, gt = _pair(rng, 96)
        bj, bt = _pair(rng, 96)
        params_j, params_t = {"gain": gj, "bias": bj}, {"gain": gt, "bias": bt}
    _close(jl.apply_norm(kind, xj, params_j or None), tl.apply_norm(kind, xt, params_t or None))


def test_init_norm_matches_jax_layout():
    for kind in ("rmsnorm", "layernorm", "nonparam_ln"):
        j = jl.init_norm(kind, 8, jnp.float32)
        t = tl.init_norm(kind, 8, torch.float32, "cpu")
        assert set(j) == set(t)
        for k in j:
            _close(j[k], t[k], atol=0)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_ragged_positions(theta):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, 3, 5, 4, 64)
    pos = (np.array([0, 37, 900])[:, None] + np.arange(5)[None, :]).astype(np.int32)
    _close(
        jl.apply_rope(xj, jnp.asarray(pos), theta),
        tl.apply_rope(xt, torch.from_numpy(pos), theta),
    )


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_mlp(kind):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, 2, 3, 32)
    names = ("wg", "wi", "wo") if kind == "swiglu" else ("wi", "wo")
    pj, pt = {}, {}
    for n in names:
        shape = (64, 32) if n == "wo" else (32, 64)
        pj[n], pt[n] = _pair(rng, *shape, scale=0.2)
    _close(jl.apply_mlp(pj, xj, kind), tl.apply_mlp(pt, xt, kind))


def test_dense_init_law_and_seed():
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = tl.dense_init((256, 512), g1)
    b = tl.dense_init((256, 512), g2)
    assert torch.equal(a, b)
    # normal * 1/sqrt(fan_in), fan_in = shape[in_axis]
    assert abs(a.std().item() - 256 ** -0.5) < 2e-3
    c = tl.dense_init((64, 1024), torch.Generator().manual_seed(0), in_axis=1)
    assert abs(c.std().item() - 1024 ** -0.5) < 2e-3
    assert tl.dense_init((4, 4), g1, dtype=torch.bfloat16).dtype == torch.bfloat16
