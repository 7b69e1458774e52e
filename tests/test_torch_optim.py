"""Parity of the port's optimizers (repro_torch.optim) with the JAX
package's (repro.optim), leafwise over 5 steps on the same numpy params
and gradients, CPU: sgd with momentum 0 and 0.9, adamw with weight decay
under a cosine schedule, bf16 parameters with float32 AdamW moments; and
cosine_schedule itself. Updates write into the parameters in place."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule, sgd  # noqa: E402

SHAPES = {"embed": (7, 5), "layer": {"w": (5, 3), "b": (3,)}, "task": {"bias": (4, 6)}}
STEPS = 5


def _tree(rng, scale=1.0):
    return tree_lib.map_(lambda shape: (rng.standard_normal(shape) * scale).astype(np.float32),
                         SHAPES, )


def _run(make_jax, make_torch, dtype=np.float32, tdtype=torch.float32):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(STEPS)]
    jopt, topt = make_jax(), make_torch()
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p0)
    tp = tree_lib.map_(lambda a: torch.from_numpy(a).to(tdtype), p0)
    ptrs = [t.data_ptr() for t in tree_lib.leaves(tp)]
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(STEPS):
        jg = jax.tree.map(lambda a: jnp.asarray(a, dtype), grads[step])
        tg = tree_lib.map_(lambda a: torch.from_numpy(a).to(tdtype), grads[step])
        jp, js = jopt.update(jg, js, jp, step)
        tp, ts = topt.update(tg, ts, tp, step)
    assert [t.data_ptr() for t in tree_lib.leaves(tp)] == ptrs  # written in place
    return jp, js, tp, ts


def _close(j, t, atol, rtol):
    for jl, tl in zip(jax.tree.leaves(j), tree_lib.leaves(t)):
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    jp, js, tp, ts = _run(lambda: jax_sgd(0.05, momentum), lambda: sgd(0.05, momentum))
    _close(jp, tp, 1e-6, 1e-6)
    if momentum:
        _close(js, ts, 1e-6, 1e-6)
    else:
        assert ts == ()


def test_adamw_with_weight_decay_under_cosine_schedule_matches_jax():
    jp, js, tp, ts = _run(
        lambda: jax_adamw(jax_cosine(1e-2, warmup=2, total=STEPS), weight_decay=0.1),
        lambda: adamw(cosine_schedule(1e-2, warmup=2, total=STEPS), weight_decay=0.1))
    _close(jp, tp, 1e-6, 1e-5)
    _close(js.mu, ts.mu, 1e-7, 1e-6)
    _close(js.nu, ts.nu, 1e-9, 1e-6)


def test_adamw_bf16_params_keep_float32_moments():
    jp, js, tp, ts = _run(lambda: jax_adamw(1e-2, weight_decay=0.1),
                          lambda: adamw(1e-2, weight_decay=0.1),
                          dtype=jnp.bfloat16, tdtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tree_lib.leaves(tp))
    assert all(t.dtype == torch.float32 for t in tree_lib.leaves(ts.mu) + tree_lib.leaves(ts.nu))
    _close(jp, tp, 0, 8e-3)  # one bf16 ulp
    _close(js.mu, ts.mu, 1e-7, 1e-5)
    _close(js.nu, ts.nu, 1e-9, 1e-5)


def test_sgd_bf16_matches_jax():
    jp, _, tp, _ = _run(lambda: jax_sgd(0.05, 0.9), lambda: sgd(0.05, 0.9),
                        dtype=jnp.bfloat16, tdtype=torch.bfloat16)
    _close(jp, tp, 0, 8e-3)


def test_cosine_schedule_matches_jax():
    jlr, tlr = jax_cosine(3e-4, warmup=10, total=100), cosine_schedule(3e-4, warmup=10, total=100)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        np.testing.assert_allclose(tlr(step), float(jlr(step)), rtol=1e-6, atol=0)
    assert tlr(0) == 0.0 and isinstance(tlr(3), float)
