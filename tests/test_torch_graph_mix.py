"""The port's graph-mixing ops (repro_torch.kernels.graph_mix) against the
JAX package's Pallas kernel, run in interpret mode as tests/test_kernels.py
runs it on the CPU: ``graph_mix`` for m in {4, 16, 32, 100} and d in {128,
512, 1000}, float32 (atol = rtol = 1e-5) and bfloat16 (3e-2, one bf16
rounding of either side's f32 sum), and under every mixing family of the
task graph; ``graph_mix_tree`` against the JAX tree op on a mixed-dtype
tree with one ``graph_mix`` call per dtype group, and its refusal of a leaf
that is not task-leading. On the CPU the port runs the plain version."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.kernels.graph_mix import graph_mix_tree as jax_graph_mix_tree  # noqa: E402
from repro.kernels.graph_mix.kernel import graph_mix_pallas  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.kernels.graph_mix import ops  # noqa: E402
from repro_torch.kernels.graph_mix import (  # noqa: E402
    graph_mix,
    graph_mix_reference,
    graph_mix_tree,
    graph_mix_tree_reference,
)

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _check(got: torch.Tensor, want, dtype: str):
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 512, 1000])
@pytest.mark.parametrize("m", [4, 16, 32, 100])
def test_graph_mix_matches_pallas(m, d, dtype):
    rng = np.random.default_rng(m * 1000 + d)
    mu = jnp.asarray(rng.standard_normal((m, m)), jnp.float32)
    theta = jnp.asarray(rng.standard_normal((m, d))).astype(dtype)
    want = graph_mix_pallas(mu, theta, interpret=True)
    got = graph_mix(_to_torch(mu), _to_torch(theta))
    _check(got, want, dtype)


def _families(m=12):
    g, tg = jgraph.band_graph(m, 2), graph.band_graph(m, 2)
    c, tc = jgraph.complete_graph(m), graph.complete_graph(m)
    return [
        ("bsr", g.bsr_mixing(1.0, 1.0, 1.0), tg.bsr_mixing(1.0, 1.0, 1.0)),
        ("bol", g.bol_mixing(0.5, 2.0, 0.05), tg.bol_mixing(0.5, 2.0, 0.05)),
        ("consensus", g.consensus_mixing(), tg.consensus_mixing()),
        ("consensus_complete", c.consensus_mixing(), tc.consensus_mixing()),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx", range(4))
def test_graph_mix_mixing_families(idx, dtype):
    _, jmu, tmu = _families()[idx]
    rng = np.random.default_rng(idx)
    theta = jnp.asarray(rng.standard_normal((12, 300))).astype(dtype)
    want = graph_mix_pallas(jnp.asarray(jmu, jnp.float32), theta, interpret=True)
    got = graph_mix(torch.as_tensor(tmu, dtype=torch.float32), _to_torch(theta))
    _check(got, want, dtype)


def test_graph_mix_tree_one_call_per_dtype(monkeypatch):
    """A tree of f32 and bf16 leaves of assorted trailing shapes mixes with
    exactly two graph_mix calls and equals the JAX tree op leaf for leaf."""
    m = 16
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((m, m)).astype(np.float32)

    def leaf(shape, dtype):
        return jnp.asarray(rng.standard_normal((m,) + shape)).astype(dtype)

    jtree = {
        "stages": [{"slot0": {"attn": {"a": leaf((2, 8, 3), jnp.float32),
                                       "b": leaf((2, 3, 8), jnp.float32)},
                              "mlp": {"a": leaf((2, 8, 3), jnp.bfloat16),
                                      "b": leaf((2, 3, 8), jnp.bfloat16)}}}],
        "task": {"head_bias": leaf((50,), jnp.float32), "final_gain": leaf((8,), jnp.bfloat16)},
    }
    ttree = jax.tree.map(_to_torch, jtree)
    calls = []
    real = ops.graph_mix

    def counting(mu_, theta_):
        calls.append((tuple(theta_.shape), theta_.dtype))
        return real(mu_, theta_)

    monkeypatch.setattr(ops, "graph_mix", counting)
    got = graph_mix_tree(torch.as_tensor(mu), ttree)
    assert sorted(calls, key=str) == sorted(
        [((m, 2 * 2 * 8 * 3 + 50), torch.float32), ((m, 2 * 2 * 8 * 3 + 8), torch.bfloat16)],
        key=str,
    )
    want = jax_graph_mix_tree(jnp.asarray(mu), jtree)
    ref = graph_mix_tree_reference(torch.as_tensor(mu), ttree)
    assert [p for p, _ in tree_lib.paths(got)] == [p for p, _ in tree_lib.paths(ttree)]
    for g, w, r in zip(tree_lib.leaves(got), jax.tree_util.tree_leaves(want),
                       tree_lib.leaves(ref)):
        dt = "float32" if g.dtype == torch.float32 else "bfloat16"
        _check(g, w, dt)
        assert g.dtype == r.dtype and torch.equal(g.float(), r.float())


def test_graph_mix_tree_rejects_non_task_leading_leaf():
    mu = torch.eye(4)
    with pytest.raises(ValueError, match="task-leading"):
        graph_mix_tree(mu, {"a": torch.zeros(4, 3), "b": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="task-leading"):
        graph_mix_tree(mu, {"a": torch.zeros(())})
    assert graph_mix_tree(mu, {}) == {}


def test_graph_mix_shape_checks_and_cpu_path_counts_no_launch():
    before = graph_mix.launches
    with pytest.raises(ValueError, match="want mu"):
        graph_mix(torch.eye(3), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="want mu"):
        graph_mix(torch.eye(4), torch.zeros(4))
    mu = torch.eye(4, dtype=torch.float64)  # the plain version mixes in f32
    theta = torch.arange(20, dtype=torch.float32).reshape(4, 5)
    torch.testing.assert_close(graph_mix(mu, theta), theta, rtol=0, atol=0)
    torch.testing.assert_close(graph_mix_reference(mu, theta), theta, rtol=0, atol=0)
    assert graph_mix.launches == before
