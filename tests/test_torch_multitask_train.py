"""Parity of the port's GraphMultiTask and mixing_spec_for_band_graph
(repro_torch.core.distributed) with the JAX package's
(repro.core.distributed), CPU: every branch of mixing_matrix, partition,
replicate_task_params, mix_task_params (== mu^T theta) and graph_penalty
with its gradient, on the multitask_lm smoke model's parameters."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.core.distributed import GraphMultiTask as JaxGMT  # noqa: E402
from repro.core.distributed import mixing_spec_for_band_graph as jax_spec  # noqa: E402
from repro.core.graph import TaskGraph as JaxGraph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params, params_from_numpy  # noqa: E402
from repro_torch.core import GraphMultiTask, mixing_spec_for_band_graph  # noqa: E402
from repro_torch.core.graph import TaskGraph, band_graph, cluster_graph, ring_graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402


def _both(graph, **kw):
    return GraphMultiTask(graph, **kw), JaxGMT(JaxGraph(graph.adjacency), **kw)


def _params():
    """JAX smoke params with random task tables, and the port's named
    parameters holding the same values."""
    jm = JaxLM(jax_get("multitask_lm", smoke=True))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params["task"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
                      for k, v in params["task"].items()}
    tm = load_numpy_params(TransformerLM(get("multitask_lm", smoke=True), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return params, dict(tm.named_parameters())


def _names(jax_tree):
    """The port's parameter names of a JAX (partition) tree's leaves."""
    def drop_none(t):
        if isinstance(t, dict):
            return {k: drop_none(v) for k, v in t.items() if v is not None}
        if isinstance(t, list):
            return [drop_none(v) for v in t]
        return np.asarray(t)
    return set(params_from_numpy(drop_none(jax_tree), get("multitask_lm", smoke=True)))


@pytest.mark.parametrize("kw", [
    dict(eta=0.0, tau=0.0),              # identity
    dict(eta=0.0, tau=2.0),              # Laplacian step, default alpha
    dict(eta=0.0, tau=2.0, alpha=0.05),  # Laplacian step, given alpha
    dict(eta=0.1, tau=1.0),              # BOL, default alpha
    dict(eta=0.5, tau=2.0, alpha=0.1),   # BOL, given alpha
])
def test_mixing_matrix_matches_jax(kw):
    a = np.random.default_rng(1).random((9, 9))
    a = (a + a.T) / 2
    np.fill_diagonal(a, 0.0)
    for graph in (band_graph(8, 1), TaskGraph(a)):
        gmt, jgmt = _both(graph, **kw)
        np.testing.assert_allclose(gmt.mixing_matrix(), jgmt.mixing_matrix(),
                                   rtol=0, atol=1e-12)
        assert gmt._alpha() == pytest.approx(jgmt._alpha(), rel=1e-12) if kw["eta"] else True


def test_partition_and_replicate_select_the_reference_leaves():
    jparams, tparams = _params()
    gmt, jgmt = _both(band_graph(8, 1), eta=0.1, tau=1.0)
    shared, task = gmt.partition(tparams)
    jshared, jtask = jgmt.partition(jparams)
    assert {n for n, v in task.items() if v is not None} == {"task.final_gain", "task.head_bias"}
    assert {n for n, v in shared.items() if v is not None} == _names(jshared)
    assert {n for n, v in task.items() if v is not None} == _names(jtask)
    rep, jrep = gmt.replicate_task_params(tparams), jgmt.replicate_task_params(jparams)
    for name in ("final_gain", "head_bias"):
        np.testing.assert_array_equal(rep[f"task.{name}"].detach().numpy(),
                                      np.asarray(jrep["task"][name]))
    assert rep["embed"] is tparams["embed"]


def test_mix_task_params_is_mu_t_theta_and_matches_jax():
    jparams, tparams = _params()
    gmt, jgmt = _both(band_graph(8, 1), eta=0.5, tau=2.0)
    with torch.no_grad():
        mixed = gmt.mix_task_params(tparams)
        given = gmt.mix_task_params(tparams, gmt.mix_tensor("cpu"))
    with jax.default_matmul_precision("highest"):
        jmixed = jgmt.mix_task_params(jparams)
    mu = gmt.mixing_matrix()
    for name in ("final_gain", "head_bias"):
        got, want = mixed[f"task.{name}"].numpy(), np.asarray(jmixed["task"][name])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        theta = tparams[f"task.{name}"].detach().numpy().astype(np.float64)
        np.testing.assert_allclose(got, mu.T @ theta, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(given[f"task.{name}"].numpy(), got)
    for name, leaf in tparams.items():  # shared leaves pass through untouched
        if not name.startswith("task."):
            assert mixed[name] is leaf


def test_graph_penalty_and_its_gradient_match_jax():
    jparams, tparams = _params()
    gmt, jgmt = _both(ring_graph(8), eta=0.3, tau=1.5)
    with jax.default_matmul_precision("highest"):
        jval, jgrad = jax.value_and_grad(jgmt.graph_penalty)(jparams)
    val = gmt.graph_penalty(tparams)
    grads = torch.autograd.grad(val, [tparams["task.final_gain"], tparams["task.head_bias"]])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    for g, name in zip(grads, ("final_gain", "head_bias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad["task"][name]),
                                   rtol=1e-5, atol=1e-7)
    no_task = {k: v for k, v in tparams.items() if not k.startswith("task.")}
    assert float(gmt.graph_penalty(no_task)) == 0.0


@pytest.mark.parametrize("graph", [
    band_graph(12, 1), band_graph(12, 2, weight=0.5), band_graph(9, 4), ring_graph(6, 2.0),
    cluster_graph(np.repeat([0, 1], 4)),                        # not a band: None
    TaskGraph(np.roll(np.eye(10), 2, 1) + np.roll(np.eye(10), -2, 1)),  # hole at 1: None
])
def test_mixing_spec_for_band_graph_matches_jax(graph):
    got = mixing_spec_for_band_graph(graph, 0.1, 1.0, 0.2)
    want = jax_spec(JaxGraph(graph.adjacency), 0.1, 1.0, 0.2)
    assert got == want
