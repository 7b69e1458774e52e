"""The port's task graph (repro_torch.core.graph) and delayed-iterate
helpers (repro_torch.core.delayed) against the JAX package's: every builder
and every mixing matrix equal exactly (both are numpy float64), the
regularizer and its gradient on torch tensors within float32 rounding, and
``per_source_stale`` / ``theorem7_rate`` equal exactly. CPU."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import delayed as jdelayed  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro_torch.core import delayed, graph  # noqa: E402


def _pairs():
    """(name, JAX graph, port graph) for every builder."""
    rng = np.random.default_rng(0)
    preds = rng.standard_normal((12, 5))
    labels = rng.integers(0, 3, 10)
    return [
        ("knn", jgraph.knn_graph(preds, k=3), graph.knn_graph(preds, k=3)),
        ("ring", jgraph.ring_graph(9, 0.5), graph.ring_graph(9, 0.5)),
        ("band", jgraph.band_graph(16, 2), graph.band_graph(16, 2)),
        ("band256", jgraph.band_graph(256, 2), graph.band_graph(256, 2)),
        ("complete", jgraph.complete_graph(7), graph.complete_graph(7)),
        ("cluster", jgraph.cluster_graph(labels), graph.cluster_graph(labels)),
        ("disconnected", jgraph.disconnected_graph(5), graph.disconnected_graph(5)),
    ]


@pytest.mark.parametrize("idx", range(7))
def test_builders_and_mixing_matrices_equal_reference(idx):
    name, jg, tg = _pairs()[idx]
    np.testing.assert_array_equal(tg.adjacency, jg.adjacency)
    assert tg.m == jg.m
    np.testing.assert_array_equal(tg.laplacian(), jg.laplacian())
    for eta, tau, alpha in ((1.0, 1.0, 1.0), (0.3, 0.5, 0.1)):
        np.testing.assert_array_equal(tg.metric_matrix(eta, tau), jg.metric_matrix(eta, tau))
        np.testing.assert_array_equal(tg.metric_inverse(eta, tau), jg.metric_inverse(eta, tau))
        np.testing.assert_array_equal(tg.bsr_mixing(eta, tau, alpha),
                                      jg.bsr_mixing(eta, tau, alpha))
        np.testing.assert_array_equal(tg.bol_mixing(eta, tau, alpha),
                                      jg.bol_mixing(eta, tau, alpha))
    if name != "disconnected":  # lambda_max = 0: consensus is undefined there
        assert tg.lambda_max == jg.lambda_max
        np.testing.assert_array_equal(tg.consensus_mixing(), jg.consensus_mixing())


@pytest.mark.parametrize("idx", range(6))  # not "disconnected": M = I there
def test_metric_roots_match_reference(idx):
    _, jg, tg = _pairs()[idx]
    for eta, tau in ((1.0, 1.0), (0.3, 0.5)):
        root, inv_root = tg.metric_sqrt(eta, tau), tg.metric_inv_sqrt(eta, tau)
        np.testing.assert_allclose(root, jg.metric_sqrt(eta, tau), atol=1e-10, rtol=0)
        np.testing.assert_allclose(inv_root, jg.metric_inv_sqrt(eta, tau), atol=1e-10, rtol=0)
        m = tg.metric_matrix(eta, tau)
        np.testing.assert_allclose(root @ root, m, atol=1e-8, rtol=0)
        np.testing.assert_allclose(inv_root @ m @ inv_root, np.eye(tg.m), atol=1e-8, rtol=0)


def test_graph_validation():
    with pytest.raises(ValueError, match="square"):
        graph.TaskGraph(np.zeros((2, 3)))
    with pytest.raises(ValueError, match="symmetric"):
        graph.TaskGraph(np.array([[0.0, 1.0], [0.0, 0.0]]))
    with pytest.raises(ValueError, match="non-negative"):
        graph.TaskGraph(np.array([[0.0, -1.0], [-1.0, 0.0]]))
    with pytest.raises(ValueError, match="eta"):
        graph.ring_graph(4).metric_matrix(0.0, 1.0)
    with pytest.raises(ValueError, match="k"):
        graph.knn_graph(np.zeros((4, 2)), k=4)
    g = graph.TaskGraph(np.ones((3, 3)))  # the diagonal is dropped
    np.testing.assert_array_equal(np.diag(g.adjacency), 0.0)


@pytest.mark.parametrize("eta,tau", [(1.0, 1.0), (0.3, 2.0)])
def test_penalty_and_grad_match_reference(eta, tau):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 33)).astype(np.float32)
    jg, tg = jgraph.band_graph(16, 2), graph.band_graph(16, 2)
    want = float(jg.penalty(jnp.asarray(w), eta, tau))
    got = tg.penalty(torch.as_tensor(w), eta, tau)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    np.testing.assert_allclose(
        tg.penalty_grad(torch.as_tensor(w), eta, tau).numpy(),
        np.asarray(jg.penalty_grad(jnp.asarray(w), eta, tau)), atol=1e-5,
    )


def test_per_source_stale_and_rate_match_reference():
    rng = np.random.default_rng(2)
    hist = rng.standard_normal((3, 8, 4, 5)).astype(np.float32)
    delays = rng.integers(0, 3, 8).astype(np.int32)
    got = delayed.per_source_stale(torch.as_tensor(hist), torch.as_tensor(delays))
    want = np.asarray(jdelayed.per_source_stale(jnp.asarray(hist), jnp.asarray(delays)))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in range(8):
        np.testing.assert_array_equal(got[k].numpy(), hist[delays[k], k])
    for eta, tau, gamma in ((1.0, 1.0, 0), (0.5, 2.0, 3)):
        assert delayed.theorem7_rate(eta, tau, gamma) == jdelayed.theorem7_rate(eta, tau, gamma)
