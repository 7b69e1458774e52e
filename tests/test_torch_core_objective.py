"""The port's objective, theory and data (repro_torch.core.objective,
.theory, repro_torch.data.synthetic) against the JAX package's, CPU,
float32, JAX at matmul precision "highest": the synthetic data and every
theory function exactly equal; risks, the objective, loss and ERM gradients
(against ``jax.grad``), smoothness and the closed-form solutions within
rtol 1e-5; then the reference's theory and property tests, run on the port
alone (hypothesis, few examples)."""
import math

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs import get as jax_get  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import theory  # noqa: E402
from repro_torch.core.algorithms import prox_squared_loss  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

RTOL = 1e-5
M, D, N = 12, 8, 60  # tests/test_core_algorithms.py
_SMOKE = get("multitask_linreg", smoke=True)
SIZES = {"algorithms": (M, D, N, 3, 3),
         "smoke": (_SMOKE.num_tasks, _SMOKE.dim, _SMOKE.train_per_task,
                   _SMOKE.num_clusters, _SMOKE.knn)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: intra-op threads buy nothing, and with
    several test workers on one machine their spin-waits multiply a run's
    time by hundreds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(size, seed=0):
    """The same draws through both packages: (JAX tasks, x, y; port tasks, x, y)."""
    m, d, n, c, k = SIZES[size]
    rng = np.random.default_rng(seed)
    jt = jsynth.generate_clustered_tasks(rng, m=m, d=d, num_clusters=c, knn=k)
    jx, jy = jt.sample(rng, n)
    rng = np.random.default_rng(seed)
    tt = synthetic.generate_clustered_tasks(rng, m=m, d=d, num_clusters=c, knn=k)
    tx, ty = tt.sample(rng, n, device="cpu")
    return jt, jx, jy, tt, tx, ty


def _problems(jt, tt, loss, n):
    b, s = jt.bs_constants()
    eta, tau = J.theory.corollary2_parameters(jt.graph, b, max(s, 1e-2), 8.0, n)
    return (J.MultiTaskProblem(jt.graph, getattr(J, loss), eta, tau),
            T.MultiTaskProblem(tt.graph, getattr(T, loss), eta, tau))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------ data, configs
@pytest.mark.parametrize("size", list(SIZES))
def test_synthetic_data_bit_equal(size):
    jt, jx, jy, tt, tx, ty = _data(size)
    for f in ("true_w", "sigma_chol", "cluster_of"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    np.testing.assert_array_equal(tt.graph.adjacency, jt.graph.adjacency)
    assert tt.noise_std == jt.noise_std and (tt.m, tt.d) == (jt.m, jt.d)
    assert tx.dtype == ty.dtype == torch.float32 and tx.device.type == "cpu"
    np.testing.assert_array_equal(tx.numpy(), jx)
    np.testing.assert_array_equal(ty.numpy(), jy)
    assert tt.bs_constants() == jt.bs_constants()
    w = np.random.default_rng(1).standard_normal((tt.m, tt.d)).astype(np.float32)
    assert tt.population_risk(torch.as_tensor(w)) == jt.population_risk(w)


def test_sample_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tasks = synthetic.generate_clustered_tasks(np.random.default_rng(0), m=6, d=3,
                                               num_clusters=2, knn=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tasks.sample(np.random.default_rng(0), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tasks.sample(np.random.default_rng(0), 4, device="cuda")


def test_linreg_config_matches_reference():
    for smoke in (False, True):
        j, t = jax_get("multitask_linreg", smoke=smoke), get("multitask_linreg", smoke=smoke)
        assert type(t).__name__ == "LinRegConfig"
        assert vars(t) == vars(j)


# ---------------------------------------------------- objective and gradients
@pytest.mark.parametrize("loss", ["SQUARED", "LOGISTIC"])
def test_risks_objective_and_gradients_match_jax(loss):
    jt, jx, jy, tt, tx, ty = _data("algorithms")
    if loss == "LOGISTIC":
        jy = np.where(jy > 0, 1.0, -1.0).astype(np.float32)
        ty = torch.as_tensor(jy)
    jp, tp = _problems(jt, tt, loss, N)
    w = np.random.default_rng(2).standard_normal((M, D)).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    with jax.default_matmul_precision("highest"):
        _close(tp.loss.per_task_risks(tw, tx, ty), jp.loss.per_task_risks(jw, jx, jy))
        _close(tp.loss.per_task_risk(tw[3], tx[3], ty[3]),
               jp.loss.per_task_risk(jw[3], jx[3], jy[3]))
        _close(tp.loss.empirical_risk(tw, tx, ty), jp.loss.empirical_risk(jw, jx, jy))
        _close(tp.erm_objective(tw, tx, ty), jp.erm_objective(jw, jx, jy))
        # the analytic derivatives against jax.grad of the same objective
        _close(tp.loss_grad(tw, tx, ty), jax.grad(jp.loss.empirical_risk)(jw, jx, jy),
               atol=1e-7)
        _close(tp.erm_grad(tw, tx, ty), jp.erm_grad(jw, jx, jy), atol=1e-7)
        _close(tp.reg_grad(tw), jp.reg_grad(jw), atol=1e-7)
    _close(tp.smoothness_loss(tx), jp.smoothness_loss(jx))
    _close(tp.loss.smoothness(tx[0]), jp.loss.smoothness(jx[0]))
    assert tp.smoothness_reg() == jp.smoothness_reg()


def test_logistic_keeps_the_reference_expression_past_softplus_threshold():
    """log1p(exp(-t p)) in float32, not softplus (whose linear branch above
    20 rounds differently): equal to JAX's on margins around 20."""
    pred = np.linspace(-30.0, 30.0, 121, dtype=np.float32)
    tgt = np.where(np.arange(121) % 2, 1.0, -1.0).astype(np.float32)
    want = J.LOGISTIC.fn(jnp.asarray(pred), jnp.asarray(tgt))
    got = T.LOGISTIC.fn(torch.as_tensor(pred), torch.as_tensor(tgt))
    _close(got, want)
    gw = jax.vmap(jax.grad(J.LOGISTIC.fn))(jnp.asarray(pred), jnp.asarray(tgt))
    _close(T.LOGISTIC.deriv(torch.as_tensor(pred), torch.as_tensor(tgt)), gw, atol=1e-12)


def test_closed_form_and_local_ridge_match_jax():
    jt, jx, jy, tt, tx, ty = _data("algorithms")
    jp, tp = _problems(jt, tt, "SQUARED", N)
    ws = tp.closed_form_solution(tx, ty)
    assert ws.dtype == torch.float32 and ws.device == tx.device
    _close(ws, jp.closed_form_solution(jx, jy))
    _close(T.centralized_solution(tp, tx, ty), J.centralized_solution(jp, jx, jy))
    _close(T.local_ridge_solution(tx, ty, 0.3), J.local_ridge_solution(jx, jy, 0.3))
    _close(T.local_solution(tx, ty, 0.3), J.local_solution(jx, jy, 0.3))
    # the closed form is stationary (tests/test_core_algorithms.py)
    assert tp.erm_grad(ws, tx, ty).abs().max().item() < 1e-4
    with pytest.raises(NotImplementedError):
        T.MultiTaskProblem(tt.graph, T.LOGISTIC, 1.0, 1.0).closed_form_solution(tx, ty)


# ------------------------------------------------------------------- theory
def _theory_graphs():
    rng = np.random.default_rng(4)
    preds = rng.standard_normal((12, 3))
    return {
        "ring": (J.ring_graph(16), T.ring_graph(16)),
        "band": (J.band_graph(20, 3), T.band_graph(20, 3)),
        "complete": (J.complete_graph(25), T.complete_graph(25)),
        "disconnected": (J.disconnected_graph(16), T.disconnected_graph(16)),
        "knn": (J.knn_graph(preds, 3), T.knn_graph(preds, 3)),
    }


@pytest.mark.parametrize("name", list(_theory_graphs()))
def test_theory_equals_reference_exactly(name):
    jg, tg = _theory_graphs()[name]
    jth = J.theory
    np.testing.assert_array_equal(tg.laplacian_eigvals(), jg.laplacian_eigvals())
    assert (tg.num_edges, tg.is_connected(), tg.is_doubly_stochastic()) == (
        jg.num_edges, jg.is_connected(), jg.is_doubly_stochastic())
    for b, s in ((1.0, 1e-6), (1.0, 0.5), (2.0, 3.0), (1.0, 1e6), (1.0, 0.0)):
        assert theory.rho(tg, b, s) == jth.rho(jg, b, s)
        assert theory.gradient_variance_bound(tg, b, s, 1.0) == \
            jth.gradient_variance_bound(jg, b, s, 1.0)
        if s > 0:
            assert theory.corollary2_parameters(tg, b, s, 8.0, 60) == \
                jth.corollary2_parameters(jg, b, s, 8.0, 60)
            assert theory.corollary2_bound(tg, b, s, 1.0, 100) == \
                jth.corollary2_bound(jg, b, s, 1.0, 100)
            assert theory.n_coupled(tg, b, s, 1.0, 0.1) == jth.n_coupled(jg, b, s, 1.0, 0.1)
            assert theory.b_star(tg, b, s, 1.0, 2.0, 1000) == \
                jth.b_star(jg, b, s, 1.0, 2.0, 1000)
            assert [vars(r) for r in theory.table1(tg, b, s, 1.0, 0.05)] == \
                [vars(r) for r in jth.table1(jg, b, s, 1.0, 0.05)]
    assert theory.lemma1_bound(tg, 0.3, 0.7, 1.0, 100) == jth.lemma1_bound(jg, 0.3, 0.7, 1.0, 100)
    assert theory.n_local(1.0, 2.0, 0.1) == jth.n_local(1.0, 2.0, 0.1)
    for got, want in zip(theory.theorem3_stepsizes(50, tg.m, 1.0, 2.0, 0.5),
                         jth.theorem3_stepsizes(50, jg.m, 1.0, 2.0, 0.5)):
        np.testing.assert_array_equal(got, want)


# -------------------- tests/test_theory.py, on the port alone (same cases)
def test_port_rho_range_monotone_and_variance():
    g = T.ring_graph(16)
    assert theory.rho(g, 1.0, 1e-6) < 1e-9
    assert abs(theory.rho(g, 1.0, 1e6) - 15 / 16) < 1e-3
    assert abs(theory.rho(T.disconnected_graph(16), 1.0, 1.0) - 15 / 16) < 1e-12
    rhos = [theory.rho(T.band_graph(20, 3), 1.0, s) for s in [0.01, 0.1, 1.0, 10.0]]
    assert all(a <= b + 1e-12 for a, b in zip(rhos, rhos[1:]))
    g8 = T.ring_graph(8)
    related = theory.gradient_variance_bound(g8, 1.0, 1e-6, 1.0)
    assert abs(related - 4.0 / 64) < 1e-6
    assert theory.gradient_variance_bound(g8, 1.0, 1e6, 1.0) > related * 7


def test_port_bounds_and_sample_complexity():
    m, n = 25, 100
    related = theory.corollary2_bound(T.complete_graph(m), 1.0, 1e-4, 1.0, n)
    unrelated = theory.corollary2_bound(T.disconnected_graph(m), 1.0, 1.0, 1.0, n)
    assert related < 4 / math.sqrt(m * n) * 1.5 and related < unrelated
    assert abs(unrelated - 4 * math.sqrt((1 / m + (m - 1) / m) / n)) < 1e-9
    g = T.ring_graph(10)
    assert theory.lemma1_bound(g, 1.0, 1.0, 1.0, 100) < theory.lemma1_bound(g, 0.1, 0.1, 1.0, 100)
    g50 = T.complete_graph(50)
    n_l = theory.n_local(1.0, 1.0, 0.1)
    assert theory.n_coupled(g50, 1.0, 1e-3, 1.0, 0.1) < n_l / 50 * 2
    assert theory.n_coupled(g50, 1.0, 1e3, 1.0, 0.1) > 0.9 * n_l
    assert 1 <= theory.b_star(g, 1.0, 0.5, 1.0, 2.0, 1_000) < theory.b_star(
        g, 1.0, 0.5, 1.0, 2.0, 100_000)


def test_port_table1_and_theorem3():
    by = {r.method: r for r in theory.table1(T.band_graph(16, 2), 1.0, 0.5, 1.0, 0.05)}
    assert by["local"].comm_rounds == 0
    assert by["stoch_ssr"].samples_processed_per_machine == pytest.approx(
        by["stoch_ssr"].samples_per_machine)
    assert by["erm_bsr"].samples_processed_per_machine > by["erm_bsr"].samples_per_machine
    assert (by["erm_bol"].vectors_per_machine / by["erm_bol"].comm_rounds
            < by["erm_bsr"].vectors_per_machine / by["erm_bsr"].comm_rounds)
    theta, alpha = theory.theorem3_stepsizes(T=50, m=10, B=1.0, beta_f=2.0, sigma=0.5)
    assert theta.shape == alpha.shape == (50,)
    assert np.all(np.diff(theta) > 0) and np.all(alpha > 0)


# ------------- tests/test_properties.py, on the port alone (few examples)
def _rand_graph(rng, m):
    a = rng.uniform(0, 1, (m, m))
    a = (a + a.T) / 2
    np.fill_diagonal(a, 0)
    a[a < 0.4] = 0.0
    return T.TaskGraph(a)


@settings(deadline=None, max_examples=10)
@given(m=st.integers(3, 15), d=st.integers(1, 8), seed=st.integers(0, 1000))
def test_port_laplacian_and_penalty_pairwise_form(m, d, seed):
    rng = np.random.default_rng(seed)
    g = _rand_graph(rng, m)
    assert g.laplacian_eigvals()[0] > -1e-9
    np.testing.assert_allclose(g.laplacian() @ np.ones(m), 0.0, atol=1e-9)
    w = rng.standard_normal((m, d))
    quad = g.penalty(torch.as_tensor(w, dtype=torch.float32), 0.7, 1.3).item()
    a = g.adjacency
    pair = sum(a[i, k] / 2 * np.sum((w[i] - w[k]) ** 2)
               for i in range(m) for k in range(m) if i != k)
    np.testing.assert_allclose(quad, 0.7 / (2 * m) * np.sum(w * w) + 1.3 / (2 * m) * pair,
                               rtol=1e-4)


@settings(deadline=None, max_examples=10)
@given(m=st.integers(3, 12), seed=st.integers(0, 1000), alpha=st.floats(1e-4, 1e-2))
def test_port_mixing_rows_and_metric_inverse(m, seed, alpha):
    g = _rand_graph(np.random.default_rng(seed), m)
    np.testing.assert_allclose(g.bol_mixing(0.9, 1.7, alpha).sum(axis=0), 1 - alpha * 0.9,
                               atol=1e-8)
    eig = np.linalg.eigvalsh(g.metric_inverse(1.0, 3.0))
    assert eig[0] > 0 and eig[-1] <= 1 + 1e-9


@settings(deadline=None, max_examples=10)
@given(m=st.integers(2, 8), d=st.integers(1, 6), n=st.integers(3, 10),
       seed=st.integers(0, 1000), alpha=st.floats(1e-3, 10.0))
def test_port_prox_optimality(m, d, n, seed, alpha):
    """prox output u satisfies (u - v)/alpha + grad F_hat_i(u) = 0."""
    rng = np.random.default_rng(seed)
    v, x, y = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((m, d), (m, n, d), (m, n)))
    u = prox_squared_loss(v, x, y, alpha)
    grad = (2.0 / n) * torch.einsum("mnd,mn->md", x, torch.einsum("mnd,md->mn", x, u) - y)
    assert ((u - v) / alpha + grad).abs().max().item() < 1e-3


@settings(deadline=None, max_examples=10)
@given(m=st.integers(4, 16), bw=st.integers(1, 3), B=st.floats(0.5, 3.0),
       S=st.floats(0.01, 10.0), seed=st.integers(0, 100), k=st.integers(1, 4))
def test_port_rho_bounds_and_knn_degree(m, bw, B, S, seed, k):
    r = theory.rho(T.band_graph(m, min(bw, m // 2 - 1) or 1), B, S)
    assert -1e-12 <= r <= (m - 1) / m + 1e-12
    k = min(k, m - 1)
    g = T.knn_graph(np.random.default_rng(seed).standard_normal((m, 4)), k=k)
    assert (g.adjacency > 0).sum(axis=1).min() >= k


@settings(deadline=None, max_examples=10)
@given(seed=st.integers(0, 1000), m=st.integers(3, 8), d=st.integers(2, 5))
def test_port_erm_objective_convex_along_segments(seed, m, d):
    rng = np.random.default_rng(seed)
    problem = T.MultiTaskProblem(_rand_graph(rng, m), T.SQUARED, 0.3, 0.9)
    x, y, w1, w2 = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
                    for s in ((m, 6, d), (m, 6), (m, d), (m, d)))
    mid = problem.erm_objective((w1 + w2) / 2, x, y)
    avg = (problem.erm_objective(w1, x, y) + problem.erm_objective(w2, x, y)) / 2
    assert mid.item() <= avg.item() + 1e-5
