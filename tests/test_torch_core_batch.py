"""The port's batch solvers (repro_torch.core.algorithms, .baselines,
.consensus, .delayed, .graph_learning) against the JAX package's, CPU,
float32, JAX at matmul precision "highest".

Lockstep, same iterations and same w0: the whole objective trace within
rtol 1e-4 and the final iterate within atol 1e-4 for bsr (accelerated and
plain), bol (exact, and inexact with 40 inner steps), gd, admm (rho 0.05),
consensus_sgd, bol_delayed with fixed delays, logistic bsr / bol / gd on the
setup of tests/test_logistic.py, and prox_squared_loss / prox_gd alone.
SDCA and random-delay BOL draw what JAX cannot replay; they meet the
reference tests' criteria and end within 1e-3 of JAX's final objective.
Then the reference's behaviour tests (test_core_algorithms, test_logistic,
test_consensus_delay, graph learning), run on the port alone."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as J  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core.consensus import mixing_limit_check  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

TRACE_RTOL, W_ATOL = 1e-4, 1e-4
M, D, N = 12, 8, 60  # tests/test_core_algorithms.py
_CACHE = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: intra-op threads buy nothing, and with
    several test workers on one machine their spin-waits multiply a run's
    time by hundreds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paper_setup():
    """tests/test_core_algorithms.py's setup through both packages."""
    if "paper" not in _CACHE:
        rng = np.random.default_rng(0)
        jt = jsynth.generate_clustered_tasks(rng, m=M, d=D, num_clusters=3, knn=3)
        x, y = jt.sample(rng, N)
        tt = synthetic.generate_clustered_tasks(np.random.default_rng(0), m=M, d=D,
                                                num_clusters=3, knn=3)
        b, s = jt.bs_constants()
        eta, tau = J.theory.corollary2_parameters(jt.graph, b, max(s, 1e-2), 8.0, N)
        jp = J.MultiTaskProblem(jt.graph, J.SQUARED, eta, tau)
        tp = T.MultiTaskProblem(tt.graph, T.SQUARED, eta, tau)
        tx, ty = torch.as_tensor(x), torch.as_tensor(y)
        w_star = T.centralized_solution(tp, tx, ty)
        _CACHE["paper"] = dict(jp=jp, tp=tp, jx=jnp.asarray(x), jy=jnp.asarray(y), tx=tx, ty=ty,
                               w_star=w_star, f_star=tp.erm_objective(w_star, tx, ty).item(),
                               tasks=tt)
    return _CACHE["paper"]


def _classification(seed, m, d, n):
    """tests/test_logistic.py's make_classification; also the generator,
    from which that test draws its held-out set next."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d)
    w_true = np.stack([base + 0.3 * rng.standard_normal(d) for _ in range(m)])
    x = rng.standard_normal((m, n, d))
    logits = np.einsum("mnd,md->mn", x, w_true)
    y = np.where(rng.uniform(size=(m, n)) < 1 / (1 + np.exp(-logits)), 1.0, -1.0)
    return x.astype(np.float32), y.astype(np.float32), w_true, rng


def _delay_setup(seed):
    """tests/test_consensus_delay.py's delayed-BOL setup (doubly-stochastic ring)."""
    rng = np.random.default_rng(seed)
    tasks = synthetic.generate_clustered_tasks(rng, m=10, d=6, num_clusters=2, knn=3)
    x, y = tasks.sample(rng, 40, device="cpu")
    return (J.MultiTaskProblem(J.ring_graph(10, 0.5), J.SQUARED, 1.0, 2.0),
            T.MultiTaskProblem(T.ring_graph(10, 0.5), T.SQUARED, 1.0, 2.0), x, y)


# name -> (solver, problem source, kwargs); w0 "rand" is one seeded (m, d)
# start given to both packages
LOCKSTEP = {
    "bsr": ("bsr", "paper", dict(num_iters=300)),
    "bsr_plain": ("bsr", "paper", dict(num_iters=60, accelerated=False)),
    "bsr_w0_iterates": ("bsr", "paper", dict(num_iters=40, w0="rand", keep_iterates=True)),
    "bol": ("bol", "paper", dict(num_iters=400)),
    "bol_inexact": ("bol", "paper", dict(num_iters=100, exact_prox=False, inner_steps=40)),
    "bol_w0_iterates": ("bol", "paper", dict(num_iters=30, w0="rand", keep_iterates=True)),
    "gd": ("gd", "paper", dict(num_iters=2000)),
    "gd_w0": ("gd", "paper", dict(num_iters=200, w0="rand", stepsize=0.05)),
    "admm": ("admm", "paper", dict(num_iters=400, rho=0.05)),
    "consensus_sgd": ("consensus_sgd", "paper", dict(num_iters=100)),
    "bol_delayed_fixed": ("bol_delayed", "delay", dict(num_iters=200, max_delay=3,
                                                       fixed_delay=True)),
    "bsr_logistic": ("bsr", "logistic", dict(num_iters=150, accelerated=False, stepsize=0.5)),
    "bol_logistic": ("bol", "logistic", dict(num_iters=120, exact_prox=False, inner_steps=30)),
    "gd_logistic": ("gd", "logistic", dict(num_iters=300, stepsize=0.3)),
}


def _problem_pair(source):
    if source == "paper":
        s = _paper_setup()
        return s["jp"], s["tp"], s["tx"], s["ty"]
    if source == "delay":
        jp, tp, x, y = _delay_setup(4)
        return jp, tp, x, y
    x, y, _, _ = _classification(1, 8, 6, 60)
    return (J.MultiTaskProblem(J.ring_graph(8), J.LOGISTIC, 0.3, 1.0),
            T.MultiTaskProblem(T.ring_graph(8), T.LOGISTIC, 0.3, 1.0),
            torch.as_tensor(x), torch.as_tensor(y))


def _lockstep(name):
    """(JAX RunResult, port RunResult) of one LOCKSTEP case, computed once."""
    if name not in _CACHE:
        fn, source, kw = LOCKSTEP[name]
        jp, tp, tx, ty = _problem_pair(source)
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("w0") == "rand":
            w0 = np.random.default_rng(5).standard_normal(tuple(tx.shape[::2])) * 0.3
            jkw["w0"], tkw["w0"] = jnp.asarray(w0, jnp.float32), torch.as_tensor(
                w0, dtype=torch.float32)
        with jax.default_matmul_precision("highest"):
            jr = getattr(J, fn)(jp, jnp.asarray(tx.numpy()), jnp.asarray(ty.numpy()), **jkw)
        _CACHE[name] = (jr, getattr(T, fn)(tp, tx, ty, **tkw))
    return _CACHE[name]


def _assert_lockstep(jr, tr):
    want = np.asarray(jr.objective_trace)
    assert tr.objective_trace.dtype == torch.float32 and tr.objective_trace.shape == want.shape
    np.testing.assert_allclose(tr.objective_trace.numpy(), want, rtol=TRACE_RTOL)
    np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), atol=W_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(LOCKSTEP))
def test_solver_lockstep_with_jax(name):
    jr, tr = _lockstep(name)
    _assert_lockstep(jr, tr)
    if LOCKSTEP[name][2].get("keep_iterates"):
        np.testing.assert_allclose(tr.w_trace.numpy(), np.asarray(jr.w_trace), atol=W_ATOL,
                                   rtol=0)
    else:
        assert tr.w_trace is None


@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_prox_alone_matches_jax(loss):
    rng = np.random.default_rng(6)
    v, x = rng.standard_normal((5, 4)), rng.standard_normal((5, 9, 4))
    y = rng.standard_normal((5, 9)) if loss == "squared" else np.sign(rng.standard_normal((5, 9)))
    jv, jx, jy = (jnp.asarray(a, jnp.float32) for a in (v, x, y))
    tv, tx, ty = (torch.as_tensor(a, dtype=torch.float32) for a in (v, x, y))
    jl, tl = (J.SQUARED, T.SQUARED) if loss == "squared" else (J.LOGISTIC, T.LOGISTIC)
    with jax.default_matmul_precision("highest"):
        if loss == "squared":
            for alpha in (1e-3, 0.7, 10.0):
                np.testing.assert_allclose(
                    talg.prox_squared_loss(tv, tx, ty, alpha).numpy(),
                    np.asarray(jalg.prox_squared_loss(jv, jx, jy, alpha)), rtol=1e-4, atol=1e-5)
        jg = lambda u: 5 * jax.grad(jl.empirical_risk)(u, jx, jy)  # noqa: E731
        tg = lambda u: 5 * tl.risk_grad(u, tx, ty)  # noqa: E731
        np.testing.assert_allclose(talg.prox_gd(tv, tg, 0.5, 2.0, 25).numpy(),
                                   np.asarray(jalg.prox_gd(jv, jg, 0.5, 2.0, 25)),
                                   rtol=1e-4, atol=1e-5)


def test_sdca_meets_reference_criterion_and_jax_objective():
    s = _paper_setup()
    tr = T.sdca(s["tp"], s["tx"], s["ty"], num_rounds=150, local_epochs=1)
    with jax.default_matmul_precision("highest"):
        jr = J.sdca(s["jp"], s["jx"], s["jy"], num_rounds=150, local_epochs=1)
    f_end = tr.objective_trace[-1].item()
    assert f_end <= s["f_star"] + 5e-3
    assert abs(f_end - float(jr.objective_trace[-1])) <= 1e-3
    assert T.sdca(s["tp"], s["tx"], s["ty"], 3, generator=torch.Generator().manual_seed(1)) \
        .objective_trace.shape == (3,)
    with pytest.raises(NotImplementedError):
        T.sdca(T.MultiTaskProblem(s["tasks"].graph, T.LOGISTIC, 1.0, 1.0), s["tx"], s["ty"], 1)


def test_random_delay_bol_converges_and_matches_jax_objective():
    """tests/test_consensus_delay.py's criteria (Theorem 7), on the port."""
    jp, tp, x, y = _delay_setup(3)
    w_star = T.centralized_solution(tp, x, y)
    tr = T.bol_delayed(tp, x, y, num_iters=800, max_delay=3)
    np.testing.assert_allclose(tr.w.numpy(), w_star.numpy(), atol=5e-2)
    with jax.default_matmul_precision("highest"):
        jr = J.bol_delayed(jp, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), num_iters=800,
                           max_delay=3)
    assert abs(tr.objective_trace[-1].item() - float(jr.objective_trace[-1])) <= 1e-3
    _, tp4, x4, y4 = _delay_setup(4)
    w4 = T.centralized_solution(tp4, x4, y4)
    errs = [torch.linalg.norm(T.bol_delayed(tp4, x4, y4, num_iters=100, max_delay=max(g, 1),
                                            fixed_delay=g > 0).w - w4).item() for g in (0, 4)]
    assert errs[0] < errs[1]
    assert T.theorem7_rate(1.0, 2.0, 4) > T.theorem7_rate(1.0, 2.0, 0)


def test_delayed_ring_view_reads_each_iterate_at_its_delay():
    """hist[delays, k] picks, for every edge (i, k), task k's iterate from
    delays[i, k] steps ago: a fixed delay of 1 changes the run from a delay
    of 0, and gives JAX's trace."""
    _, tp, x, y = _delay_setup(4)
    runs = [T.bol_delayed(tp, x, y, 30, max_delay=g, fixed_delay=True).objective_trace
            for g in (0, 1)]
    assert not torch.equal(runs[0], runs[1])
    jp0 = J.MultiTaskProblem(J.ring_graph(10, 0.5), J.SQUARED, 1.0, 2.0)
    with jax.default_matmul_precision("highest"):
        jr = J.bol_delayed(jp0, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), 30,
                           max_delay=1, fixed_delay=True)
    np.testing.assert_allclose(runs[1].numpy(), np.asarray(jr.objective_trace),
                               rtol=TRACE_RTOL)


# ------------- tests/test_core_algorithms.py, on the port alone (same cases)
@pytest.mark.parametrize("name,gap,atol", [
    ("bsr", 1e-4, 5e-2), ("bol", 1e-3, 8e-2), ("bol_inexact", None, 1e-1),
    ("gd", 1e-3, None), ("admm", 5e-3, None),
])
def test_port_solver_converges_to_erm(name, gap, atol):
    s = _paper_setup()
    tr = _lockstep(name)[1]
    if gap is not None:
        assert tr.objective_trace[-1].item() <= s["f_star"] + gap
    if atol is not None:
        np.testing.assert_allclose(tr.w.numpy(), s["w_star"].numpy(), atol=atol)


def test_port_bsr_plain_converges_slower():
    s = _paper_setup()
    acc = T.bsr(s["tp"], s["tx"], s["ty"], num_iters=60)
    plain = _lockstep("bsr_plain")[1]
    assert acc.objective_trace[-1].item() <= plain.objective_trace[-1].item() + 1e-5


# --------------------- tests/test_logistic.py, on the port alone (same cases)
@pytest.mark.parametrize("name", ["bsr_logistic", "bol_logistic"])
def test_port_logistic_decreases_objective(name):
    tr = _lockstep(name)[1].objective_trace.numpy()
    assert tr[-1] < tr[0] * 0.98 and np.isfinite(tr).all()


def test_port_logistic_methods_agree():
    x, y, _, _ = _classification(2, 6, 5, 80)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    problem = T.MultiTaskProblem(T.ring_graph(6), T.LOGISTIC, 0.5, 1.0)
    f_bsr = T.bsr(problem, x, y, num_iters=600, accelerated=False,
                  stepsize=0.5).objective_trace[-1].item()
    f_bol = T.bol(problem, x, y, num_iters=400, exact_prox=False,
                  inner_steps=40).objective_trace[-1].item()
    f_gd = T.gd(problem, x, y, num_iters=1500, stepsize=0.3).objective_trace[-1].item()
    assert abs(f_bsr - f_bol) < 5e-3 and abs(f_bsr - f_gd) < 5e-3


def test_port_logistic_coupling_accuracy():
    x, y, w_true, rng = _classification(3, 10, 8, 25)
    xt = rng.standard_normal((10, 500, 8)).astype(np.float32)
    yt = np.sign(np.einsum("mnd,md->mn", xt, w_true)).astype(np.float32)

    def acc(w):
        return (np.sign(np.einsum("mnd,md->mn", xt, w.numpy())) == yt).mean()

    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    w_c = T.bol(T.MultiTaskProblem(T.ring_graph(10), T.LOGISTIC, 0.2, 2.0), tx, ty,
                num_iters=200, exact_prox=False, inner_steps=30).w
    w_l = T.bol(T.MultiTaskProblem(T.ring_graph(10), T.LOGISTIC, 0.2, 0.0), tx, ty,
                num_iters=200, exact_prox=False, inner_steps=30).w
    assert acc(w_c) >= acc(w_l) - 0.01 and acc(w_c) > 0.7


# ------------- tests/test_consensus_delay.py, on the port alone (same cases)
def _consensus_data(seed=0):
    rng = np.random.default_rng(seed)
    tasks = synthetic.generate_clustered_tasks(rng, m=10, d=6, num_clusters=2, knn=3)
    x, y = tasks.sample(rng, 40, device="cpu")
    return tasks, x, y


def test_port_uniform_weights_maintain_consensus():
    tasks, x, y = _consensus_data()
    res = T.consensus_sgd(T.MultiTaskProblem(tasks.graph, T.SQUARED, 0.5, 1.0), x, y, 100)
    assert T.consensus_distance(res.w).item() < 1e-5


def test_port_mixing_limits():
    dists = mixing_limit_check(T.ring_graph(12), eta=1.0, taus=[1e0, 1e2, 1e4, 1e6])
    assert all(a > b for a, b in zip(dists, dists[1:])) and dists[-1] < 1e-4
    mu = T.band_graph(9, 2).consensus_mixing()
    np.testing.assert_allclose(mu.sum(axis=0), 1.0, atol=1e-10)
    np.testing.assert_allclose(mu.sum(axis=1), 1.0, atol=1e-10)


def test_port_large_tau_approaches_consensus_and_disconnected_stays_plural():
    tasks, x, y = _consensus_data()
    spreads = [T.consensus_distance(T.centralized_solution(
        T.MultiTaskProblem(T.ring_graph(10), T.SQUARED, 0.5, tau), x, y)).item()
        for tau in (0.1, 10.0, 1000.0)]
    assert spreads[0] > spreads[1] > spreads[2] and spreads[2] < 1e-2
    res = T.bol(T.MultiTaskProblem(T.ring_graph(10), T.SQUARED, 0.5, 1000.0), x, y, 2000)
    assert T.consensus_distance(res.w).item() < 5e-2
    assert not tasks.graph.is_connected()
    w = T.centralized_solution(T.MultiTaskProblem(tasks.graph, T.SQUARED, 0.5, 1000.0), x, y)
    assert T.consensus_distance(w).item() > 0.1


# ---------- tests/test_runners_extensions.py graph learning, on the port alone
def test_port_graph_learning_recovers_cluster_structure():
    rng = np.random.default_rng(2)
    tasks = synthetic.generate_clustered_tasks(rng, m=12, d=10, num_clusters=2, knn=3,
                                               perturb_scale=0.02)
    x, y = tasks.sample(rng, 60, device="cpu")
    w, graph, hist = T.alternating_graph_learning(x, y, eta=0.5, tau=1.5, num_rounds=3,
                                                  solver_iters=150)
    a = graph.adjacency
    same = tasks.cluster_of[:, None] == tasks.cluster_of[None, :]
    np.fill_diagonal(same, False)
    assert a[same].mean() > 2.0 * a[~same & ~np.eye(12, dtype=bool)].mean()
    assert torch.isfinite(w).all() and len(hist) == 3
    # the relationship matrix and the learned graph equal the reference's
    omega = T.mtrl_relationship(w)
    np.testing.assert_allclose(omega, J.mtrl_relationship(w.numpy()), rtol=1e-12)
    np.testing.assert_array_equal(T.laplacian_from_relationship(omega).adjacency,
                                  J.laplacian_from_relationship(omega).adjacency)
