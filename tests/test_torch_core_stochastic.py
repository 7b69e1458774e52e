"""The port's stochastic solvers (repro_torch.core.stochastic) against the
JAX package's, CPU, float32, JAX at matmul precision "highest".

Lockstep through a replay sampler: the test rebuilds the reference's key
chain outside its scan (``k, sub = split(k)``, then ``randint(sub, (m, b),
0, n)`` as ``minibatch_sampler`` draws) and hands the port those indices
through a ``sample_fn`` that ignores its generator; ssr, sol and
minibatch_prox then give JAX's objective traces within rtol 1e-4 and its
final iterates within atol 1e-4. Leaving ``d=None`` gives the same run as
passing it. Then the reference's behaviour tests (test_core_algorithms'
ssr / sol, test_minibatch_prox), run on the port alone."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as J  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

TRACE_RTOL, W_ATOL = 1e-4, 1e-4
M, D = 12, 8
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


def _setup(n, seed=0):
    """tests/test_core_algorithms.py's (n 60) and tests/test_minibatch_prox.py's
    (n 80) setup through both packages."""
    if (n, seed) not in _CACHE:
        rng = np.random.default_rng(seed)
        jt = jsynth.generate_clustered_tasks(rng, m=M, d=D, num_clusters=3, knn=3)
        x, y = jt.sample(rng, n)
        tt = synthetic.generate_clustered_tasks(np.random.default_rng(seed), m=M, d=D,
                                                num_clusters=3, knn=3)
        b, s = jt.bs_constants()
        eta, tau = J.theory.corollary2_parameters(jt.graph, b, max(s, 1e-2), 8.0, n)
        _CACHE[(n, seed)] = dict(
            jp=J.MultiTaskProblem(jt.graph, J.SQUARED, eta, tau),
            tp=T.MultiTaskProblem(tt.graph, T.SQUARED, eta, tau),
            jx=jnp.asarray(x), jy=jnp.asarray(y), tx=torch.as_tensor(x),
            ty=torch.as_tensor(y), B=b, S=max(s, 1e-2), tasks=tt)
    return _CACHE[(n, seed)]


def _replay(s, key, iters, b):
    """The port's sampler for the minibatches JAX's run draws from ``key``."""
    k, idx = key, []
    for _ in range(iters):
        k, sub = jax.random.split(k)
        idx.append(np.asarray(jax.random.randint(sub, (M, b), 0, s["tx"].shape[1])))
    batches = iter(torch.as_tensor(np.stack(idx)).long())

    def sample(generator, bb):
        i = next(batches)
        return torch.gather(s["tx"], 1, i[:, :, None].expand(M, bb, D)), torch.gather(s["ty"], 1, i)

    return sample


def _run(name, s, pkg, sampler, key, iters, b, d=D):
    """One solver of the reference tests' calls, through ``pkg`` (J or T)."""
    p = s["jp"] if pkg is J else s["tp"]
    x, y = (s["jx"], s["jy"]) if pkg is J else (s["tx"], s["ty"])
    ev = lambda w: p.erm_objective(w, x, y)  # noqa: E731
    if name == "ssr":
        return pkg.ssr(p, sampler, b, iters, key, ev, p.smoothness_loss(x), s["B"], d=d)
    if name == "sol":
        return pkg.sol(p, sampler, b, iters, key, ev, d=d)
    return pkg.minibatch_prox(p, sampler, b, iters, key, ev, s["B"], s["S"], 8.0,
                              inner_iters=15, d=d)


# name -> (n of the setup, iterations, batch size)
CASES = {"ssr": (60, 200, 60), "sol": (60, 200, 60), "minibatch_prox": (80, 30, 20)}


@pytest.mark.parametrize("name", list(CASES))
def test_sampled_solver_lockstep_with_jax_through_replay(name):
    n, iters, b = CASES[name]
    s = _setup(n)
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision("highest"):
        jr = _run(name, s, J, J.minibatch_sampler(s["jx"], s["jy"]), key, iters, b)
    tr = _run(name, s, T, _replay(s, key, iters, b), torch.Generator(), iters, b)
    want = np.asarray(jr.objective_trace)
    assert tr.objective_trace.shape == want.shape and tr.w.dtype == torch.float32
    np.testing.assert_allclose(tr.objective_trace.numpy(), want, rtol=TRACE_RTOL)
    np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), atol=W_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_d_none_gives_the_same_run(name):
    """The d probe draws from a copy of the generator: the run's own draws,
    and so its trace, are those of the run given d."""
    n, _, b = CASES[name]
    s = _setup(n)
    sampler = T.minibatch_sampler(s["tx"], s["ty"])
    runs = [_run(name, s, T, sampler, torch.Generator().manual_seed(7), 12, b, d=d)
            for d in (D, None)]
    assert torch.equal(runs[0].objective_trace, runs[1].objective_trace)
    assert torch.equal(runs[0].w, runs[1].w)


def test_minibatch_sampler_draws_rows_of_the_set_on_the_generators_device():
    s = _setup(60)
    x, y = s["tx"], s["ty"]
    xb, yb = T.minibatch_sampler(x, y)(torch.Generator().manual_seed(0), 7)
    assert xb.shape == (M, 7, D) and yb.shape == (M, 7) and xb.device == x.device
    for i in range(M):
        for j in range(7):
            hits = (x[i] == xb[i, j]).all(dim=1).nonzero().flatten()
            assert len(hits) >= 1 and (y[i, hits] == yb[i, j]).any()


# ------- tests/test_core_algorithms.py ssr / sol, on the port alone (same cases)
@pytest.mark.parametrize("name", ["ssr", "sol"])
def test_port_sampled_solver_reaches_neighborhood(name):
    s = _setup(60)
    f_star = s["tp"].erm_objective(T.centralized_solution(s["tp"], s["tx"], s["ty"]),
                                   s["tx"], s["ty"]).item()
    res = _run(name, s, T, T.minibatch_sampler(s["tx"], s["ty"]),
               torch.Generator().manual_seed(0), 200, 60)
    assert res.objective_trace[-1].item() <= f_star + 0.5


# --------------------- tests/test_minibatch_prox.py, on the port alone
def test_port_minibatch_prox_improves_over_init():
    s = _setup(80)
    res = _run("minibatch_prox", s, T, T.minibatch_sampler(s["tx"], s["ty"]),
               torch.Generator().manual_seed(0), 30, 20)
    f0 = s["tp"].erm_objective(torch.zeros(M, D), s["tx"], s["ty"]).item()
    f_avg = s["tp"].erm_objective(res.w, s["tx"], s["ty"]).item()
    assert f_avg < f0 - 0.5 * (f0 - 3.0)  # the noise floor is sigma^2 = 3
    assert torch.isfinite(res.w).all()


def test_port_minibatch_prox_batch_size_insensitive():
    s = _setup(80, seed=1)
    risks = [s["tasks"].population_risk(_run(
        "minibatch_prox", s, T, T.minibatch_sampler(s["tx"], s["ty"]),
        torch.Generator().manual_seed(1), 400 // b, b).w) for b in (20, 80)]
    assert abs(risks[0] - risks[1]) < 0.5 * min(risks)
