"""The JAX reference's results at the paper's workload, for ``chip_smoke.py``
phase 9: every run of ``chip_smoke.PAPER_ITERS`` through ``repro.core`` on
the CPU (float32, matmul precision "highest"), on the same data (numpy seed
``PAPER_SEED``: m=100, d=100, n=500, 10-NN graph of 10 clusters) and with
the same iteration counts.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/paper_reference.py

Prints ``PAPER_REF`` (the gap to f* each run reaches; for graph learning the
learned graph's within/across-cluster affinity ratio) and
``PAPER_F_LOGISTIC`` (f* of the logistic problem: the reference's BSR after
3000 iterations), as ``chip_smoke.py`` holds them. The replayed runs (ssr,
sol, minibatch_prox) consume the smoke's numpy-drawn minibatch indices:
the sampler finds its iteration from the key it is handed among the run's
key chain. The ``*_generator`` runs, sdca and random-delay BOL draw with
JAX's own keys (``PRNGKey(0)``); the smoke cannot replay those draws and
holds them to a looser bound. Takes about a minute and 1.6 GB for the
(md x md) float64 closed form.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (its top level imports the standard library only)

from repro import core  # noqa: E402
from repro.data.synthetic import generate_clustered_tasks  # noqa: E402

jax.config.update("jax_enable_x64", False)


def replay_sampler(x, y, name, iters, key):
    """The smoke's replayed minibatches inside a jitted scan: the sampler is
    handed the t-th subkey of ``key``'s chain and looks t up."""
    idx = jnp.asarray(np.random.default_rng(smoke.PAPER_REPLAY_SEED[name]).integers(
        0, x.shape[1], (iters, x.shape[0], smoke.PAPER_BATCH)), jnp.int32)
    subs, k = [], key
    for _ in range(iters):
        k, sub = jax.random.split(k)
        subs.append(sub)
    subs = jnp.stack(subs)

    def sample(sub, b):
        i = idx[jnp.argmax(jnp.all(subs == sub, axis=-1))]
        return (jnp.take_along_axis(x, i[:, :, None], axis=1),
                jnp.take_along_axis(y, i, axis=1))

    return sample


def main():
    rng = np.random.default_rng(smoke.PAPER_SEED)
    tasks = generate_clustered_tasks(rng, m=100, d=100, num_clusters=10, knn=10)
    x_np, y_np = tasks.sample(rng, 500)
    x, y = jnp.asarray(x_np), jnp.asarray(y_np)
    y_cls = jnp.asarray(np.where(y_np > 0, 1.0, -1.0).astype(np.float32))
    b, s = tasks.bs_constants()
    eta, tau = core.theory.corollary2_parameters(tasks.graph, b, max(s, 1e-2), 8.0, 500)
    p = core.MultiTaskProblem(tasks.graph, core.SQUARED, eta, tau)
    deg = float(tasks.graph.adjacency.sum(axis=1).max())
    p_delayed = core.MultiTaskProblem(core.TaskGraph(tasks.graph.adjacency / deg),
                                      core.SQUARED, eta, tau * deg)
    p_log = core.MultiTaskProblem(tasks.graph, core.LOGISTIC, eta, tau)
    key = jax.random.PRNGKey(0)
    ev = lambda w: p.erm_objective(w, x, y)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        f_star = float(p.erm_objective(core.centralized_solution(p, x, y), x, y))
        f_log = float(core.bsr(p_log, x, y_cls, 3000).objective_trace[-1])
        ref = {}
        for name, iters in smoke.PAPER_ITERS.items():
            base = name.removesuffix("_generator")
            if base in smoke.PAPER_REPLAYED:
                sampler = (core.minibatch_sampler(x, y) if name.endswith("_generator")
                           else replay_sampler(x, y, base, iters, key))
                if base == "ssr":
                    r = core.ssr(p, sampler, smoke.PAPER_BATCH, iters, key, ev,
                                 p.smoothness_loss(x), b, d=100)
                elif base == "sol":
                    r = core.sol(p, sampler, smoke.PAPER_BATCH, iters, key, ev, d=100)
                else:
                    r = core.minibatch_prox(p, sampler, smoke.PAPER_BATCH, iters, key, ev, b,
                                            max(s, 1e-2), 8.0, inner_iters=15, d=100)
            elif name == "graph_learning":
                _, graph, _ = core.alternating_graph_learning(
                    x, y, eta, tau, num_rounds=iters, solver_iters=smoke.PAPER_SOLVER_ITERS)
                ref[name] = smoke.cluster_contrast(np, tasks, graph)
                continue
            else:
                r = {
                    "bsr": lambda: core.bsr(p, x, y, iters),
                    "bol": lambda: core.bol(p, x, y, iters),
                    "bol_inexact": lambda: core.bol(p, x, y, iters, exact_prox=False,
                                                    inner_steps=40),
                    "gd": lambda: core.gd(p, x, y, iters),
                    "admm": lambda: core.admm(p, x, y, iters, rho=0.05),
                    "consensus_sgd": lambda: core.consensus_sgd(p, x, y, iters),
                    "bol_delayed_fixed": lambda: core.bol_delayed(
                        p_delayed, x, y, iters, smoke.PAPER_DELAY, fixed_delay=True),
                    "bol_delayed_random": lambda: core.bol_delayed(
                        p_delayed, x, y, iters, smoke.PAPER_DELAY, key=key),
                    "sdca": lambda: core.sdca(p, x, y, iters, key=key),
                    "bsr_logistic": lambda: core.bsr(p_log, x, y_cls, iters),
                    "bol_logistic": lambda: core.bol(p_log, x, y_cls, iters, exact_prox=False,
                                                     inner_steps=30),
                }[name]()
            f0 = f_log if name.endswith("logistic") else f_star
            ref[name] = float(r.objective_trace[-1]) - f0
    print(f"f* {f_star!r} (JAX {jax.__version__}, CPU, float32)")
    print(f"PAPER_F_LOGISTIC = {f_log!r}")
    print("PAPER_REF = " + json.dumps(ref, indent=4))


if __name__ == "__main__":
    main()
