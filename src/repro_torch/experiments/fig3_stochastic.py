"""Figure 3 reproduction: true stochastic algorithms (fresh samples each
iteration) at C=10, minibatch sweep b in {40, 80, 100, 200, 500}; budget of
10000 fresh samples per machine. SSR (accelerated minibatch SGD, Alg. 2) and
SOL (stochastic prox, eq. 11) vs the Local/Centralized(n=500) references.
The counterpart of the reference's ``benchmarks/fig3_stochastic.py``: its
fixed keys 7 (the held-out tuning seed), 1 (SSR) and 2 (SOL) are seeded
``torch.Generator``s on the device.

    python -m repro_torch.experiments.fig3_stochastic [--budget 10000] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import centralized_solution, sol, ssr
from repro_torch.experiments.common import (
    Timer,
    add_device_arg,
    full_f32,
    setup_problem,
    tune_local_reg,
    write_csv,
)

TUNE_SEED, SSR_SEED, SOL_SEED = 7, 1, 2
SIGMA_SCALES = (1.0, 0.1, 0.01)


def make_fresh_sampler(tasks, device):
    """Fresh samples from the true distributions each call: the port's
    sampler signature ``sample(generator, b) -> (x (m, b, d), y (m, b))``,
    drawn on the generator's device (``device``'s)."""
    chol = torch.as_tensor(tasks.sigma_chol, dtype=torch.float32, device=device)
    true_w = torch.as_tensor(tasks.true_w, dtype=torch.float32, device=device)
    noise = tasks.noise_std

    def sample(generator, b):
        dev = generator.device
        z = torch.randn((tasks.m, b, tasks.d), generator=generator, device=dev)
        x = z @ chol.T
        eps = noise * torch.randn((tasks.m, b), generator=generator, device=dev)
        y = torch.einsum("mbd,md->mb", x, true_w) + eps
        return x, y

    return sample


def main(argv=None, make_sampler=make_fresh_sampler, timings: dict | None = None):
    """``make_sampler(tasks, device)`` builds the sampler (a test replays
    another package's draws through it); ``timings``, when given, maps
    (method, batch) to the synchronized wall seconds of the reported run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--budget", type=int, default=10000)
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[40, 80, 100, 200, 500])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()

    tasks, x, y, problem = setup_problem(10, m=args.m, d=args.d, n=args.n,
                                         device=args.device)
    dev = x.device
    w_cent = centralized_solution(problem, x, y)
    cent_risk = tasks.population_risk(w_cent)
    reg, local_risk = tune_local_reg(tasks, x, y)
    print(f"references: local={local_risk:.4f} centralized={cent_risk:.4f}")

    sampler = make_sampler(tasks, dev)
    B_const, _ = tasks.bs_constants()
    beta_f = problem.smoothness_loss(x)
    eval_fn = lambda w: problem.erm_objective(w, x, y)  # noqa: E731  cheap trace proxy

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # The paper tunes stepsize parameters for its methods (Section 6); for
    # SSR that means the AC-SA sigma (smaller sigma => larger alpha). We grid
    # over sigma scales on a held-out seed and keep the best, like the paper.
    def run_ssr(b, iters, sigma_scale, seed):
        sig = sigma_scale * float(
            tasks.m * np.sqrt(
                4.0 * 64.0 / tasks.m**2
                * (1 + tasks.m * 0.1)
            )
        )
        return ssr(problem, sampler, b, iters, gen(seed), eval_fn,
                   beta_f=beta_f, B=B_const, d=tasks.d, sigma=sig)

    rows = []
    for b in args.batches:
        iters = args.budget // b
        # tune SSR sigma scale
        best = (None, np.inf)
        for sc in SIGMA_SCALES:
            res = run_ssr(b, iters, sc, TUNE_SEED)
            risk = tasks.population_risk(res.w)
            if risk < best[1]:
                best = (sc, risk)
        with Timer(dev) as t:
            res = run_ssr(b, iters, best[0], SSR_SEED)
        risk = tasks.population_risk(res.w)
        rows.append(["ssr", b, iters, risk])
        print(f"  ssr b={b:4d} rounds={iters:4d} pop_risk={risk:.4f} "
              f"(sigma_scale={best[0]})")
        with Timer(dev) as t_sol:
            res = sol(problem, sampler, b, iters, gen(SOL_SEED), eval_fn, d=tasks.d)
        risk = tasks.population_risk(res.w)
        rows.append(["sol", b, iters, risk])
        print(f"  sol b={b:4d} rounds={iters:4d} pop_risk={risk:.4f}")
        if timings is not None:
            timings[("ssr", b)], timings[("sol", b)] = t.seconds, t_sol.seconds
    rows.append(["local_ref", args.n, 0, local_risk])
    rows.append(["centralized_ref", args.n, 1, cent_risk])
    path = write_csv("fig3_stochastic.csv",
                     ["method", "batch", "rounds", "pop_risk"], rows)
    print(f"wrote {path}")
    return rows


if __name__ == "__main__":
    main()
