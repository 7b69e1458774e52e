"""How far the port's paper solvers are from the JAX package's on the CPU:
for every lockstep case of ``tests/test_torch_core_batch.py`` and
``tests/test_torch_core_stochastic.py`` (same inputs, same iterations), the
largest relative difference of the objective traces and the largest
absolute difference of the final iterates; for SDCA and random-delay BOL,
whose draws JAX cannot replay, the difference of the final objectives; for
the objective, the largest relative differences of the risks, gradients
and closed forms. The tests hold these to their tolerances; this prints
the measured values.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/paper_parity.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
import test_torch_core_batch as tb  # noqa: E402
import test_torch_core_objective as to  # noqa: E402
import test_torch_core_stochastic as ts  # noqa: E402

from repro import core as J  # noqa: E402
from repro_torch import core as T  # noqa: E402


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def absdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def main():
    print("lockstep (trace rel, final w abs):")
    for name in tb.LOCKSTEP:
        jr, tr = tb._lockstep(name)
        print(f"  {name}: {rel(tr.objective_trace.numpy(), jr.objective_trace):.3e} "
              f"{absdiff(tr.w.numpy(), jr.w):.3e}")
    for name, (n, iters, b) in ts.CASES.items():
        s = ts._setup(n)
        key = jax.random.PRNGKey(0)
        with jax.default_matmul_precision("highest"):
            jr = ts._run(name, s, J, J.minibatch_sampler(s["jx"], s["jy"]), key, iters, b)
        tr = ts._run(name, s, T, ts._replay(s, key, iters, b), torch.Generator(), iters, b)
        print(f"  {name} (replayed): {rel(tr.objective_trace.numpy(), jr.objective_trace):.3e} "
              f"{absdiff(tr.w.numpy(), jr.w):.3e}")
    s = tb._paper_setup()
    with jax.default_matmul_precision("highest"):
        jr = J.sdca(s["jp"], s["jx"], s["jy"], num_rounds=150)
        tr = T.sdca(s["tp"], s["tx"], s["ty"], num_rounds=150)
        print(f"sdca, 150 rounds: final objective |port - JAX| "
              f"{abs(tr.objective_trace[-1].item() - float(jr.objective_trace[-1])):.3e}, "
              f"port gap to f* {tr.objective_trace[-1].item() - s['f_star']:.3e}")
        jp, tp, x, y = tb._delay_setup(3)
        jr = J.bol_delayed(jp, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), 800, 3)
        tr = T.bol_delayed(tp, x, y, 800, 3)
        print(f"random-delay bol, 800 iterations: final objective |port - JAX| "
              f"{abs(tr.objective_trace[-1].item() - float(jr.objective_trace[-1])):.3e}")
        print("objective (max rel):")
        for loss in ("SQUARED", "LOGISTIC"):
            jt, jx, jy, tt, tx, ty = to._data("algorithms")
            if loss == "LOGISTIC":
                jy = np.where(jy > 0, 1.0, -1.0).astype(np.float32)
                ty = torch.as_tensor(jy)
            jp, tp = to._problems(jt, tt, loss, to.N)
            w = np.random.default_rng(2).standard_normal((to.M, to.D)).astype(np.float32)
            jw, tw = jnp.asarray(w), torch.as_tensor(w)
            pairs = {
                "risks": (tp.loss.per_task_risks(tw, tx, ty), jp.loss.per_task_risks(jw, jx, jy)),
                "objective": (tp.erm_objective(tw, tx, ty), jp.erm_objective(jw, jx, jy)),
                "loss_grad": (tp.loss_grad(tw, tx, ty),
                              jax.grad(jp.loss.empirical_risk)(jw, jx, jy)),
                "erm_grad": (tp.erm_grad(tw, tx, ty), jp.erm_grad(jw, jx, jy)),
                "smoothness": (tp.smoothness_loss(tx), jp.smoothness_loss(jx)),
            }
            print(f"  {loss}: " + " ".join(f"{k} {rel(*v):.3e}" for k, v in pairs.items()))
        jt, jx, jy, tt, tx, ty = to._data("algorithms")
        jp, tp = to._problems(jt, tt, "SQUARED", to.N)
        closed = rel(tp.closed_form_solution(tx, ty), jp.closed_form_solution(jx, jy))
        ridge = rel(T.local_ridge_solution(tx, ty, 0.3), J.local_ridge_solution(jx, jy, 0.3))
        print(f"  closed form {closed:.3e} local ridge {ridge:.3e}")


if __name__ == "__main__":
    main()
