"""Experiment runner — one function per paper table/figure plus the graph-mix
kernel check. The counterpart of the reference's ``benchmarks/run.py``.

Prints ``name,seconds,derived`` CSV summary lines (detailed per-experiment
CSVs land in build/reports/).

  fig2_erm           Figure 2  — ERM convergence, all methods, C sweep
  fig3_stochastic    Figure 3  — stochastic minibatch sweep (fresh samples)
  table1             Table 1   — communication/sample complexity accounting
  delay              Theorem 7 — bounded-staleness convergence
  ablation_mtl_lm    beyond-paper — graph-mixed LM personalization
  kernels            micro     — the graph-mix CUDA kernel vs its plain version

Full paper-scale runs: pass --full (m=100, d=100, n=500 as in Appendix I);
the default is a reduced-size pass that exercises every code path quickly.
Runs on CUDA unless --device names another device (without a GPU it
raises). On CPU tensors the graph-mix op runs its plain version, and the
``kernels`` line says so.

    python -m repro_torch.experiments [--full] [--only NAME] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.experiments.common import add_device_arg, full_f32
from repro_torch.kernels.runtime import require_device

KERNEL_SHAPE = (32, 4096)  # (m tasks, d) of the graph-mix check


def _timed(name, fn):
    t0 = time.perf_counter()
    derived = fn()
    dt = time.perf_counter() - t0
    print(f"SUMMARY,{name},{dt:.2f}s,{derived}")
    return dt, derived


def main(argv=None) -> dict:
    """Returns {name: (seconds, derived)} of the experiments it ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sizes (slower)")
    ap.add_argument("--only", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()
    dev = require_device(args.device)
    device = ["--device", str(dev)]

    if args.full:
        size = ["--m", "100", "--d", "100", "--n", "500"]
        fig2_extra = ["--iters", "300"]
        fig3_extra = ["--budget", "10000"]
    else:
        size = ["--m", "40", "--d", "40", "--n", "150"]
        fig2_extra = ["--iters", "200", "--clusters", "1", "5", "50"]
        fig3_extra = ["--budget", "3000", "--batches", "50", "150", "500"]

    def bench_fig2():
        from repro_torch.experiments import fig2_erm

        rows = fig2_erm.main(size + fig2_extra + device)
        return f"methods={len(set(r[0] for r in rows))}"

    def bench_fig3():
        from repro_torch.experiments import fig3_stochastic

        rows = fig3_stochastic.main(size + fig3_extra + device)
        return f"points={len(rows)}"

    def bench_table1():
        from repro_torch.experiments import table1_complexity

        rows = table1_complexity.main(size + device)
        return f"rows={len(rows)}"

    def bench_delay():
        from repro_torch.experiments import delay_bench

        rows = delay_bench.main(
            ([] if args.full else ["--m", "12", "--d", "12", "--n", "60",
                                   "--iters", "200"]) + device
        )
        return f"gammas={len(rows)}"

    def bench_ablation():
        from repro_torch.experiments import ablation_mtl_lm

        rows = ablation_mtl_lm.main(
            ["--steps", "200" if args.full else "40"] + device
        )
        by = {r[0]: r[1] for r in rows}
        return f"local={by['local']:.3f},graph={by['graph']:.3f},consensus={by['consensus']:.3f}"

    def bench_kernels():
        import numpy as np
        import torch

        from repro_torch.kernels.graph_mix.ops import graph_mix
        from repro_torch.kernels.graph_mix.ref import graph_mix_reference

        rng = np.random.default_rng(0)
        m, d = KERNEL_SHAPE
        mu = torch.as_tensor(rng.standard_normal((m, m)), dtype=torch.float32, device=dev)
        th = torch.as_tensor(rng.standard_normal((m, d)), dtype=torch.float32, device=dev)
        got = graph_mix(mu, th)
        want = graph_mix_reference(mu, th)
        err = float(torch.max(torch.abs(got - want)))
        route = "cuda kernel" if dev.type == "cuda" else f"plain version on {dev.type} tensors"
        return f"graph_mix_max_err={err:.2e},route={route}"

    benches = {
        "fig2_erm": bench_fig2,
        "fig3_stochastic": bench_fig3,
        "table1": bench_table1,
        "delay": bench_delay,
        "ablation_mtl_lm": bench_ablation,
        "kernels": bench_kernels,
    }
    if args.only and args.only not in benches:
        raise SystemExit(f"--only {args.only!r}: not one of {sorted(benches)}")
    print("name,seconds,derived")
    out = {}
    for name, fn in benches.items():
        if args.only and name != args.only:
            continue
        out[name] = _timed(name, fn)
    return out


if __name__ == "__main__":
    main()
