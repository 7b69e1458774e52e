"""Shared scaffolding of the paper's experiments: the counterpart of the
reference's ``benchmarks/common.py``.

Every experiment runs on ``require_device(device)``: CUDA unless the caller
passes ``--device cpu`` (or ``device="cpu"``); without a GPU it raises. The
data is drawn with numpy exactly as in the reference, so one seed gives the
same tasks, graph and samples in both packages. Products are full float32
(``full_f32``: no TF32), as the reference's. Per-experiment CSVs go to
``build/reports/`` at the repo root, which git ignores.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import SQUARED, MultiTaskProblem, theory
from repro_torch.core.objective import local_ridge_solution
from repro_torch.data.synthetic import ClusteredTasks, generate_clustered_tasks
from repro_torch.kernels.runtime import require_device

# src/repro_torch/experiments/common.py -> repo root three levels above src/
REPORTS = Path(__file__).resolve().parents[3] / "build" / "reports"


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; without a GPU pass cpu)")


def full_f32() -> None:
    """Full float32 products, as the reference computes: no TF32 in cuBLAS
    or cuDNN (process-wide switches; the CPU ignores them)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def setup_problem(
    num_clusters: int,
    m: int = 100,
    d: int = 100,
    n: int = 500,
    seed: int = 0,
    lipschitz: float = 8.0,
    device=None,
):
    """Paper Appendix I setup: clustered tasks, 10-NN graph, Cor.2 (eta,tau).
    Returns (tasks, x, y, problem), x and y float32 on the device."""
    dev = require_device(device)
    rng = np.random.default_rng(seed)
    tasks = generate_clustered_tasks(
        rng, m=m, d=d, num_clusters=num_clusters, knn=min(10, m - 1)
    )
    x, y = tasks.sample(rng, n, device=dev)
    B, S = tasks.bs_constants()
    eta, tau = theory.corollary2_parameters(
        tasks.graph, B, max(S, 1e-2), lipschitz, n
    )
    problem = MultiTaskProblem(tasks.graph, SQUARED, eta, tau)
    return tasks, x, y, problem


def tune_local_reg(tasks: ClusteredTasks, x, y, regs=None) -> tuple[float, float]:
    """Tune the Local baseline's ridge parameter on exact population risk."""
    regs = regs or [10.0 ** e for e in range(-4, 2)]
    best = (None, np.inf)
    for r in regs:
        w = local_ridge_solution(x, y, r)
        risk = tasks.population_risk(w)
        if risk < best[1]:
            best = (r, risk)
    return best


def pop_risk_of_trace(tasks: ClusteredTasks, w_trace) -> list[float]:
    return [tasks.population_risk(w) for w in w_trace]


class Timer:
    """Wall seconds of a block; with ``device`` on CUDA, synchronized at
    both ends so that the block's device work is inside."""

    def __init__(self, device=None):
        self.device = device

    def __enter__(self):
        if self.device is not None:
            synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        if self.device is not None:
            synchronize(self.device)
        self.seconds = time.perf_counter() - self.t0


def write_csv(name: str, header: list[str], rows: list[list]):
    os.makedirs(REPORTS, exist_ok=True)
    path = os.path.join(REPORTS, name)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(str(v) for v in row) + "\n")
    return path
