"""Spawned ``torch.distributed`` ranks for the port's CPU tests (gloo).

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes
(``torch.multiprocessing``, spawn), each on one torch thread; they join a
gloo group (with ``device="cuda"``, NCCL, rank r on cuda:r) through a
``FileStore`` under ``tmp_path`` — never a fixed
port, so tests in parallel workers do not collide — and rank r returns
``fn(r, world, *args)``. The list of the ranks' results comes back; a rank
that raises fails the call with its traceback, and a run past ``timeout``
seconds is killed and fails. The rank programs of the tests live here, in a
module that imports no JAX, so a rank starts with torch and the port
alone."""
from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

TIMEOUT_S = 120


def _entry(rank, world, tmp, device, fn, args):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(rank, world, device=device,
                     store=dist.FileStore(os.path.join(tmp, "store"), world))
    try:
        out = {"ok": fn(rank, world, *args)}
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if "error" in out:
        raise RuntimeError(f"rank {rank} failed")
    dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = TIMEOUT_S,
              device: str = "cpu") -> list:
    import torch.multiprocessing as mp

    tmp = str(tmp_path)
    ctx = mp.start_processes(_entry, args=(world, tmp, device, fn, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
    except Exception as e:
        errors = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    errors += [f"rank {r}:\n{pickle.load(f).get('error', 'ok')}"]
        raise AssertionError(f"{fn.__name__} over {world} ranks: {e}\n" + "\n".join(errors))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f)["ok"])
    return results


# ------------------------------------------------------------ rank programs
def _np(t):
    return t.detach().cpu().numpy()


def solvers(rank, world, ref_path):
    """The collectives and the sharded solvers on the inputs the JAX
    reference used (``ref_path``, an npz): one task per rank."""
    import torch

    from repro_torch.core import SQUARED, MultiTaskProblem, band_graph
    from repro_torch.core.distributed import mix_all_gather, mix_ring, mixing_spec_for_band_graph
    from repro_torch.core.runners import bol_sharded, bsr_sharded

    ref = np.load(ref_path)
    out = {}
    if "mix_theta" in ref:
        g = band_graph(world, 2)
        mu = torch.as_tensor(g.bol_mixing(0.5, 2.0, 0.05), dtype=torch.float32)
        theta = torch.as_tensor(ref["mix_theta"])[rank:rank + 1]
        out["mix_all_gather"] = _np(mix_all_gather(theta, mu[:, rank]))
    for m, bw in ((world, 2), (world, 1)):
        key = f"ring_theta_{m}_{bw}"
        if key in ref:
            g = band_graph(m, bw)
            self_w, nbr = mixing_spec_for_band_graph(g, 0.5, 2.0, 0.04)
            theta = torch.as_tensor(ref[key])[rank:rank + 1]
            out[f"ring_{m}_{bw}"] = _np(mix_ring(theta, self_w, nbr))
    if "bol_x" in ref:
        p = MultiTaskProblem(band_graph(world, 2), SQUARED, 0.5, 1.5)
        x, y = ref["bol_x"], ref["bol_y"]
        out["bol_ring"] = _np(bol_sharded(p, x, y, 60, use_ring=True, device="cpu"))
        out["bol_all_gather"] = _np(bol_sharded(p, x, y, 60, use_ring=False, device="cpu"))
        out["bsr"] = _np(bsr_sharded(p, ref["bsr_x"], ref["bsr_y"], 80, device="cpu"))
    if "wrong_world_x" in ref:  # 2 * world tasks over the group: raises
        p = MultiTaskProblem(band_graph(2 * world, 1), SQUARED, 0.5, 1.5)
        try:
            bol_sharded(p, ref["wrong_world_x"], ref["wrong_world_y"], 2, device="cpu")
            out["wrong_world"] = None
        except ValueError as e:
            out["wrong_world"] = str(e)
    return out


def train_step(rank, world, ref_path, num_tasks):
    """One SGD step of the olmo_1b smoke model (``num_tasks`` tasks, the
    JAX weights and batch of ``ref_path``, a pickle) sharded over a 2 x 2 mesh on DTensors:
    the loss, the updated parameters as full tensors, and each task leaf's
    placements after the step."""
    import dataclasses

    import torch

    from repro_torch.configs import get
    from repro_torch.convert import load_numpy_params
    from repro_torch.core import GraphMultiTask, band_graph
    from repro_torch.launch.mesh import axes_of, make_smoke_mesh
    from repro_torch.models import TransformerLM
    from repro_torch.optim import sgd
    from repro_torch.sharding import full_params, shard_batch, shard_state, sharded_step
    from repro_torch.train import init_state, make_train_step

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    cfg = dataclasses.replace(get("olmo_1b", smoke=True), num_tasks=num_tasks)
    model = load_numpy_params(TransformerLM(cfg, device="cpu"), ref["params"])
    opt = sgd(1e-2)
    step = make_train_step(model, opt, GraphMultiTask(band_graph(num_tasks, 1), eta=0.1,
                                                      tau=1.0))
    mesh = make_smoke_mesh(device="cpu")
    axes = axes_of(mesh)
    state = shard_state(model, init_state(model, opt), mesh, axes)
    batch = {k: torch.as_tensor(ref[k]) for k in ("tokens", "labels", "task_ids")}
    state, metrics = sharded_step(model, step)(state, shard_batch(batch, mesh, axes))
    params = full_params(state.params)
    return {"loss": float(metrics["loss"]),
            "params": {k: _np(v) for k, v in params.items()},
            "placements": {k: repr(tuple(p.placements)) for k, p in state.params.items()}}
