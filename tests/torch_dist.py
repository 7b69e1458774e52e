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


TP_SPEC = ("data", None, "model")


def tp_config(arch: str, fsdp_gather_moe: bool = False, **overrides):
    """The smoke config of ``arch`` for the 2 x 2 tensor-parallel tests:
    two tasks, one MoE dispatch group per data rank, the residual stream
    and the logits constrained to (data, None, model); ``overrides``: other
    fields (e.g. a head count the model ranks do not divide)."""
    import dataclasses

    from repro_torch.configs import get

    return dataclasses.replace(get(arch, smoke=True), num_tasks=2, moe_groups=2,
                               fsdp_gather_moe=fsdp_gather_moe, activation_sharding=TP_SPEC,
                               logits_sharding=TP_SPEC, **overrides)


def tp_batch(cfg, seed: int = 0) -> dict:
    """A (4, 32) batch of the tensor-parallel tests, two rows per task."""
    import torch

    rng = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int64)),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int64)),
            "task_ids": torch.as_tensor(np.asarray([0, 0, 1, 1], np.int64))}


def tp_model(cfg, params_path=None):
    """The model of the tensor-parallel tests on the CPU: seed 0, or the
    JAX weights pickled at ``params_path``."""
    from repro_torch.convert import load_numpy_params
    from repro_torch.models import TransformerLM

    model = TransformerLM(cfg, device="cpu", seed=0)
    if params_path is not None:
        with open(params_path, "rb") as f:
            model = load_numpy_params(model, pickle.load(f))
    return model


def tp_optimizer(name: str):
    from repro_torch.optim import adamw, sgd

    return sgd(1e-2) if name == "sgd" else adamw(3e-4)


def tp_step(rank, world, arch, opt_name, fsdp_gather_moe, params_path, overrides=None):
    """One step of ``arch``'s smoke model through ``sharding.sharded_step``
    on a 2 x 2 mesh (tensor-parallel), under the dry run's recorder: the
    loss, the updated parameters as full tensors, this rank's product
    FLOPs and collectives, and each parameter's fsdp-gathered local shape
    with the model axis' size."""
    from repro_torch.core import GraphMultiTask, band_graph
    from repro_torch.launch.dryrun import mesh_groups, record
    from repro_torch.launch.mesh import axes_of, make_smoke_mesh
    from repro_torch.sharding import full_params, shard_batch, shard_state, sharded_step
    from repro_torch.train import init_state, make_train_step

    cfg = tp_config(arch, fsdp_gather_moe, **(overrides or {}))
    model = tp_model(cfg, params_path)
    opt = tp_optimizer(opt_name)
    step = make_train_step(model, opt, GraphMultiTask(band_graph(2, 1), eta=0.1, tau=1.0))
    mesh = make_smoke_mesh(device="cpu")
    axes = axes_of(mesh)
    state = shard_state(model, init_state(model, opt), mesh, axes)
    batch = shard_batch(tp_batch(cfg), mesh, axes)
    run = sharded_step(model, step)
    (state, metrics), _, rec = record(lambda: run(state, batch), (state, batch),
                                      mesh_groups(mesh))
    gathered = {}
    for k, p in state.params.items():
        shape = list(p.to_local().shape)
        for i, pl in enumerate(p.placements):
            if mesh.mesh_dim_names[i] != "model" and pl.is_shard():
                shape[pl.dim] = p.shape[pl.dim]
        gathered[k] = (tuple(p.shape), tuple(shape))
    return {"loss": float(metrics["loss"]), "flops": rec.flops,
            "collectives": [(c["kind"], c["axis"], c["shape"]) for c in rec.collectives],
            "gathered": gathered,
            "params": {k: _np(v) for k, v in full_params(state.params).items()}}


def tp_decode(rank, world, overrides, seq):
    """One decode_step of the olmo_1b smoke model (``overrides`` applied)
    on a 2 x 2 mesh: parameters in the rules' placements, gathered over
    fsdp, caches of ``seq`` rows in the cache rules' layout (kv heads on the
    model axis, or the sequence where they do not divide it), filled from a
    seed; the logits and the written caches as full arrays."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import axes_of, make_smoke_mesh
    from repro_torch.sharding import cache_specs, fsdp_gathered, placements, shard_state
    from repro_torch.train.trainer import TrainState

    cfg = tp_config("olmo_1b", **(overrides or {}))
    model = tp_model(cfg)
    mesh = make_smoke_mesh(device="cpu")
    axes = axes_of(mesh)
    caches = tp_caches(model, seq)
    specs = cache_specs(cfg, caches, axes)
    shard_state(model, TrainState(dict(model.named_parameters()), (), 0), mesh, axes)
    dcaches = [tuple(distribute_tensor(t, mesh, placements(sp, mesh)) for t, sp in zip(e, es))
               for e, es in zip(caches, specs)]
    batch, pos = tp_decode_inputs(cfg, seq)
    with fsdp_gathered(model), implicit_replication():
        logits, _ = model.decode_step(batch, dcaches, pos)
    return {"logits": _np(logits.full_tensor()),
            "caches": [[_np(t.full_tensor()) for t in e] for e in dcaches],
            "cache_placements": [repr(tuple(t.placements)) for t in dcaches[0]]}


def tp_caches(model, seq):
    """Seeded (B=4, seq) caches of ``model``."""
    import torch

    g = torch.Generator().manual_seed(1)
    return [tuple(torch.randn(t.shape, generator=g) for t in e) for e in model.init_cache(4, seq)]


def tp_decode_inputs(cfg, seq):
    import torch

    rng = np.random.default_rng(2)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 1))),
             "task_ids": torch.as_tensor(np.asarray([0, 1, 1, 0]))}
    return batch, torch.as_tensor(np.asarray([3, seq // 2 + 5, seq - 1, 0], np.int32))
