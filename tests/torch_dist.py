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


def tp_batch(cfg, seed: int = 0, seq: int = 32) -> dict:
    """A (4, seq) batch of the tensor-parallel tests, two rows per task:
    (4, seq, K) tokens and labels for an audio model; a VLM's also carries
    vision rows (4, seq, d) at a seeded quarter of its positions."""
    import torch

    rng = np.random.default_rng(seed)
    lead = (4, seq) + ((cfg.num_codebooks,) if cfg.input_mode == "audio" else ())
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, lead, dtype=np.int64)),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, lead, dtype=np.int64)),
             "task_ids": torch.as_tensor(np.asarray([0, 0, 1, 1], np.int64))}
    if cfg.input_mode == "vlm":
        batch["vision_embeds"] = torch.as_tensor(
            rng.standard_normal((4, seq, cfg.d_model)).astype(np.float32))
        batch["vision_mask"] = torch.as_tensor(rng.random((4, seq)) < 0.25)
    return batch


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


def tp_step(rank, world, arch, opt_name, fsdp_gather_moe, params_path, overrides=None,
            mesh_shape=(2, 2), seq=32):
    """One step of ``arch``'s smoke model through ``sharding.sharded_step``
    on a ``mesh_shape`` (data, model) mesh (tensor-parallel) over a (4,
    ``seq``) batch, under the dry run's recorder: the loss, the updated
    parameters as full tensors, this rank's product FLOPs and
    collectives, and each parameter's fsdp-gathered local shape with the
    model axis' size."""
    from repro_torch.core import GraphMultiTask, band_graph
    from repro_torch.launch.dryrun import mesh_groups, record
    from repro_torch.launch.mesh import axes_of, make_smoke_mesh
    from repro_torch.sharding import full_params, shard_batch, shard_state, sharded_step
    from repro_torch.train import init_state, make_train_step

    cfg = tp_config(arch, fsdp_gather_moe, **(overrides or {}))
    model = tp_model(cfg, params_path)
    opt = tp_optimizer(opt_name)
    step = make_train_step(model, opt, GraphMultiTask(band_graph(2, 1), eta=0.1, tau=1.0))
    mesh = make_smoke_mesh(*mesh_shape, device="cpu")
    axes = axes_of(mesh)
    state = shard_state(model, init_state(model, opt), mesh, axes)
    batch = shard_batch(tp_batch(cfg, seq=seq), mesh, axes)
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
            "replicated": dict(rec.replicated), "gathered": gathered,
            "params": {k: _np(v) for k, v in full_params(state.params).items()}}


def tp_decode(rank, world, overrides, seq):
    """One decode_step of the olmo_1b smoke model (``overrides`` applied)
    on a 2 x 2 mesh: parameters in the rules' placements, gathered over
    fsdp, caches of ``seq`` rows in the cache rules' layout (kv heads on the
    model axis, or the sequence where they do not divide it), filled from a
    seed; the logits and the written caches as full arrays."""
    from repro_torch.launch.mesh import axes_of, make_smoke_mesh
    from repro_torch.sharding import shard_caches, shard_state, sharded_serving
    from repro_torch.train.trainer import TrainState

    cfg = tp_config("olmo_1b", attn_backend="plain", **(overrides or {}))
    model = tp_model(cfg)
    mesh = make_smoke_mesh(device="cpu")
    axes = axes_of(mesh)
    shard_state(model, TrainState(dict(model.named_parameters()), (), 0), mesh, axes)
    dcaches = shard_caches(cfg, tp_caches(model, seq), mesh, axes)
    batch, pos = tp_decode_inputs(cfg, seq)
    with sharded_serving(model):
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


# ------------------------------------------- the attention families' programs
SERVE_TICKS = 8  # greedy decode ticks after the prefill chunk


def tp_serve_inputs(cfg, batch_size: int, seq: int, chunk: int = 16, start=None, lens=None):
    """The serving run of the tensor-parallel tests: a (B, chunk) prefill
    chunk from per-slot positions ``start`` (rows of unequal valid length,
    ``lens``, a VLM's with vision rows at a few positions, an audio
    model's (B, C, K) codebook tokens) and the task ids; seeded."""
    import torch

    rng = np.random.default_rng(3)
    if start is None:
        start = [3, seq // 2 - 6, seq - chunk - SERVE_TICKS - 1, 0][:batch_size]
    lens = list(lens or [chunk, 10, chunk, 5])[:batch_size]
    lead = (batch_size, chunk) + ((cfg.num_codebooks,) if cfg.input_mode == "audio" else ())
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, lead)),
             "task_ids": torch.as_tensor(np.arange(batch_size) % 2)}
    if cfg.input_mode == "vlm":
        batch["vision_embeds"] = torch.as_tensor(
            rng.standard_normal((batch_size, chunk, cfg.d_model)).astype(np.float32))
        batch["vision_mask"] = torch.as_tensor(rng.random((batch_size, chunk)) < 0.3)
    valid = torch.as_tensor(np.arange(chunk)[None, :] < np.asarray(lens)[:, None])
    return batch, torch.as_tensor(np.asarray(start, np.int32)), valid


def tp_serve(model, caches, cfg, batch_size, seq, start=None, lens=None):
    """``prefill_step`` of ``tp_serve_inputs``'s chunk, then SERVE_TICKS
    greedy ``decode_step`` ticks (one lane dead on the third), on
    ``caches`` (plain, or DTensors under ``sharding.sharded_serving``: the
    inputs then join replicated). Returns the logits of every step as full
    (B, 1, K, V) or (B, 1, V) arrays, the greedy tokens, and the caches as
    arrays, after the prefill and at the end."""
    import torch

    def full(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return _np(t.reshape(t.shape[:2] + ((cfg.num_codebooks, cfg.vocab_size)
                                            if cfg.num_codebooks > 1 else (cfg.vocab_size,))))

    def arrays():  # copies: a CPU tensor's numpy() (or a full_tensor()) can alias the cache
        return [[_np(t.full_tensor() if hasattr(t, "full_tensor") else t).copy() for t in e]
                for e in caches]

    batch, pos, valid = tp_serve_inputs(cfg, batch_size, seq, start=start, lens=lens)
    logits, _ = model.prefill_step(batch, caches, pos, valid)
    out, toks, prefilled = [full(logits)], [], arrays()
    pos = pos + valid.sum(1).to(torch.int32)
    for tick in range(SERVE_TICKS):
        tok = torch.as_tensor(out[-1].argmax(-1))  # (B, 1) or (B, 1, K)
        toks.append(_np(tok))
        live = torch.ones(batch_size, dtype=torch.bool)
        if tick == 2:
            live[-1] = False
        step = {"tokens": tok, "task_ids": batch["task_ids"]}
        logits, _ = model.decode_step(step, caches, pos, live=live)
        out.append(full(logits))
        pos = pos + live.to(torch.int32)
    return {"logits": out, "tokens": toks, "prefill_caches": prefilled, "caches": arrays()}


def tp_serve_caches(model, batch_size, seq):
    """Seeded caches of ``model`` (B, seq): every row filled, so the rows
    the chunk and the ticks do not write hold keys too, and a recurrent
    layer's state is a state a run could reach (an sLSTM normalizer n >=
    1, the mamba conv tail in the model's dtype)."""
    import torch

    g = torch.Generator().manual_seed(1)
    out = []
    for kind, e in zip(model.kinds, model.init_cache(batch_size, seq)):
        e = [torch.randn(t.shape, generator=g).to(t.dtype) for t in e]
        if kind == "slstm":
            e[1] = e[1].abs() + 1.0
        out.append(tuple(e))
    return out


def tp_family(rank, world, arch, overrides, params_path, serve_cases, seq=1024):
    """The attention families' program on a 2 x 2 mesh: one SGD and one
    AdamW step of ``arch``'s smoke model (``overrides`` applied; the JAX
    weights of ``params_path``) through ``sharding.sharded_step``, the SGD
    one under the dry run's recorder; then, for each serving case
    (``{"batch": B, "start": [...] or None, **config overrides}``), the
    prefill chunk and the greedy ticks of ``tp_serve`` on DTensor caches in
    the cache rules' layout. Returns the steps' records (as ``tp_step``'s)
    and the serving runs with their caches' placements."""
    import dataclasses

    from repro_torch.launch.mesh import axes_of, make_smoke_mesh
    from repro_torch.sharding import shard_caches, shard_state, sharded_serving
    from repro_torch.sharding.tensor_parallel import local_rows
    from repro_torch.train.trainer import TrainState

    out = {"steps": {opt: tp_step(rank, world, arch, opt, False, params_path, overrides)
                     for opt in ("sgd", "adamw")}}
    mesh = make_smoke_mesh(device="cpu")
    axes = axes_of(mesh)
    out["serve"] = []
    for case in serve_cases:
        case = dict(case)
        b, start = case.pop("batch"), case.pop("start", None)
        cfg = dataclasses.replace(tp_config(arch, **(overrides or {})), attn_backend="plain",
                                  **case)
        model = tp_model(cfg, params_path)
        shard_state(model, TrainState(dict(model.named_parameters()), (), 0), mesh, axes)
        dcaches = shard_caches(cfg, tp_serve_caches(model, b, seq), mesh, axes)
        with sharded_serving(model):
            run = tp_serve(model, dcaches, cfg, b, seq, start=start)
        run["cache_placements"] = [repr(tuple(t.placements)) for t in dcaches[0]]
        run["cache_rows"] = local_rows(dcaches[0][0], 1)  # (rows here, the first's index)
        run["coordinate"] = list(mesh.get_coordinate())
        out["serve"].append(run)
    return out


# -------------------------------------------- the recurrent families' programs
def tp_recurrent(rank, world, arch, overrides, params_path, mesh_shape, serve_cases, seq=1024,
                 counted=(16, 32)):
    """The recurrent families' program on a ``mesh_shape`` (data, model)
    mesh: an SGD and an AdamW step of ``arch``'s smoke model (``overrides``
    applied; the JAX weights of ``params_path``) through
    ``sharding.sharded_step`` (and, for xLSTM, an SGD step under
    ``xlstm_parallel``), each under the dry run's recorder; the
    collectives of an SGD step at each sequence length of ``counted``;
    then, for each serving case (``{"batch": B, "lens": [...] or None,
    **config overrides}``), ``tp_serve``'s prefill and greedy ticks on
    DTensor caches in the cache rules' layout."""
    import dataclasses

    from repro_torch.launch.mesh import axes_of, make_smoke_mesh
    from repro_torch.sharding import shard_caches, shard_state, sharded_serving
    from repro_torch.train.trainer import TrainState

    ov = dict(overrides or {})
    steps = {opt: tp_step(rank, world, arch, opt, False, params_path, ov, mesh_shape)
             for opt in ("sgd", "adamw")}
    if arch == "xlstm_350m":
        steps["sgd_parallel"] = tp_step(rank, world, arch, "sgd", False, params_path,
                                        dict(ov, xlstm_parallel=True), mesh_shape)
    out = {"steps": steps, "counted": {
        t: tp_step(rank, world, arch, "sgd", False, params_path, ov, mesh_shape,
                   seq=t)["collectives"] for t in counted}}
    mesh = make_smoke_mesh(*mesh_shape, device="cpu")
    axes = axes_of(mesh)
    out["serve"] = []
    for case in serve_cases:
        case = dict(case)
        b, lens = case.pop("batch"), case.pop("lens", None)
        cfg = dataclasses.replace(tp_config(arch, **ov), attn_backend="plain", **case)
        model = tp_model(cfg, params_path)
        shard_state(model, TrainState(dict(model.named_parameters()), (), 0), mesh, axes)
        dcaches = shard_caches(cfg, tp_serve_caches(model, b, seq), mesh, axes)
        with sharded_serving(model):
            run = tp_serve(model, dcaches, cfg, b, seq, lens=lens)
        run["cache_placements"] = [[repr(tuple(t.placements)) for t in e] for e in dcaches]
        out["serve"].append(run)
    return out


# ------------------------------------ mixed stacks and the uneven layouts
def tp_cases(rank, world, cases, mesh_shape, seq=1024):
    """Each case (``{"arch", "overrides", "params_path" or None, "serve":
    [B, lens] or None[, "replicated_caches": True]}``) on a ``mesh_shape``
    (data, model) mesh: an SGD step through ``sharding.sharded_step`` under
    the dry run's recorder (``tp_step``'s record: loss, parameters, the
    replicated layouts the recorder was told of), and, with ``serve``,
    ``tp_serve``'s prefill and greedy ticks on DTensor caches in the cache
    rules' layout (or replicated) under a recorder too."""
    import dataclasses

    from repro_torch.launch.dryrun import mesh_groups, record
    from repro_torch.launch.mesh import axes_of, make_smoke_mesh
    from repro_torch.sharding import shard_caches, shard_state, sharded_serving
    from repro_torch.train.trainer import TrainState

    mesh = make_smoke_mesh(*mesh_shape, device="cpu")
    axes = axes_of(mesh)
    out = []
    for case in cases:
        ov = dict(case["overrides"])
        rec = {"step": tp_step(rank, world, case["arch"], "sgd", False, case["params_path"],
                               ov, mesh_shape)}
        if case["serve"] is not None:
            b, lens = case["serve"]
            cfg = dataclasses.replace(tp_config(case["arch"], **ov), attn_backend="plain")
            model = tp_model(cfg, case["params_path"])
            shard_state(model, TrainState(dict(model.named_parameters()), (), 0), mesh, axes)
            caches = tp_serve_caches(model, b, seq)
            if case.get("replicated_caches"):  # every cache whole on every rank
                from torch.distributed.tensor import Replicate, distribute_tensor

                dcaches = [tuple(distribute_tensor(t, mesh, [Replicate()] * mesh.ndim)
                                 for t in e) for e in caches]
            else:
                dcaches = shard_caches(cfg, caches, mesh, axes)

            def serve():
                with sharded_serving(model):
                    return tp_serve(model, dcaches, cfg, b, seq, lens=lens)

            run, _, r = record(serve, (), mesh_groups(mesh))
            run["replicated"] = dict(r.replicated)
            run["cache_placements"] = [[repr(tuple(t.placements)) for t in e] for e in dcaches]
            rec["serve"] = run
        out.append(rec)
    return out
