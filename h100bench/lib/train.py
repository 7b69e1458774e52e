"""The training cell: the port's ``make_train_step`` (AdamW, the graph mix of
the per-task leaves) driven back to back on the cell's batches.

Set-up builds one step object over the model and its optimizer state, and
drives it from the seed's weights through its first ``checked_steps``
steps, each on its own batch; those steps are the check's (below) and warm
every shape. The window then runs steps on further batches, each uploaded
through the trainer's pinned path (``batch_to_device``), keeping at most
two steps in flight, until ``--seconds`` have passed; it ends when the last
step has finished on the device (a synchronization), and the rate is the
tokens of those steps over that time.

The check: the losses of the first steps, every leaf's gradient norm at
the first step (read from AdamW's first moment after it, m / (1 - b1)), and
every leaf's change after the checked steps, against the plain reference
(``reference/train.py``) from the same weights and batches, each by its
worst leaf.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np

from h100bench.lib import common, flops, trace, traffic, weights


def compare(prog: dict, ref: dict) -> dict:
    """The three compared numbers. A leaf's gap is |norm_prog - norm_ref|
    over the larger of its reference norm and the median leaf's; the
    change leaves out leaves whose reference gradient is under a thousandth
    of the median leaf's (nought to rounding: they move under Adam by
    round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))

    def worst(p, r, keep):
        med = float(np.median([r[k] for k in keep]))
        return max(abs(p[k] - r[k]) / max(r[k], med) for k in keep)

    g = ref["grad_norms"]
    med_g = float(np.median(list(g.values())))
    moved = [k for k in g if g[k] >= 1e-3 * med_g]
    return {"loss_rel": loss, "grad_rel": worst(prog["grad_norms"], g, list(g)),
            "change_rel": worst(prog["change_norms"], ref["change_norms"], moved),
            "left_out": sorted(set(g) - set(moved))}


def run(cell, seed: int, seconds: float, tracing: bool, device, rehearse: bool,
        control: bool = False) -> tuple[dict, dict]:
    import torch
    from repro_torch.core.distributed import GraphMultiTask
    from repro_torch.core.graph import TaskGraph
    from repro_torch.models.model import TransformerLM
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.trainer import batch_to_device, init_state, make_train_step

    from h100bench.reference import mixing
    from h100bench.reference import train as ref_train

    spec, mix = cell.spec, cell.traffic
    if rehearse:
        spec, mix = common.rehearsal(spec, mix)
    c = cell.arch(rehearse)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt_p = {**spec["optimizer"], "graph": {**spec["optimizer"]["graph"],
                                            "num_tasks": c["num_tasks"]}}
    g = opt_p["graph"]
    model = TransformerLM(common.arch_config(c), device=device, dtype=torch.float32, seed=0)
    weights.load_into(model, c, seed)
    opt = adamw(opt_p["lr"], b1=opt_p["b1"], b2=opt_p["b2"], eps=opt_p["eps"])
    gmt = GraphMultiTask(TaskGraph(mixing.band_adjacency(c["num_tasks"], g["bandwidth"])),
                         eta=g["eta"], tau=g["tau"])
    step = make_train_step(model, opt, gmt)
    state = init_state(model, opt)
    cell.mark("model and weights")
    stream = traffic.TrainStream(mix, seed, c["vocab_size"], c["num_tasks"])
    checked = spec["check"]["checked_steps"]
    pool = [stream.batch(i) for i in range(checked + spec["pool_batches"])]
    cell.mark("batches")
    losses = []
    for i in range(checked):
        state, met = step(state, batch_to_device(pool[i], device))
        losses.append(met["loss"])
        if i == 0:
            b1 = opt_p["b1"]
            grad_norms = {k: float(m.norm()) / (1 - b1) for k, m in state.opt_state.mu.items()}
    start = dict(weights.top(c, seed, device))
    change = {}
    with torch.no_grad():
        for i in range(-1, c["num_layers"]):
            part = start if i < 0 else weights.layer(c, seed, i, device)
            for k, v in part.items():
                change[k] = float((state.params[k] - v).norm())
            del part
    del start
    cell.mark("checked steps")
    prog = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change}
    tr = spec.get("trace", {})
    tracer = trace.Tracer(torch, tracing and device.type == "cuda", seconds,
                          min(tr.get("seconds", 3.0), 0.5 * seconds))
    tracer.warm()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - cell.t_start
    t0 = time.perf_counter()
    end = t0 + seconds
    steps, events, failed = 0, [], 0
    last_loss = met = batch = None
    while time.perf_counter() < end:
        tracer.poll(time.perf_counter() - t0)
        with tracer.range("step"):
            batch = batch_to_device(pool[checked + steps % spec["pool_batches"]], device)
            state, met = step(state, batch)
        last_loss = met["loss"]
        steps += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
            if len(events) > 2:
                events.pop(0).synchronize()
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    tracer.stop()
    if last_loss is not None and not bool(torch.isfinite(last_loss)):
        failed = 1
    dev = common.device_info(torch, device, cell.entry["chips"])
    b, s = mix["batch"], mix["seq"]
    run_rec = {"kind": "train", "arch": c, "spec": spec, "seconds": elapsed,
               "bench": cell.bench, "steps": steps, "tokens": steps * b * s,
               "work": {"ops": steps * flops.train_step_ops(c, b, s)},
               "trace": tracer.summary({}), "setup_s": setup_s, "device": device.type}
    del state, step, model, opt, met, last_loss, batch
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    blk = spec["check"]["rows_per_block"]
    ref = ref_train.run(c, opt_p, seed, device, pool[:checked], blk)
    readings = compare(prog, ref)
    print(f"leaves left out of the change: {readings['left_out']}", file=sys.stderr)
    lim = spec["check"]["limits"]
    checks = {k: {"value": readings[k], "limit": lim[k]} for k in lim}
    if control:
        ctl = compare(ref_train.run(c, opt_p, seed, device, pool[:checked], blk, tf32=True), ref)
        half = compare(ref_train.run(c, opt_p, seed, device, pool[:checked], blk,
                                     rows=slice(0, mix["batch"] // 2)), ref)
        for k in lim:
            checks[f"control_{k}"] = {"value": ctl[k], "limit": lim[k]}
            checks[f"half_batch_{k}"] = {"value": half[k], "limit": lim[k]}
    correct = all(readings[k] <= lim[k] for k in lim) and failed == 0
    return {"correct": bool(correct), "attempted": steps, "failed": failed,
            "run": run_rec, "device": dev}, checks
