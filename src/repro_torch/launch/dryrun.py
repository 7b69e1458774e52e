"""Dry run of the sharded programs: the port of ``repro.launch.dryrun``.

Every (architecture x input shape x mesh) combination runs its sharded
program once on the production mesh — 16 x 16, or 2 x 16 x 16 with
``--multi-pod`` — in ONE process, with no device: a ``fake`` process group
(``launch.mesh.make_fake_mesh``) whose collectives move nothing, and
DTensors of ``meta`` tensors (``TransformerLM(cfg, device="meta")``, the
inputs of ``launch.specs.input_specs``, the caches of ``init_cache``)
carrying each rank's shard shapes. The program is the port's own: the
train step of ``repro_torch.sharding.sharded_step`` (FSDP x TP), or the
serving steps on the same fsdp-gathered, model-split weights. A run that
finishes shows that the rules' placements and the in-forward constraints
carry through the whole program; what rank 0 ran gives, per device:

  * ``memory`` — ``argument_bytes``: the local shards of the state (params
    and optimizer moments; the step counter is a host int), the batch and
    the caches; ``temp_bytes``: the peak of the bytes the call allocated
    and still held (every fresh op output, held until its storage dies:
    activations, saved tensors, gradients, gathered weights, collective
    buffers); ``output_bytes`` / ``alias_bytes``: the local bytes of what
    the call returns, and of those the ones it wrote in place into its
    arguments (the updated state, the caches).
  * ``cost`` — ``flops``: the products' FLOPs (mm, bmm, addmm, ...) with
    ``torch.utils.flop_counter``'s formulas (those of ``FlopCounterMode``)
    on the LOCAL ops each rank runs. ``FlopCounterMode`` itself sees a
    DTensor op once, at its global shapes, before DTensor picks its local
    ops; the recorder (``Recorder``) lets DTensor dispatch and counts the
    local ops it then runs, so nothing is divided and replicated work is
    counted on every rank that does it. ``bytes_accessed``: every non-view
    local op's tensor inputs and outputs, as an eager program moves them
    (no fusion).
  * ``collectives`` — every ``_c10d_functional`` op of the call: per kind,
    ``count``, ``result_bytes`` and ``wire_bytes`` with the reference's
    ring formulas (``wire_bytes``), over the op's own group size, and
    ``total_wire_bytes``; beside them, ``wire_bytes_by_group``: the ring
    wire bytes by the size of the group they cross (``launch.roofline``
    prices groups of up to 8 ranks over NVLink, larger ones over the
    network).
  * ``replicated`` — the mixers that ran replicated over the model ranks
    because their split does not divide them (Mamba2 heads, an mLSTM head
    width, MLA serving heads: ``sharding.tensor_parallel.note_replicated``),
    counted per call; empty on the reference's meshes.

Probes (``--probes``) run the same combination at ``num_layers = period *
n`` for n = 1, 2 (``probe_cfg``). The eager step has no scan that counts a
loop body once, so here every number is already exact at full depth and
the probes are exact per-period differences: total = probe1 + (P - 1) *
(probe2 - probe1) for FLOPs and collective counts. They are kept for
``benchmarks/roofline.py``'s extrapolation.

Per-combination config edits, as the reference's ``run_one``: ``num_tasks``
= ``moe_groups`` = the fsdp size (shard-local MoE dispatch per data
shard), ``activation_sharding`` = (batch axis, None, model) (``--act-shard``:
("data", None, "model")), ``logits_sharding`` = (batch axis, None, model);
the model in bfloat16, as the reference's; attention through the plain
backend (the CUDA kernels run on the card only).

Scope: ``TP_ARCHS``, every arch of the reference's dry run (all but
``multitask_linreg``), whose forward runs tensor-parallel
(``sharding.check_tensor_parallel``: dense, Mixtral, DeepSeek-V2's MLA,
Pixtral, MusicGen, Zamba2's Mamba2 hybrid, xLSTM), at the reference's
shapes (``applicable_shapes``): train_4k, prefill_32k and decode_32k, and
long_500k for a ``long_context_ok`` arch (Mixtral, Zamba2, xLSTM): 36
combinations a mesh. prefill_32k runs ``prefill_step`` over the
``cache_specs`` caches in ``q_chunk``-token chunks; decode_32k one
``decode_step`` token against a 32768-token cache, long_500k against a
524288-token one (batch 1: the rules split an attention cache's sequence
over the data dims, and over the model dim too where its kv heads do not
divide it). ``--mla-cache`` picks an MLA cache's rule (``lora``, the
default: its latent on the model axis; ``replicate``; ``seq``: its
sequence there).

xLSTM's train_4k and prefill_32k are extrapolated in time
(``account_in_time``): its cells run one step per token, and on ``meta``
tensors each step's ops cost ~0.3 ms apiece on the host, so the program
runs at two short lengths (``TIME_PROBES``; prefill also at two calls) and
every count is carried exactly to the shape's length; the JSON says so
(``"time_extrapolated": {"from": [8, 16], "to": 4096, ...}``). Zamba2 runs
directly (its SSD loops once per 128-token chunk).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo_1b --shape decode_32k --out DIR
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--probes] [--act-shard] --out DIR
  python -m repro_torch.launch.dryrun --arch deepseek_v2_236b --shape decode_32k \
      --mla-cache seq --out DIR
Results go to DIR/<singlepod|multipod>/<arch>__<shape>.json (DIR defaults
to build/dryrun). The CLI exits 1 if any combination fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get
from repro_torch.configs.base import ArchConfig
from repro_torch.core import GraphMultiTask, band_graph
from repro_torch.launch.mesh import axes_of, make_fake_mesh
from repro_torch.launch.specs import INPUT_SHAPES, InputShape, input_specs
from repro_torch.models import TransformerLM
from repro_torch.optim import adamw
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding import (
    check_tensor_parallel,
    shard_batch,
    shard_caches,
    shard_state,
    sharded_serving,
    sharded_step,
)
from repro_torch.train import init_state, make_train_step
from repro_torch.train.trainer import TrainState

TP_ARCHS = ("olmo_1b", "qwen2_5_14b", "qwen1_5_110b", "phi4_mini_3_8b", "multitask_lm",
            "mixtral_8x22b", "deepseek_v2_236b", "pixtral_12b", "musicgen_large",
            "zamba2_7b", "xlstm_350m")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
LONG_SHAPE = "long_500k"
MLA_CACHE = {"lora": {}, "replicate": {"mla_replicate_cache": True},
             "seq": {"mla_cache_seq_shard": True}}
DEFAULT_OUT = os.path.join("build", "dryrun")

_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


TIME_PROBES = (8, 16)  # the short lengths of an xLSTM sequence shape's time extrapolation


def applicable_shapes(arch: str) -> list[str]:
    """The input shapes the dry run covers for ``arch``, the reference's:
    every shape but long_500k, which only a ``long_context_ok`` arch runs;
    raises ``NotImplementedError`` outside ``TP_ARCHS`` (every arch of the
    reference's dry run)."""
    if arch not in TP_ARCHS:
        raise NotImplementedError(f"{arch}: the dry run covers {TP_ARCHS}, the reference "
                                  "dry run's archs")
    return list(SHAPES) + ([LONG_SHAPE] if get(arch).long_context_ok else [])


def wire_bytes(kind: str, size: int, g: int) -> int:
    """The reference's per-device ring estimate for a collective whose
    result is ``size`` bytes over a group of ``g``."""
    if kind == "all-gather":
        return size * (g - 1) // g
    if kind == "all-reduce":
        return 2 * size * (g - 1) // g
    if kind == "reduce-scatter":
        return size * (g - 1)  # the result is the scattered shard
    if kind == "all-to-all":
        return size * (g - 1) // g
    return size  # collective-permute


def wire_by_group(records) -> dict:
    """The ring wire bytes of a ``Recorder``'s collective records by the
    size of their group: {str(group size): bytes}."""
    out: dict = {}
    for rec in records:
        key = str(rec["group_size"])
        out[key] = out.get(key, 0) + wire_bytes(rec["kind"], rec["bytes"], rec["group_size"])
    return out


def summarize(records) -> dict:
    """Per-kind ``count`` / ``result_bytes`` / ``wire_bytes`` and
    ``total_wire_bytes`` of a ``Recorder``'s collective records (their
    split by group size: ``wire_by_group``)."""
    stats: dict = {}
    for rec in records:
        s = stats.setdefault(rec["kind"], {"count": 0, "result_bytes": 0, "wire_bytes": 0})
        s["count"] += 1
        s["result_bytes"] += rec["bytes"]
        s["wire_bytes"] += wire_bytes(rec["kind"], rec["bytes"], rec["group_size"])
    stats["total_wire_bytes"] = sum(v["wire_bytes"] for v in stats.values())
    return stats


def _local(t):
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list[torch.Tensor]:
    """The local tensors of a tree's tensor leaves (a DTensor's shard)."""
    return [_local(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storages(tree) -> dict[int, int]:
    """id -> bytes of the distinct storages of a tree's local tensors (ids
    valid while the tensors live)."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in _tensors(tree)}


class Recorder(TorchDispatchMode):
    """Counts what the local ops of a call do on this rank: FLOPs
    (``flop_registry``), bytes accessed, collectives, and the bytes of
    fresh storages alive (``live``) and at their peak (``peak``). A DTensor
    op is passed on (``NotImplemented``): DTensor dispatches it, and the
    local ops it runs come back through the recorder.

    groups: process-group name -> (mesh axis name, group size)."""

    def __init__(self, groups: dict):
        super().__init__()
        self.groups = groups
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: list[dict] = []
        self.live = 0
        self.peak = 0
        self._held: set[int] = set()
        self.replicated: dict[str, int] = {}

    def _note(self, what: str):
        self.replicated[what] = self.replicated.get(what, 0) + 1

    def __enter__(self):
        tp.REPLICATED_LISTENERS.append(self._note)
        return super().__enter__()

    def __exit__(self, *exc):
        tp.REPLICATED_LISTENERS.remove(self._note)
        return super().__exit__(*exc)

    def _free(self, key: int, n: int):
        self._held.discard(key)
        self.live -= n

    def _hold(self, t: torch.Tensor, inputs: set[int]):
        st = t.untyped_storage()
        key = id(st)
        if key in self._held or key in inputs:
            return
        n = st.nbytes()
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _group(self, args) -> tuple[str, int]:
        name = [a for a in args if isinstance(a, str)][-1]
        if name in self.groups:
            return self.groups[name]
        from torch.distributed.distributed_c10d import _resolve_process_group

        return "?", _resolve_process_group(name).size()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # DTensor's propagation of global shapes: not the program
        in_st = {id(a.untyped_storage()) for a in ins}
        view = not func._schema.is_mutable and any(id(o.untyped_storage()) in in_st
                                                   for o in outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not view:
            self.bytes_accessed += sum(a.numel() * a.element_size() for a in ins + outs)
            for o in outs:
                self._hold(o, in_st)
        if func.namespace == "_c10d_functional" and packet.__name__ in _KINDS:
            axis, g = self._group(args)
            o = outs[0]
            self.collectives.append({"kind": _KINDS[packet.__name__], "axis": axis,
                                     "group_size": g, "shape": tuple(o.shape),
                                     "bytes": o.numel() * o.element_size()})
        return out


def mesh_groups(mesh) -> dict:
    """Process-group name -> (mesh axis name, size) of each mesh dim."""
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        g = mesh.get_group(i)
        out[g.group_name] = (name, g.size())
    return out


def record(fn, args, groups) -> tuple[object, dict, Recorder]:
    """Run ``fn()`` under a ``Recorder``; ``args``: the tensors that count
    as the call's arguments. Returns (fn's result, the dry run's
    ``memory`` / ``cost`` / ``collectives`` / ``run_s`` record, the
    recorder)."""
    arg = _storages(list(args))
    rec = Recorder(groups)
    t0 = time.perf_counter()
    with rec:
        result = fn()
    secs = time.perf_counter() - t0
    out = _storages(result)
    summary = {
        "run_s": secs,
        "memory": {"argument_bytes": sum(arg.values()), "output_bytes": sum(out.values()),
                   "temp_bytes": rec.peak,
                   "alias_bytes": sum(n for k, n in out.items() if k in arg)},
        "cost": {"flops": rec.flops, "bytes_accessed": rec.bytes_accessed},
        "collectives": summarize(rec.collectives),
        "wire_bytes_by_group": wire_by_group(rec.collectives),
        "replicated": dict(rec.replicated),
    }
    return result, summary, rec


def prepare(cfg: ArchConfig, shape: InputShape, mesh, dtype=torch.bfloat16,
            microbatches: int = 1):
    """(fn, args) of one combination on ``mesh``: ``fn()`` runs the sharded
    program; ``args`` are its arguments (for the byte counts). A train
    step accumulates its gradient over ``microbatches`` slices of the batch
    (``make_train_step``'s; the reference's hill-climb lever)."""
    check_tensor_parallel(cfg)
    axes = axes_of(mesh)
    model = TransformerLM(cfg, device="meta", dtype=dtype)
    batch = shard_batch(input_specs(cfg, shape), mesh, axes)
    if shape.kind == "train":
        opt = adamw(3e-4)
        step = make_train_step(model, opt, GraphMultiTask(band_graph(cfg.num_tasks, 1),
                                                          eta=0.1, tau=1.0),
                               microbatches=microbatches)
        state = shard_state(model, init_state(model, opt), mesh, axes)
        run = sharded_step(model, step)
        return (lambda: run(state, batch)), (state.params, state.opt_state, batch)

    shard_state(model, TrainState(dict(model.named_parameters()), (), 0), mesh, axes)
    params = dict(model.named_parameters())
    b, seq = shape.global_batch, shape.seq_len
    caches = model.init_cache(b, seq)
    caches = shard_caches(cfg, caches, mesh, axes)
    if shape.kind == "prefill":
        chunk = min(cfg.q_chunk, seq)

        def fn():
            with sharded_serving(model):
                for i in range(0, seq, chunk):
                    # every (B, S, ...) input: tokens, a VLM's vision rows
                    sub = {k: (v[:, i:i + chunk] if v.ndim >= 2 else v)
                           for k, v in batch.items()}
                    pos = torch.full((b,), i, dtype=torch.int32, device="meta")
                    valid = torch.ones((b, chunk), dtype=torch.bool, device="meta")
                    logits, _ = model.prefill_step(sub, caches, pos, valid)
            return logits, caches

        return fn, (params, batch, caches)
    pos = torch.full((), seq - 1, dtype=torch.int32, device="meta")

    def fn():
        with sharded_serving(model):
            return model.decode_step(batch, caches, pos)

    return fn, (params, batch, caches, pos)


def account(cfg: ArchConfig, shape: InputShape, mesh, dtype=torch.bfloat16,
            microbatches: int = 1) -> dict:
    """The dry run's record of one combination on ``mesh`` (see the module
    docstring); an xLSTM sequence shape's through ``account_in_time``."""
    if time_extrapolated(cfg, shape):
        return account_in_time(cfg, shape, mesh, dtype, microbatches=microbatches)
    fn, args = prepare(cfg, shape, mesh, dtype, microbatches)
    _, summary, _ = record(fn, args, mesh_groups(mesh))
    return summary


def time_extrapolated(cfg: ArchConfig, shape: InputShape) -> bool:
    """Whether the combination's record is extrapolated in time: a
    sequence shape (train, prefill) of a model of xLSTM layers only, whose
    cells run one step per token as Python loops (on ``meta`` tensors a
    step's ops cost ~0.3 ms each on the host: train_4k directly would take
    hours)."""
    return shape.kind != "decode" and all(k in ("mlstm", "slstm") for k in cfg.layer_kinds())


def _nums(f, *records):
    """``f`` applied to the numbers at each place of same-shaped records
    (nested dicts; a key one lacks counts as zero there)."""
    if any(isinstance(r, dict) for r in records):
        keys = set().union(*(r for r in records if isinstance(r, dict)))
        sub = next(r for r in records if isinstance(r, dict))
        zero = {} if isinstance(next(iter(sub.values()), 0), dict) else 0
        return {k: _nums(f, *(r.get(k, zero) if isinstance(r, dict) else r for r in records))
                for k in keys}
    return f(*records)


def _exact(num: int, den: int) -> int:
    if num % den:
        raise ValueError(f"time extrapolation: {num} / {den} is not exact")
    return num // den


def account_in_time(cfg: ArchConfig, shape: InputShape, mesh, dtype=torch.bfloat16,
                    probes: tuple[int, int] = TIME_PROBES, microbatches: int = 1) -> dict:
    """``account`` of an xLSTM sequence shape from runs at the short
    lengths ``probes`` = (c1, c2), extrapolated exactly to the shape: every
    op of an xLSTM layer is per token or per call, so a call's FLOPs,
    bytes accessed and collectives (counts and bytes) are a + b tokens —
    the port's counterpart of the reference's probe1 + (P - 1) (probe2 -
    probe1) over depth.

      * Train (one call of seq_len tokens): runs A (c1 tokens) and C (c2),
        every number on the line through them at seq_len.
      * Prefill (seq_len / q_chunk calls of q_chunk tokens inside one
        ``sharded_serving``, whose fsdp gathers happen once a run): A (one
        call of c1), B (two calls of c1) and C (one call of c2). A call of
        c tokens costs (B - A) + (c - c1) (C - A) / (c2 - c1), the run's
        own part is 2 A - B, and cost and collectives are that part plus
        the calls'; temp bytes are a call's peak on the A-C line plus what
        a later call holds of the one before (B - A); output and alias
        bytes a call's.

    Argument bytes (the batch holds every token) lie on the A-C line at
    seq_len. The record says so (``time_extrapolated``); ``run_s`` is the
    runs' host seconds."""
    c1, c2 = probes
    prefill = shape.kind == "prefill"
    chunk = min(cfg.q_chunk, shape.seq_len) if prefill else shape.seq_len
    calls = shape.seq_len // chunk

    def run(seq, per_call):
        fn, args = prepare(dataclasses.replace(cfg, q_chunk=per_call),
                           dataclasses.replace(shape, seq_len=seq), mesh, dtype, microbatches)
        return record(fn, args, mesh_groups(mesh))[1]

    def line(x):  # A-C line at x
        return lambda a, c: a + _exact((x - c1) * (c - a), c2 - c1)

    ra, rc = run(c1, c1), run(c2, c2)
    out = {"run_s": ra["run_s"] + rc["run_s"],
           "time_extrapolated": {"from": list(probes), "to": shape.seq_len, "calls": calls,
                                 "tokens_a_call": chunk}}
    if not prefill:
        out.update({k: _nums(line(chunk), ra[k], rc[k]) for k in
                    ("memory", "cost", "collectives", "wire_bytes_by_group", "replicated")})
        return out
    rb = run(2 * c1, c1)
    out["run_s"] += rb["run_s"]
    for k in ("cost", "collectives", "wire_bytes_by_group", "replicated"):
        out[k] = _nums(lambda a, b, c: 2 * a - b + calls * (b - a + line(chunk)(0, c - a)),
                       ra[k], rb[k], rc[k])
    mem = _nums(line(chunk), ra["memory"], rc["memory"])
    if calls > 1:
        mem["temp_bytes"] += rb["memory"]["temp_bytes"] - ra["memory"]["temp_bytes"]
    mem["argument_bytes"] = line(shape.seq_len)(ra["memory"]["argument_bytes"],
                                                rc["memory"]["argument_bytes"])
    out["memory"] = mem
    return out


def probe_cfg(cfg: ArchConfig, periods: int) -> ArchConfig:
    """The same model at ``periods`` periods of its pattern."""
    return dataclasses.replace(cfg, num_layers=cfg.period * periods)


def combo_cfg(arch: str, shape: InputShape, axes, activation_sharding=None,
              mla_cache: str = "lora") -> ArchConfig:
    """The reference's per-combination config edits (``run_one``), and an
    MLA cache's rule (``MLA_CACHE``)."""
    fsdp = tuple(axes.fsdp) if len(axes.fsdp) > 1 else axes.fsdp[0]
    batch_ax = fsdp if shape.global_batch % axes.fsdp_size == 0 else None
    if activation_sharding is None:
        activation_sharding = (batch_ax, None, axes.model)
    return dataclasses.replace(
        get(arch), num_tasks=axes.fsdp_size, moe_groups=axes.fsdp_size,
        activation_sharding=activation_sharding,
        logits_sharding=(batch_ax, None, axes.model), attn_backend="plain",
        **MLA_CACHE[mla_cache])


def run_one(arch: str, shape_name: str, multi_pod: bool, probes: bool, out_dir: str | None,
            activation_sharding=None, mla_cache: str = "lora") -> dict:
    """One combination (and its probes); written to
    ``out_dir/<arch>__<shape>.json`` (``<arch>__<shape>__<mla_cache>.json``
    for another MLA cache rule) unless ``out_dir`` is None."""
    if shape_name not in applicable_shapes(arch):
        raise NotImplementedError(f"{arch} {shape_name}: the dry run covers "
                                  f"{applicable_shapes(arch)} (long_500k: a long_context_ok "
                                  "arch only, as the reference's)")
    shape = INPUT_SHAPES[shape_name]
    mesh = make_fake_mesh(multi_pod)
    cfg = combo_cfg(arch, shape, axes_of(mesh), activation_sharding, mla_cache)
    result = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
              "num_layers": cfg.num_layers, "period": cfg.period,
              "num_periods": cfg.num_periods, "remainder": len(cfg.remainder)}
    if cfg.use_mla:
        result["mla_cache"] = mla_cache
    result["scanned"] = account(cfg, shape, mesh)
    if probes:
        for n in (1, 2):
            result[f"probe{n}"] = account(probe_cfg(cfg, n), shape, mesh)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        tag = "" if mla_cache == "lora" else f"__{mla_cache}"
        with open(os.path.join(out_dir, f"{arch}__{shape_name}{tag}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--act-shard", action="store_true",
                    help="constrain the residual stream to (data, None, model)")
    ap.add_argument("--mla-cache", default="lora", choices=list(MLA_CACHE),
                    help="an MLA cache's rule: its latent on the model axis, replicated, "
                         "or its sequence there")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    mesh_name = "multipod" if args.multi_pod else "singlepod"
    out_dir = os.path.join(args.out, mesh_name)
    act = ("data", None, "model") if args.act_shard else None
    if args.all:
        combos = [(a, s) for a in TP_ARCHS for s in applicable_shapes(a)]
    else:
        combos = [(args.arch, args.shape)]

    ok, failed = 0, []
    for a, s in combos:
        try:
            r = run_one(a, s, args.multi_pod, args.probes, out_dir, activation_sharding=act,
                        mla_cache=args.mla_cache)
            sc = r["scanned"]
            tot = sum(v or 0 for v in sc["memory"].values())
            print(f"OK   {a:22s} {s:12s} mesh={r['mesh']:8s} run={sc['run_s']:7.1f}s "
                  f"mem/device={tot / 2**30:7.2f} GiB flops={sc['cost']['flops']:.3e} "
                  f"coll={sc['collectives']['total_wire_bytes'] / 2**20:9.1f} MiB", flush=True)
            ok += 1
        except Exception as e:  # report every combination, then fail the CLI
            print(f"FAIL {a:22s} {s:12s}: {e}", flush=True)
            traceback.print_exc()
            failed.append((a, s, str(e)))
    print(f"\n{ok}/{len(combos)} combinations ran on mesh {mesh_name}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
