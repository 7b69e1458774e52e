"""Hill-climb driver: the dry run (``launch.dryrun``) of one (arch, shape)
on the production mesh (``launch.mesh.make_fake_mesh``: 16 x 16, or 2 x 16
x 16 with ``--multi-pod``) with the reference's optimization levers, its
record priced by ``launch.roofline``.

Levers (all off by default: the dry run's own configuration):
  --xlstm-chunk N        rematerialize xLSTM's time loop in chunks of N
  --xlstm-parallel       the chunkwise-parallel mLSTM in training
  --moe-gather           regather MoE expert weights with only their ff dim
                         on the model axis (``fsdp_gather_moe``)
  --microbatch N         accumulate a train step's gradient over N
                         microbatches (``make_train_step``'s)
  --act-shard-d0         constrain the residual stream to (batch axis, None,
                         None) instead of (batch axis, None, model)
  --capacity-factor F    MoE expert capacity
  --mla-cache RULE       an MLA cache's rule: lora (its latent on the model
                         axis), replicate, or seq (its sequence there)
and ``--periods N`` runs N periods of the pattern instead of the full depth
(as the dry run's probes do), ``--probes`` adds the one- and two-period
probes for the roofline's check.

Usage:  python -m repro_torch.launch.hillclimb --arch olmo_1b --shape train_4k \
            --tag mb2 --microbatch 2 [--periods 1] [--out build/hillclimb]
writes ``<out>/<arch>__<shape>__<tag>.json`` (a dry-run record with its
``levers``) and prints its memory, FLOPs, bytes, wire bytes and roofline
terms.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.launch.dryrun import (
    MLA_CACHE,
    account,
    applicable_shapes,
    combo_cfg,
    probe_cfg,
)
from repro_torch.launch.mesh import axes_of, make_fake_mesh
from repro_torch.launch.roofline import analyse_record
from repro_torch.launch.specs import INPUT_SHAPES

DEFAULT_OUT = os.path.join("build", "hillclimb")
LEVERS = ("xlstm_chunk", "xlstm_parallel", "moe_gather", "microbatch", "act_shard_d0",
          "capacity_factor", "mla_cache", "periods")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--tag", required=True)
    ap.add_argument("--xlstm-chunk", type=int, default=0)
    ap.add_argument("--xlstm-parallel", action="store_true")
    ap.add_argument("--moe-gather", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--act-shard-d0", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--mla-cache", default="lora", choices=list(MLA_CACHE))
    ap.add_argument("--periods", type=int, default=0,
                    help="periods of the pattern to run (0: the full depth)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap


def lever_cfg(args, shape, axes):
    """The dry run's per-combination config with the levers of ``args``."""
    fsdp = tuple(axes.fsdp) if len(axes.fsdp) > 1 else axes.fsdp[0]
    batch_ax = fsdp if shape.global_batch % axes.fsdp_size == 0 else None
    act = (batch_ax, None, None) if args.act_shard_d0 else None
    cfg = combo_cfg(args.arch, shape, axes, act, args.mla_cache)
    over = {"xlstm_chunk": args.xlstm_chunk, "xlstm_parallel": args.xlstm_parallel,
            "fsdp_gather_moe": args.moe_gather}
    if args.capacity_factor is not None:
        over["capacity_factor"] = args.capacity_factor
    cfg = dataclasses.replace(cfg, **over)
    return probe_cfg(cfg, args.periods) if args.periods else cfg


def run(args) -> dict:
    """The record of ``args`` (``parser()``'s), written to its JSON."""
    if args.shape not in applicable_shapes(args.arch):
        raise NotImplementedError(f"{args.arch} {args.shape}: the dry run covers "
                                  f"{applicable_shapes(args.arch)}")
    shape = INPUT_SHAPES[args.shape]
    mesh = make_fake_mesh(args.multi_pod)
    cfg = lever_cfg(args, shape, axes_of(mesh))
    result = {"arch": args.arch, "shape": args.shape, "tag": args.tag,
              "mesh": "2x16x16" if args.multi_pod else "16x16",
              "levers": {k: getattr(args, k) for k in LEVERS},
              "num_layers": cfg.num_layers, "period": cfg.period,
              "num_periods": cfg.num_periods, "remainder": len(cfg.remainder)}
    result["scanned"] = account(cfg, shape, mesh, microbatches=args.microbatch)
    if args.probes:
        for n in (1, 2):
            result[f"probe{n}"] = account(probe_cfg(cfg, n), shape, mesh,
                                          microbatches=args.microbatch)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}__{args.shape}__{args.tag}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    result["path"] = path
    return result


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    r = run(args)
    sc, row = r["scanned"], analyse_record(r)
    mem = sc["memory"]
    print(f"{args.arch} {args.shape} [{args.tag}] {r['num_layers']} layers: "
          f"mem/dev={row.mem_device_gib:.2f} GiB (temp {mem['temp_bytes'] / 2**30:.2f}) "
          f"flops={sc['cost']['flops']:.4e} bytes={sc['cost']['bytes_accessed']:.4e} "
          f"coll={sc['collectives']['total_wire_bytes'] / 2**30:.2f} GiB "
          f"run={sc['run_s']:.1f}s; compute {row.compute_s:.3e} s, memory "
          f"{row.memory_s:.3e} s, collective {row.collective_s:.3e} s: {row.bottleneck}")
    print(f"wrote {r['path']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
