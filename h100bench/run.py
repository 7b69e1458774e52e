"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's files are found by its name (see
``lib/common.Cell``); the port is imported from the checkout's ``src/``.
The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones, each read by ``metrics/<name>.py``), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` (with
``--trace 1``) and, last, ``checks``: each compared number and its limit,
which also close standard error.

Without enough CUDA devices for the cell, without the port's sources, or
with a module of JAX or of the JAX package loaded once the window has
closed, it prints no result and exits non-zero.

A cell's driver is ``lib/<kind>.py`` for its ``kind`` (``serve``,
``train``), with ``run(cell, seed, seconds, tracing, device, rehearse,
control)``; a serving mix's arrivals are ``arrivals/<kind>.py``.

``--rehearse`` runs the cell on the CPU at its configuration's ``smoke``
sizes and the cell's ``rehearse`` settings, and reports no device metric
(tests). ``--control`` adds the readings of the lower-precision control,
and for training of the half-batch fault, to ``checks`` (limits are set
from them; the benchmark's own runs do not pass it); for a store, the
readings of two faults the reference plays as well (``reference/serve.py``).
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch under {root}: run from the root of a checkout",
              file=sys.stderr)
        return 2
    for p in (str(root / "src"), str(bench.parent)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # caches of compilers a library might start, at fixed paths in the checkout
    cache = root / "build" / "h100bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"

    from h100bench.lib import common

    cell = common.Cell(args.workload, root, bench)
    import torch

    cell.mark("imports")

    if args.rehearse:
        device = torch.device("cpu")
    else:
        chips = cell.entry["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        from repro_torch.kernels.runtime import build_kernels

        torch.zeros(1, device=device)
        cell.mark("cuda init")
        build_kernels()  # the checkout's build/kernels/ cache; only a first run compiles
        cell.mark("kernels")
    # the cell's driver: lib/<kind>.py (a later kind adds a file)
    driver = importlib.import_module(f"h100bench.lib.{cell.spec['kind']}")
    result, checks = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                                args.rehearse, args.control)
    bad = common.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    run = result.pop("run")
    group = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(group):
        if args.rehearse and (m["source"] == "device_trace" or "mfu" in m["name"]):
            continue
        value = common.reader(bench, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": result["device"]}
    tr = run.get("trace")
    if args.trace and tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    common.emit(out, checks, cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
