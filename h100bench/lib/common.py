"""What every run shares: finding a cell's files by name, the process clock,
the device's description, the import guard and the result line."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # h100bench/
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One cell, resolved by name: its entry in ``BENCHMARK.json`` at the
    checkout's root, ``cells/<name>.json`` (server, store or optimizer
    settings, the check's limits), ``configs/<config>.json`` and
    ``traffic/<traffic>.json``, all under ``bench`` (``h100bench/`` of the
    checkout the run started from)."""

    def __init__(self, name: str, root: Path, bench: Path = BENCH):
        self.root, self.bench = Path(root), Path(bench)
        self.manifest = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in entries:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
        self.name, self.entry = name, entries[name]
        self.spec = load_json(self.bench / "cells" / f"{name}.json")
        self.config = load_json(self.bench / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(self.bench / "traffic" / f"{self.entry['traffic']}.json")
        self.t_start = process_start()
        self.marks: list = []

    def mark(self, phase: str) -> None:
        """Note the end of a set-up phase (reported on standard error)."""
        self.marks.append((phase, time.perf_counter()))

    def phases(self) -> str:
        out, prev = [], self.t_start
        for phase, t in self.marks:
            out.append(f"{phase} {t - prev:.2f}")
            prev = t
        return ", ".join(out)

    def metrics(self, group: str) -> list[dict]:
        """The manifest's ``end_to_end`` or ``per_layer`` metrics this cell
        reports (a metric without ``workloads`` is every cell's)."""
        return [m for m in self.manifest[group]
                if self.name in m.get("workloads", [self.name])]

    def arch(self, rehearse: bool) -> dict:
        """The configuration's sizes as run: the file's, or its ``smoke``
        sizes in a CPU rehearsal."""
        c = {k: v for k, v in self.config.items() if k not in ("smoke", "assumed", "source")}
        return {**c, **self.config["smoke"]} if rehearse else c


def reader(bench: Path, name: str):
    """The ``read(run)`` function of metric ``name`` (``metrics/<name>.py``)."""
    path = Path(bench) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_names(bench: Path, layer: str) -> list[str]:
    """Substrings of the device kernels attributed to ``layer``: one per line
    of every ``kernels/<layer>/*.txt`` (a later kernel adds a file)."""
    names = []
    for f in sorted((Path(bench) / "kernels" / layer).glob("*.txt")):
        names += [ln.strip() for ln in f.read_text().splitlines() if ln.strip()]
    return names


def process_start() -> float:
    """``time.perf_counter()`` at this process's start, from /proc (10 ms
    ticks), so that set-up counts the interpreter's start and every import."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is the JAX
    package's, or JAX's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def emit(result: dict, checks: dict, cell: Cell) -> None:
    """The set-up's phases, then each compared number beside its limit, last
    on standard error; then the result line, ``checks`` its last key, last
    on standard output."""
    print(f"set-up phases (s): {cell.phases()}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}))
    sys.stdout.flush()


def arch_config(c: dict):
    """The port's ``ArchConfig`` of a configuration's sizes."""
    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in c.items() if k in fields}
    kw["pattern"] = tuple(kw["pattern"])
    return ArchConfig(**kw)


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s values, nested dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def rehearsal(spec: dict, mix: dict) -> tuple[dict, dict]:
    """A cell's settings and traffic with its ``rehearse`` overrides."""
    over = spec["rehearse"]
    return merge(spec, over), merge(mix, over.get("traffic", {}))
