"""Roofline of the dry run on the H100: read the port's dry-run records
(``python -m repro_torch.launch.dryrun ... --out build/dryrun``, or
``launch.hillclimb``'s) and give each (arch x shape) its three terms per
device, priced on ``costmodel.H100``:

  compute term    = FLOPs a device / the bf16 dense peak (the dry run's
                    model is bfloat16)
  memory term     = bytes accessed a device / HBM bandwidth
  collective term = the ring wire bytes of groups of at most 8 ranks / the
                    NVLink bandwidth + those of larger groups / the network
                    bandwidth (``wire_bytes_by_group``; a record without the
                    split prices every byte on the network)

with the bound (the largest term), the useful FLOP share (the global
MODEL_FLOPS of ``costmodel.model_flops`` over the device FLOPs times the
mesh's devices) and the GiB a device (the argument, temp and returned
bytes, less the alias bytes: what the call returns in place).

Every number comes from the full-depth record (``scanned``): the port's dry
run is eager and counts every layer exactly. Where the record has probes
(``--probes``: one and two periods of the pattern), the reference's
extrapolation ``X = p1 + (P - 1 + R / period) (p2 - p1)`` is reported
beside it with its relative difference from the full record, as a check of
the reference's method (``probe_flops_rel``, ``probe_bytes_rel``,
``probe_wire_rel``).

Usage:  python -m repro_torch.launch.roofline [--dir build/dryrun/singlepod]
        [--csv build/roofline.csv]
writes the CSV and prints a markdown table on stdout.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import json
import math
import os
import sys

from repro_torch.configs import get
from repro_torch.launch.costmodel import H100, Hardware, model_flops
from repro_torch.launch.specs import INPUT_SHAPES

DEFAULT_DIR = os.path.join("build", "dryrun", "singlepod")
DEFAULT_CSV = os.path.join("build", "roofline.csv")


def _dig(rec, path):
    for key in path:
        rec = rec.get(key) if isinstance(rec, dict) else None
        if rec is None:
            return None
    return rec


def extrapolate(rec: dict, path: tuple[str, ...]) -> float | None:
    """The reference's depth extrapolation of the number at ``path`` from
    the record's probes: p1 + (P - 1 + R / period) (p2 - p1); None without
    probes."""
    p1, p2 = _dig(rec.get("probe1"), path), _dig(rec.get("probe2"), path)
    if p1 is None or p2 is None:
        return None
    return p1 + (rec["num_periods"] - 1 + rec["remainder"] / rec["period"]) * (p2 - p1)


def collective_seconds(part: dict, hw: Hardware = H100) -> tuple[float, float]:
    """(NVLink seconds, network seconds) of a record part's wire bytes: a
    group of up to ``hw.nvlink_ranks`` ranks fits one node."""
    by_group = part.get("wire_bytes_by_group")
    if by_group is None:
        return 0.0, part["collectives"]["total_wire_bytes"] / hw.network_bw
    near = sum(b for g, b in by_group.items() if int(g) <= hw.nvlink_ranks)
    far = sum(b for g, b in by_group.items() if int(g) > hw.nvlink_ranks)
    return near / hw.nvlink_bw, far / hw.network_bw


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    flops_dev: float
    bytes_dev: float
    coll_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    nvlink_s: float
    network_s: float
    bottleneck: str
    model_flops_global: float
    useful_frac: float
    mem_device_gib: float
    probe_flops_rel: float | None
    probe_bytes_rel: float | None
    probe_wire_rel: float | None

    def as_dict(self):
        return dataclasses.asdict(self)


def _rel(x, full):
    return None if x is None else (x - full) / full if full else 0.0


def analyse_record(rec: dict, hw: Hardware = H100) -> RooflineRow:
    """The roofline row of one dry-run record (see the module docstring)."""
    cfg, shape = get(rec["arch"]), INPUT_SHAPES[rec["shape"]]
    sc = rec["scanned"]
    flops, byts = sc["cost"]["flops"], sc["cost"]["bytes_accessed"]
    coll = sc["collectives"]["total_wire_bytes"]
    nvlink_s, network_s = collective_seconds(sc, hw)
    terms = {"compute": flops / hw.peak_flops, "memory": byts / hw.hbm_bw,
             "collective": nvlink_s + network_s}
    devices = math.prod(int(n) for n in rec.get("mesh", "16x16").split("x"))
    mf = model_flops(cfg, shape)
    mem = sc["memory"]
    # argument + temp + returned bytes - alias bytes (the memory record's keys)
    gib = (sum(mem.values()) - 2 * mem["alias_bytes"]) / 2**30
    return RooflineRow(
        rec["arch"], rec["shape"], rec.get("mesh", "16x16"), flops, byts, coll,
        terms["compute"], terms["memory"], terms["collective"], nvlink_s, network_s,
        max(terms, key=terms.get), mf, mf / (flops * devices) if flops else 0.0, gib,
        _rel(extrapolate(rec, ("cost", "flops")), flops),
        _rel(extrapolate(rec, ("cost", "bytes_accessed")), byts),
        _rel(extrapolate(rec, ("collectives", "total_wire_bytes")), coll))


def load(directory: str) -> list[dict]:
    """Every dry-run record (``*.json``) in ``directory``, by file name."""
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def table(rows: list[RooflineRow]) -> str:
    """The markdown table of ``rows``: the reference's columns, then the
    probes' check."""
    lines = ["| arch | shape | compute s | memory s | collective s | bound | useful FLOP "
             "frac | mem GiB/dev | probe FLOPs rel |", "|" + "---|" * 9]
    for r in sorted(rows, key=lambda r: (r.arch, r.shape, r.mesh)):
        probe = "–" if r.probe_flops_rel is None else f"{r.probe_flops_rel:+.2e}"
        lines.append(f"| {r.arch} | {r.shape} | {r.compute_s:.3e} | {r.memory_s:.3e} | "
                     f"{r.collective_s:.3e} | **{r.bottleneck}** | {r.useful_frac:.2f} | "
                     f"{r.mem_device_gib:.1f} | {probe} |")
    return "\n".join(lines)


def write_csv(rows: list[RooflineRow], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[fld.name for fld in dataclasses.fields(RooflineRow)])
        w.writeheader()
        for r in rows:
            w.writerow(r.as_dict())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--csv", default=DEFAULT_CSV)
    args = ap.parse_args(argv)
    rows = [analyse_record(r) for r in load(args.dir)]
    if not rows:
        print(f"roofline: no dry-run records in {args.dir}", file=sys.stderr)
        return 1
    print(f"roofline on {H100.name}: bf16 {H100.peak_flops:.4g} FLOP/s, HBM "
          f"{H100.hbm_bw:.4g} B/s, NVLink {H100.nvlink_bw:.4g} B/s within "
          f"{H100.nvlink_ranks} ranks, network {H100.network_bw:.4g} B/s")
    print(table(rows))
    write_csv(rows, args.csv)
    print(f"\nwrote {args.csv} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
