"""Run one cell several times, one process after another, and keep every
result line: the spread measurement, the dozen seeds of the check, the
control's readings.

    python3 h100bench/series.py --workload <cell> --seeds 11,12,13 --seconds 30 \\
        [--trace 1] [--control] --out chiprun_out/<name>.jsonl

from the root of a checkout. Each run is ``h100bench/run.py`` in its own
process; its line (seed, exit code, wall seconds, the result, the end of
its standard error) is appended to ``--out``. The card's name and power
limit (``nvidia-smi``) open the file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    run = Path(__file__).resolve().with_name("run.py")
    with out.open("a") as f:
        f.write(json.dumps({"card": smi(), "workload": args.workload}) + "\n")
        for seed in [int(s) for s in args.seeds.split(",")]:
            cmd = [sys.executable, str(run), "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace)]
            if args.control:
                cmd.append("--control")
            t = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True)
            lines = p.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            rec = {"seed": seed, "rc": p.returncode, "wall_s": time.perf_counter() - t,
                   "trace": args.trace, "result": result, "stderr": p.stderr[-3000:]}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            m = (result or {}).get("metrics", {})
            print(seed, p.returncode, round(rec["wall_s"], 1), (result or {}).get("correct"),
                  {k: round(v["value"], 4) for k, v in m.items()},
                  (result or {}).get("checks"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
