"""Find the knee of an open-loop serving cell: the highest offered rate that
the port sustains without a growing queue.

    python3 h100bench/sweep.py --workload mtlm.tenants-online --rates 10,20,30,40 \\
        --seconds 20 --seed 7 --out chiprun_out/sweep.jsonl

One process builds the cell once (``lib/serve.build``, warm-up included)
and offers each rate in turn for ``--seconds``, the queue drained between
rates. Per rate it writes the completed requests per second, the tails of
time to first token and of the time per output token, and the queue left
when the window closed. The knee is the highest rate whose completions keep
up: its queue at the close is under one round of slots, and the median
time to first token of the window's second half is under twice the first
half's plus 50 ms; a cell runs at a fixed fraction of it, written
into its traffic file as a number. The benchmark's runs never sweep.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = Path(__file__).resolve().parent
    sys.path[:0] = [str(root / "src"), str(bench.parent)]
    import numpy as np
    import torch

    from h100bench.lib import common, serve, trace, traffic
    from repro_torch.kernels.runtime import build_kernels

    cell = common.Cell(args.workload, root, bench)
    device = torch.device("cuda", 0)
    build_kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    c = cell.arch(False)
    _, batcher, store, rec = serve.build(c, cell.spec, args.seed, device)
    serve.warm_up(batcher, serve.warm_specs(cell.traffic, args.seed, c,
                                            cell.spec["warmup_requests"]))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    slots = cell.spec["server"]["num_slots"]
    for j, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = common.merge(cell.traffic, {"arrival": {"rate": rate}})
        src = traffic.source(mix, args.seed + 1 + j, c["vocab_size"], c["num_tasks"],
                             args.seconds)
        rec.recs = {}
        w = serve.window(torch, batcher, rec, store, src, args.seconds,
                         trace.Tracer(torch, False, 0.0, 0.0))
        reqs = w["requests"]
        done = [r for r in reqs if r.done]
        ttft = [(r.first if r.first is not None else w["elapsed"]) - r.due for r in reqs]
        tpot = [(r.last - r.first) / (r.ntok - 1) * 1e3 for r in done if r.ntok > 1]
        row = {"rate": rate, "offered": len(reqs), "completed_per_s": len(done) / w["elapsed"],
               "ttft_p95_s": float(np.percentile(ttft, 95)),
               "tpot_p95_ms": float(np.percentile(tpot, 95)) if tpot else None,
               "queue_at_close": len(batcher.queue), "card": torch.cuda.get_device_name(0)}
        half = args.seconds / 2
        for name, part in (("first_half", [t for r, t in zip(reqs, ttft) if r.due < half]),
                           ("second_half", [t for r, t in zip(reqs, ttft) if r.due >= half])):
            row[f"ttft_p50_s_{name}"] = float(np.median(part)) if part else None
        # a queue that grows shows as later requests waiting longer and a
        # queue left at the close
        row["keeps_up"] = bool(row["queue_at_close"] < slots and part and
                               row["ttft_p50_s_second_half"]
                               < 2 * row["ttft_p50_s_first_half"] + 0.05)
        print(json.dumps(row), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        batcher.run(max_ticks=1_000_000, on_exhausted="flag")  # drain
        batcher.finished.clear()  # the next rate reuses the uids
    return 0


if __name__ == "__main__":
    sys.exit(main())
