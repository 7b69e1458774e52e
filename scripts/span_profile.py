"""Run one cell of the H100 benchmark with the port's span recorder on, and
print what the spans say.

    python3 scripts/span_profile.py --workload <cell> --seed <n> --seconds 45 --trace <0|1>
        [--out FILE]

from the root of a checkout, on a machine with the cell's CUDA devices (or
``--rehearse`` on the CPU at the cell's smoke size). It is
``h100bench/run.py`` (whose result line it prints first) with
``repro_torch.tracing`` started when the window's tracer is made and stopped
when the window closes; in a ``--trace 1`` run the profiler's raw events are
joined with the program's ranges (``h100bench/lib/spans.join``) before the
trace file is deleted. Its own last line is a JSON object: the span
readers of ``h100bench/lib/spans.py``, the record count and an estimate of
its bytes, the longest rounds by span, each span's mean ms (in a traced run
apart before and under the profiler), and in a traced run the idle time and
the device time by span. The recorder's cost is this script's end-to-end
metrics against those of ``h100bench/run.py`` with the same arguments and
seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def record_bytes(recs: list) -> int:
    """The records' tuples and integers (names and small ints are shared)."""
    n = 0
    for r in recs:
        n += sys.getsizeof(r) + sys.getsizeof(r[1]) + sys.getsizeof(r[2]) + 8
        n += sys.getsizeof(r[3]) if r[3] > 256 else 0
        n += sys.getsizeof(r[4]) if isinstance(r[4], int) and not -5 <= r[4] <= 256 else 0
    return n


def longest_rounds(recs: list, k: int = 5) -> list:
    """The ``k`` longest ``serve.round`` spans: ms, and ms by child name."""
    rounds = [i for i, r in enumerate(recs) if r[0] == "serve.round" and r[2] > 0]
    rounds.sort(key=lambda i: recs[i][1] - recs[i][2])
    kids: dict = {i: {} for i in rounds[:k]}
    for n, t0, t1, parent, _ in recs:
        if parent in kids and n != "request.queued":
            kids[parent][n] = kids[parent].get(n, 0.0) + (t1 - t0) * 1e-6
    return [{"ms": (recs[i][2] - recs[i][1]) * 1e-6,
             "children_ms": {n: round(v, 3) for n, v in sorted(kids[i].items())}}
            for i in rounds[:k]]


def span_ms(recs: list, since: int = 0, until: int | None = None) -> dict:
    """Mean ms of each span name over the records that start in [since, until)."""
    tot: dict = {}
    for n, t0, t1, _, _ in recs:
        if t1 >= t0 >= since and (until is None or t0 < until):
            c = tot.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (t1 - t0) * 1e-6
    return {n: round(v / k, 4) for n, (k, v) in sorted(tot.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args, rest = ap.parse_known_args(argv)

    from h100bench import run
    from h100bench.lib import spans, trace
    from repro_torch import tracing

    got: dict = {}
    plain = trace.Tracer

    class SpanTracer(plain):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tracing.start()  # set-up is over; the window starts next

        def poll(self, t):
            super().poll(t)
            if self.active and "profiled_from" not in got:
                got["profiled_from"] = time.perf_counter_ns()

        def stop(self):
            if tracing.enabled():
                got.setdefault("records", tracing.stop())
            super().stop()

        def summary(self, extra):
            if self.path is not None:
                with open(self.path) as f:
                    got["joined"] = spans.join(json.load(f)["traceEvents"])
            return super().summary(extra)

    trace.Tracer = SpanTracer
    try:
        rc = run.main(rest)
    finally:
        trace.Tracer = plain
        got.setdefault("records", tracing.stop())
    if rc != 0:
        return rc
    recs = got["records"]
    rec = {"spans": recs, "trace": {"spans": got.get("joined")}}
    out = {"records": len(recs), "record_bytes": record_bytes(recs)}
    for name in ("round_host_ms", "admit_wait_p95_ms", "update_host_ms", "update_idle_ms",
                 "train_mix_ms", "train_optimizer_ms"):
        v = getattr(spans, name)(rec)
        if v is not None:
            out[name] = v
    counts: dict = {}
    for r in recs:
        counts[r[0]] = counts.get(r[0], 0) + 1
    out["span_counts"] = counts
    out["longest_rounds"] = longest_rounds(recs)
    # the profiler's own host cost shows as the same spans taking longer under it
    since = got.get("profiled_from")
    out["span_ms"] = span_ms(recs, until=since)
    if since is not None:
        out["span_ms_profiled"] = span_ms(recs, since=since)
    joined = got.get("joined")
    if joined is not None:
        out["joined"] = joined
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    sys.exit(main())
