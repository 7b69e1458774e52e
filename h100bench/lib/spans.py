"""The program's own spans (``repro_torch.tracing``) read against the
profiler's timeline and against their own records.

``join(events)`` takes a traced run's raw chrome-trace events (``trace.py``'s
file, before it is deleted) and the program's ranges on them (user
annotations named ``repro_torch.<span>``, which the program opens while a
profiler records):

* every microsecond of the traced window in which no kernel, copy or set ran
  on the device (its times first moved onto the host's clock, which they
  drift from) goes to the innermost program range open on the host at that
  moment, or to ``outside`` where none was (``idle_self``); each range's
  name also collects the idle time inside its ranges, its descendants'
  included (``idle_in``). ``idle_spans`` is the ten names of most
  ``idle_self``, and ``idle_leaf_share`` the share of the idle time that a
  leaf name (one no range ever encloses another in) or ``outside`` holds;
* every kernel, copy or set goes to the innermost program range open at its
  launch: the ``cuda_runtime`` or ``cuda_driver`` call with the same
  ``correlation`` (``cudaGraphLaunch`` for a graph replay's kernels), in
  ``device_self`` / ``device_in``. Work whose launch the profile does not
  hold (launched before the profiler started) is left out of both and counted
  in ``unlaunched_s``; ``launched_s`` is the device time of the rest.

``count_in`` counts each name's ranges on the timeline, and ``clock_offset_ms``
the least and most shift that placed device times on the host's clock
(``_device_clock``). Seconds throughout, but for that.

The readers below take a run's record: ``run["spans"]``, the program's
records over the whole window (``repro_torch.tracing.stop()``: ``(name,
t0_ns, t1_ns, parent, uid)``), and ``run["trace"]["spans"]``, ``join``'s
result over the profiled part. Each returns None where the run has nothing to
read (an untraced run, or a program without spans).
"""
from __future__ import annotations

import bisect

import numpy as np

from h100bench.lib.trace import DEVICE_CATS, PREFIX as HARNESS

PROGRAM = "repro_torch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside"


def _segments(ranges: list) -> tuple[list, list, list]:
    """Elementary intervals of the program's ranges ``(name, a, b)``: their
    starts, ends, and the names open over each, outermost first (a tie of
    starts puts the longer range outside)."""
    edges = sorted({a for _, a, _ in ranges} | {b for _, _, b in ranges})
    order = sorted(range(len(ranges)), key=lambda i: (ranges[i][1], -ranges[i][2]))
    t0s, t1s, stacks = [], [], []
    live: list = []
    k = 0
    for lo, hi in zip(edges, edges[1:]):
        live = [i for i in live if ranges[i][2] > lo]
        while k < len(order) and ranges[order[k]][1] <= lo:
            if ranges[order[k]][2] > lo:
                live.append(order[k])
            k += 1
        if live:
            t0s.append(lo)
            t1s.append(hi)
            stacks.append(tuple(ranges[i][0] for i in live))
    return t0s, t1s, stacks


def _credit(self_d: dict, in_d: dict, stack: tuple, amount: float) -> None:
    name = stack[-1] if stack else OUTSIDE
    self_d[name] = self_d.get(name, 0.0) + amount
    for n in set(stack):
        in_d[n] = in_d.get(n, 0.0) + amount


def _device_clock(ops: list, launches: dict) -> np.ndarray:
    """Each device event's offset from the host's clock: the trace's device
    times drift from its host times (by up to 2.7 ms a second on the H100), so
    the idle time is placed on the host's clock before it is split by span.
    Each copy from the device to pageable memory is an anchor: its host call
    returns only once the copy has ended, so (device end - host return) is the
    offset there, less the host's wake-up. Offsets between anchors are
    interpolated, held beyond them; with no anchor they are 0."""
    anchors = []
    for e in ops:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None and "Device -> Pageable" in e.get("name", ""):
            host_end = float(launch["ts"]) + float(launch["dur"])
            anchors.append((host_end, float(e["ts"]) + float(e["dur"]) - host_end))
    t = np.array([float(e["ts"]) for e in ops])
    if not anchors:
        return np.zeros_like(t)
    anchors.sort()
    at, off = np.array([a for a, _ in anchors]), np.array([o for _, o in anchors])
    return np.interp(t - np.interp(t, at, off), at, off)


def join(events: list) -> dict:
    """The program's ranges against the device's timeline (module
    docstring)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == HARNESS + "window"]
    if not win:
        raise RuntimeError("trace: the harness's window range is missing")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ranges = [(e["name"][len(PROGRAM):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in xs if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(PROGRAM)]
    t0s, t1s, stacks = _segments(ranges)
    nonleaf = {n for st in stacks for n in st[:-1]}

    def stack_at(t: float) -> tuple:
        j = bisect.bisect_right(t0s, t) - 1
        return stacks[j] if j >= 0 and t < t1s[j] else ()

    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = [e for e in xs if e.get("cat") in DEVICE_CATS]
    shift = _device_clock(ops, launches)
    # idle: the window less the union of device intervals (on the host's
    # clock), split by segment
    busy = sorted((max(float(e["ts"]) - d, w0), min(float(e["ts"]) + float(e["dur"]) - d, w1))
                  for e, d in zip(ops, shift))
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if b < a:
            continue
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle_self: dict = {}
    idle_in: dict = {}
    for a, b in gaps:
        t = a
        j = max(0, bisect.bisect_right(t0s, a) - 1)
        while t < b:
            while j < len(t0s) and t1s[j] <= t:
                j += 1
            if j < len(t0s) and t0s[j] <= t:  # segment j holds t
                end, stack = min(b, t1s[j]), stacks[j]
            else:
                end, stack = (min(b, t0s[j]) if j < len(t0s) else b), ()
            _credit(idle_self, idle_in, stack, end - t)
            t = end
    # device work: by the range open at its launch (host times alone)
    device_self: dict = {}
    device_in: dict = {}
    launched = unlaunched = 0.0
    for e in ops:
        dur = float(e["dur"])
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            unlaunched += dur
            continue
        launched += dur
        _credit(device_self, device_in, stack_at(float(launch["ts"])), dur)
    idle = sum(idle_self.values())
    leaf = sum(s for n, s in idle_self.items() if n not in nonleaf)
    count: dict = {}
    for n, _, _ in ranges:
        count[n] = count.get(n, 0) + 1
    us = 1e-6

    def scale(d: dict) -> dict:
        return {k: v * us for k, v in d.items()}

    top = sorted(idle_self.items(), key=lambda kv: -kv[1])[:10]
    return {"idle_spans": [[n, s * us] for n, s in top], "idle_s": idle * us,
            "clock_offset_ms": ([float(shift.min()) * 1e-3, float(shift.max()) * 1e-3]
                                if shift.size else [0.0, 0.0]),
            "idle_leaf_share": leaf / idle if idle > 0 else None,
            "idle_self": scale(idle_self), "idle_in": scale(idle_in),
            "device_self": scale(device_self), "device_in": scale(device_in),
            "launched_s": launched * us, "unlaunched_s": unlaunched * us, "count_in": count}


# ---------------------------------------------------------------- readers
def _records(run):
    recs = run.get("spans")
    return recs if recs else None


def _durations_ms(recs, name: str) -> list:
    return [(t1 - t0) * 1e-6 for n, t0, t1, _, _ in recs if n == name and t1 >= t0 > 0]


def round_host_ms(run):
    """Mean over the window's ``serve.round`` spans of the span's duration
    less its ``*.wait`` descendants': the round's host time with nothing of
    its own queued on the device, in ms."""
    recs = _records(run)
    if recs is None:
        return None
    waits: dict = {}
    for n, t0, t1, parent, _ in recs:
        if not n.endswith(".wait"):
            continue
        p, outer = parent, None
        while p >= 0:
            if recs[p][0].endswith(".wait"):
                break  # inside another wait: counted there
            if recs[p][0] == "serve.round":
                outer = p
            p = recs[p][3]
        else:
            if outer is not None:
                waits[outer] = waits.get(outer, 0) + (t1 - t0)
    host = [(t1 - t0 - waits.get(i, 0)) * 1e-6 for i, (n, t0, t1, _, _) in enumerate(recs)
            if n == "serve.round" and t1 >= t0 > 0]
    return float(np.mean(host)) if host else None


def admit_wait_p95_ms(run):
    """95th percentile of ``request.queued`` (submit to binding), over the
    requests admitted in the window, in ms."""
    recs = _records(run)
    waits = _durations_ms(recs, "request.queued") if recs else []
    return float(np.percentile(waits, 95)) if waits else None


def update_host_ms(run):
    """Mean ``store.update`` duration over the window, in ms."""
    recs = _records(run)
    d = _durations_ms(recs, "store.update") if recs else []
    return float(np.mean(d)) if d else None


def _per_span(run, table: str, name: str):
    tr = run.get("trace")
    joined = tr.get("spans") if tr else None
    if not joined or not joined["count_in"].get(name):
        return None
    return 1e3 * joined[table].get(name, 0.0) / joined["count_in"][name]


def update_idle_ms(run):
    """Device idle ms inside ``store.update`` spans in the profiled part, over
    the updates there."""
    return _per_span(run, "idle_in", "store.update")


def train_mix_ms(run):
    """Device ms of the work launched inside ``train.mix`` spans that the
    profile holds, over the number of those spans."""
    return _per_span(run, "device_in", "train.mix")


def train_optimizer_ms(run):
    """Device ms of the work launched inside ``train.optimizer`` spans that
    the profile holds, over the number of those spans."""
    return _per_span(run, "device_in", "train.optimizer")
