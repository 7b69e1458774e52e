"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the last
few seconds of the window (stopped, and its trace written, only once the
window has closed, so that neither costs the window any time), with the
harness's own ranges ("generator", "step", "update" in serving; "step" in
training) on the host timeline.

The trace goes to a file under ``TMPDIR``, is read back once and deleted.
``summary`` reduces it to what the readers take: the traced window's
length, the device's busy seconds in it (the union of kernel, copy and set
intervals), each device op's name and duration, the ten ops that took most
time, and the ten longest idle gaps, each named by the innermost harness
range that the host was in at the gap's middle ("host" if none).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "h100bench."


class Tracer:
    def __init__(self, torch, enabled: bool, seconds: float, length_s: float):
        self.torch, self.enabled = torch, enabled
        self.start_s = max(0.0, seconds - length_s)
        self.prof = None
        self.active = False
        self.done = False
        self._window = None
        self.path = None

    def _profiler(self):
        p = self.torch.profiler
        return p.profile(activities=[p.ProfilerActivity.CPU, p.ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start and stop one profiler in set-up, so that the window's start
        pays no first initialization of the device tracer."""
        if not self.enabled:
            return
        with self._profiler():
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def range(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(PREFIX + name)

    def poll(self, t: float) -> None:
        """Start the profiler once the window reaches ``start_s``."""
        if self.enabled and not self.done and not self.active and t >= self.start_s:
            self.prof = self._profiler()
            self.prof.start()
            self._window = self.torch.profiler.record_function(PREFIX + "window")
            self._window.__enter__()
            self.active = True

    def stop(self) -> None:
        """Close the traced window (after the measured one) and write it."""
        if not self.active:
            return
        self.torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.active, self.done = False, True
        fd, self.path = tempfile.mkstemp(prefix="h100bench-", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def summary(self, extra: dict) -> dict | None:
        """The reduced trace (module docstring) with ``extra`` merged in, or
        None untraced."""
        if self.path is None:
            return None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(self.path)
        update_ms = [a.elapsed_time(b) for a, b in extra.get("update_events", [])]
        return dict(reduce(events), **extra, update_ms=update_ms)


def reduce(events: list) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == PREFIX + "window"]
    if not win:
        raise RuntimeError("trace: the harness's window range is missing")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ops.append((e["name"], a, b))
    ranges = [(e["name"][len(PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in xs if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(PREFIX) and e["name"] != PREFIX + "window"]
    merged = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        inside = [r for r in ranges if r[1] <= mid <= r[2]]
        name = min(inside, key=lambda r: r[2] - r[1])[0] if inside else "host"
        idle.append([name, (b - a) * 1e-6])
    by_name: dict[str, float] = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "ops": [(n, (b - a) * 1e-6) for n, a, b in ops],
            "device_ops": [[n[:160], s * 1e-6] for n, s in top], "idle_gaps": idle}
