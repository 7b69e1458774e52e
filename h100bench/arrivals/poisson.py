"""Open-loop Poisson arrivals, conditioned on their count: ``round(rate x
seconds)`` requests due at independent uniform times of the window, sorted,
which is a Poisson process of that rate given its count in the window. The
pool of sizes is that count, so every seed serves the same sizes in the
window, in its own order. Each request is submitted once it is due, whatever
the server does.

    {"arrival": {"kind": "poisson", "rate": 22.4}, ...}
"""
from __future__ import annotations

import numpy as np

from h100bench.lib.traffic import ServeStream


class OpenLoop:
    def __init__(self, specs: list):
        self.specs, self.i = specs, 0

    def start(self) -> list:
        return []

    def due(self, t: float) -> list:
        out = []
        while self.i < len(self.specs) and self.specs[self.i].due <= t:
            out.append(self.specs[self.i])
            self.i += 1
        return out

    def done(self, uid: int, t: float, req) -> list:
        return []

    def next_due(self):
        return self.specs[self.i].due if self.i < len(self.specs) else None

    def unsent(self, seconds: float) -> list:
        return [s for s in self.specs[self.i:] if s.due < seconds]


def arrival_times(rate: float, seconds: float, seed: int) -> np.ndarray:
    n = max(1, int(round(rate * seconds)))
    return np.sort(np.random.default_rng([abs(int(seed)), 8]).uniform(0.0, seconds, n))


def source(params: dict, seed: int, vocab: int, num_tasks: int, seconds: float) -> OpenLoop:
    dues = arrival_times(params["arrival"]["rate"], seconds, seed)
    specs = ServeStream(params, seed, vocab, num_tasks, pool=len(dues)).take(len(dues))
    for spec, due in zip(specs, dues):
        spec.due = float(due)
    return OpenLoop(specs)
