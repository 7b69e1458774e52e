"""A closed backlog: ``outstanding`` requests sent at the window's start, and
a new one each time one completes, due then.

    {"arrival": {"kind": "backlog", "outstanding": 48}, ..., "pool": 160}
"""
from __future__ import annotations

from h100bench.lib.traffic import ServeStream


class Backlog:
    def __init__(self, stream: ServeStream, outstanding: int):
        self.stream, self.n = stream, outstanding

    def start(self) -> list:
        return self.stream.take(self.n)

    def due(self, t: float) -> list:
        return []

    def done(self, uid: int, t: float, req) -> list:
        spec = self.stream.take(self.n + 1)[self.n]
        spec.due = t
        self.n += 1
        return [spec]

    def next_due(self):
        return None

    def unsent(self, seconds: float) -> list:
        return []


def source(params: dict, seed: int, vocab: int, num_tasks: int, seconds: float) -> Backlog:
    return Backlog(ServeStream(params, seed, vocab, num_tasks), params["arrival"]["outstanding"])
