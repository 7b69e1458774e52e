"""The port's span recorder: where the serving round, the adapter store and
the train step spend their host time, on the profiler's clock.

One process-wide recorder, off by default. ``start()`` clears it and turns
it on; ``stop()`` turns it off and returns its records, each a tuple
``(name, t0_ns, t1_ns, parent, uid)``: two ``time.perf_counter_ns()``
stamps, the index of the enclosing span in the same list (-1 for none) and
a request's uid (None where the span is not one request's). Records stay in
memory until ``stop()``; nothing is written anywhere.

``span(name, uid=None)`` is a context manager around one piece of work. A
name that starts with "." is relative: it extends the name of the enclosing
span (``.wait`` inside ``serve.decode`` is ``serve.decode.wait``), so one
helper's spans carry its caller's name. While a ``torch.profiler`` records,
an open span also opens ``torch.profiler.record_function("repro_torch." +
name)``, which puts it on the profiler's timeline beside the kernels and
copies it launched. With the recorder off, ``span`` returns one shared
no-op context: one flag check and one call, nothing allocated.

``mark(name, uid, t0_ns, t1_ns, parent)`` records a span whose two ends are
stamped at different places; the request stamps build on it:
``request.queued`` runs from ``submitted`` (the scheduler's queue) to
``bound`` (the slot), its parent the ``serve.round`` that admitted it;
``request.prefill`` from binding to ``first_token``; ``request.decode`` from
the first token to ``finished``. A request that fails, is cancelled or
times out records no ``request.decode``.

Where the port opens spans (the names a reader looks for):

* ``ContinuousBatcher.step``: ``serve.round``, with ``serve.admit``
  (retirement of expired requests, admission, binding, copy-on-write),
  ``serve.prefill`` per (num_slots, C) dispatch, ``serve.decode`` per tick,
  ``serve.mixed`` per fused dispatch (``chunk_budget`` mode), each with
  ``.pack`` (the host slab; the executor's slot reset and upload), ``.launch``
  (the replay, or the eager step), ``.wait`` (the read-back that waits for the
  device) and ``.emit`` (tokens and their callbacks), and ``serve.finish``
  (``_finish_ready``, with the store's updates);
* ``TaskAdapterStore.update``: ``store.update``, with ``store.delays`` (the
  host draw; its upload, which waits for the stream, ``store.delays.wait``),
  ``store.stale``, ``store.mix``, ``store.step`` and ``store.refresh``;
* the train step: ``train.step`` with ``train.grads`` (one per microbatch),
  ``train.mix`` and ``train.optimizer``; ``train.upload`` in
  ``batch_to_device``.

Every place where a round blocks on the device has a span whose name ends
in ``.wait``. No span is opened inside a CUDA-graph capture.
"""
from __future__ import annotations

import time

import torch

PREFIX = "repro_torch."
ROUND = "serve.round"


class _Off:
    """The shared context of a span while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class Recorder:
    """The records of one recording, the stack of open spans and the
    request stamps not yet closed."""

    def __init__(self, on: bool = False):
        self.on = on
        self.records: list = []
        self.stack: list[int] = []
        self.submit: dict = {}
        self.bind: dict = {}
        self.first: dict = {}

    def enclosing(self, name: str) -> int:
        """Index of the innermost open span called ``name``, or -1."""
        for i in reversed(self.stack):
            if self.records[i][0] == name:
                return i
        return -1


class _Span:
    __slots__ = ("rec", "name", "uid", "index", "prof")

    def __init__(self, rec: Recorder, name: str, uid):
        self.rec, self.name, self.uid = rec, name, uid

    def __enter__(self):
        rec = self.rec
        parent = rec.stack[-1] if rec.stack else -1
        name = self.name
        if name[0] == ".":
            name = rec.records[parent][0] + name if parent >= 0 else name[1:]
        self.index = len(rec.records)
        rec.records.append([name, time.perf_counter_ns(), 0, parent, self.uid])
        rec.stack.append(self.index)
        self.prof = None
        if torch.autograd._profiler_enabled():
            self.prof = torch.profiler.record_function(PREFIX + name)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.prof is not None:
            self.prof.__exit__(*exc)
        rec = self.rec
        rec.records[self.index][2] = time.perf_counter_ns()
        rec.stack.pop()
        return False


_rec = Recorder()


def start() -> None:
    """Clear the recorder and turn it on."""
    global _rec
    _rec = Recorder(on=True)


def stop() -> list[tuple]:
    """Turn the recorder off and return its records (spans still open keep
    ``t1_ns`` 0)."""
    global _rec
    rec, _rec = _rec, Recorder()
    return [tuple(r) for r in rec.records]


def enabled() -> bool:
    return _rec.on


def span(name: str, uid=None):
    """A span around the ``with`` block (module docstring)."""
    if not _rec.on:
        return OFF
    return _Span(_rec, name, uid)


def mark(name: str, uid, t0_ns: int, t1_ns: int, parent: int = -1) -> None:
    """Record a span stamped elsewhere (no profiler range)."""
    if _rec.on:
        _rec.records.append((name, t0_ns, t1_ns, parent, uid))


def submitted(uid) -> None:
    """A request entered the queue."""
    if _rec.on:
        _rec.submit[uid] = time.perf_counter_ns()


def bound(uid) -> None:
    """A request was bound to a slot: closes its ``request.queued``."""
    rec = _rec
    if not rec.on:
        return
    t = time.perf_counter_ns()
    t0 = rec.submit.pop(uid, None)
    if t0 is not None:
        mark("request.queued", uid, t0, t, rec.enclosing(ROUND))
    rec.bind[uid] = t


def first_token(uid) -> None:
    """A request emitted its first token: closes its ``request.prefill``."""
    rec = _rec
    if not rec.on:
        return
    t = time.perf_counter_ns()
    t0 = rec.bind.pop(uid, None)
    if t0 is not None:
        mark("request.prefill", uid, t0, t)
    rec.first[uid] = t


def finished(uid) -> None:
    """A request finished: closes its ``request.decode``."""
    rec = _rec
    if not rec.on:
        return
    t0 = rec.first.pop(uid, None)
    if t0 is not None:
        mark("request.decode", uid, t0, time.perf_counter_ns())
