"""The one traffic generator: it reads a mix's parameters (a JSON file under
``h100bench/traffic/``) and makes the requests or training batches of one
seed.

Sizes: every seed draws its requests' prompt and answer lengths from one
pool, the ``pool`` quantiles (i + 0.5) / pool of each clipped lognormal, in
an order of its own: the pool permuted whole by the seed (prompts and
answers apart), and permuted again for each further pool's worth of
requests. Locally the lengths are as unordered as independent draws; over a
pool every seed serves the same sizes. Tenants (task ids) and prompt tokens
are drawn from the seed.

Arrivals are made by the mix's arrival kind, a module of
``h100bench/arrivals/`` found by its name (``arrivals/<kind>.py``, whose
``source(params, stream, seconds)`` returns the requests' source for one
window). ``poisson`` is a Poisson process conditioned on its count: round(rate
x seconds) arrivals at independent uniform times of the window, sorted (the
pool is that count, so a window serves the whole pool); ``backlog`` keeps a
number of requests outstanding.

Serving mixes::

    {"arrival": {"kind": "poisson", "rate": 24.0} | {"kind": "backlog", "outstanding": 48},
     "prompt": {"median": 48, "sigma": 0.7, "min": 8, "max": 256},
     "output": {"median": 32, "sigma": 0.7, "min": 4, "max": 128},
     "tenants": {"zipf_s": 1.1} | null, "pool": 256}

A training mix::

    {"kind": "train", "batch": 32, "seq": 1024, "tenants": {"zipf_s": 1.1},
     "tilt": 0.3}
"""
from __future__ import annotations

import dataclasses
import importlib
from statistics import NormalDist

import numpy as np

_NORMAL = NormalDist()


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal_lengths(spec: dict, n: int) -> np.ndarray:
    """The n clipped lognormal quantiles of ``spec`` (median, sigma, min,
    max), whole tokens, ascending."""
    z = np.array([_NORMAL.inv_cdf(u) for u in quantiles(n)])
    v = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(v, spec["min"], spec["max"]).astype(np.int64)


def zipf_probs(m: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, m + 1) ** s
    return p / p.sum()


def tenant_map(seed: int, m: int) -> np.ndarray:
    """The seeded permutation of the tasks: rank r's task is ``[r]``."""
    return np.random.default_rng([abs(int(seed)), 1]).permutation(m)


@dataclasses.dataclass
class Spec:
    uid: int
    due: float  # seconds from the window's start; 0 for a backlog's
    prompt: np.ndarray  # (S0,) int32
    max_new: int
    task: int


class ServeStream:
    """The requests of one serving mix and seed, made a pool at a time on
    demand (``take(n)``): the sizes of pool j are the pool's quantiles in
    the seed's j-th order."""

    def __init__(self, params: dict, seed: int, vocab: int, num_tasks: int,
                 pool: int | None = None):
        self.p, self.seed, self.vocab, self.m = params, abs(int(seed)), vocab, num_tasks
        self.k = int(pool if pool is not None else params["pool"])
        self.prompt_q = lognormal_lengths(params["prompt"], self.k)
        self.output_q = lognormal_lengths(params["output"], self.k)
        ten = params.get("tenants")
        self.tenant_p = zipf_probs(num_tasks, ten["zipf_s"]) if ten else None
        self.tenants = tenant_map(seed, num_tasks)
        self.specs: list[Spec] = []

    def _pool(self, j: int) -> None:
        rng = np.random.default_rng([self.seed, 2, j])
        prompts = rng.permutation(self.prompt_q)
        outputs = rng.permutation(self.output_q)
        if self.tenant_p is not None:
            tasks = self.tenants[rng.choice(self.m, size=self.k, p=self.tenant_p)]
        else:
            tasks = np.zeros(self.k, np.int64)
        for i in range(self.k):
            self.specs.append(Spec(
                uid=len(self.specs), due=0.0,
                prompt=rng.integers(0, self.vocab, size=int(prompts[i]), dtype=np.int32),
                max_new=int(outputs[i]), task=int(tasks[i])))

    def take(self, n: int) -> list[Spec]:
        while len(self.specs) < n:
            self._pool(len(self.specs) // self.k)
        return self.specs[:n]


class TrainStream:
    """Training batches: each sequence tagged with a Zipf-drawn task and its
    tokens drawn from that task's tilted unigram (the construction of the
    port's ``data.tokens.TokenPipeline``: a shared base of normal logits
    plus ``tilt`` times a per-task normal perturbation, softmaxed)."""

    def __init__(self, params: dict, seed: int, vocab: int, num_tasks: int):
        self.p, self.seed, self.vocab, self.m = params, abs(int(seed)), vocab, num_tasks
        rng = np.random.default_rng([self.seed, 3])
        base = rng.standard_normal(vocab)
        logits = base[None] + params["tilt"] * rng.standard_normal((num_tasks, vocab))
        z = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.cdf = np.cumsum(z / z.sum(axis=1, keepdims=True), axis=1)
        self.cdf[:, -1] = 1.0
        self.tenant_p = zipf_probs(num_tasks, params["tenants"]["zipf_s"])
        self.tenants = tenant_map(seed, num_tasks)

    def batch(self, step: int) -> dict:
        """Batch ``step``: {"tokens", "labels": (B, S) int32, "task_ids": (B,) int32}."""
        b, s = self.p["batch"], self.p["seq"]
        rng = np.random.default_rng([self.seed, 4, step])
        tasks = self.tenants[rng.choice(self.m, size=b, p=self.tenant_p)]
        u = rng.random((b, s + 1))
        tok = np.stack([np.searchsorted(self.cdf[t], u[i], side="right")
                        for i, t in enumerate(tasks)])
        tok = np.minimum(tok, self.vocab - 1).astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:], "task_ids": tasks.astype(np.int32)}


def source(params: dict, seed: int, vocab: int, num_tasks: int, seconds: float):
    """The requests' source of a serving mix for a window of ``seconds``:
    ``arrivals/<kind>.py``'s ``source``. A source offers ``start()`` (the
    requests sent at the window's start), ``due(t)`` (those due by t),
    ``done(uid, t, req)`` (those a completion sends), ``next_due()`` and
    ``unsent(seconds)`` (those due in the window and never sent)."""
    kind = params["arrival"]["kind"]
    mod = importlib.import_module(f"h100bench.arrivals.{kind}")
    return mod.source(params, seed, vocab, num_tasks, seconds)
