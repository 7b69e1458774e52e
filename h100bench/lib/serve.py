"""A serving cell: the port's ``ContinuousBatcher`` driven by the cell's
traffic for one window, then the served tokens of a sample of finished
requests held to the plain reference.

Set-up builds the model, the paged pool, the prefix cache and the adapter
store the cell names, loads the seed's weights (and the store's first
iterate), captures the step pair's CUDA graphs and serves a few warm-up
requests, which replay both graphs, reset slots and, with a store, run
updates at every delay the ring reaches. The window then offers the
traffic: open loop (each request submitted once it is due, latencies from
its due time) or a backlog (a new request each time one completes), one
``step()`` at a time from this one thread.

After the window the store's served rows (``serving``) are held to the
reference's at its final update count.

What the window records, for the metric readers (``run`` below): each
request's due, submit, admission (the start of the round in which it left
the queue), first and last token times and token count; the batcher's and
the prefix cache's counters over the window; the useful work of every
computed token; and, in a traced run, each dispatch's rows and the device
ms of each store update (CUDA events).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from h100bench.lib import common, flops, trace, traffic, weights


@dataclasses.dataclass
class Rec:
    due: float
    prompt_len: int
    submit: float | None = None
    admit: float | None = None
    first: float | None = None
    last: float | None = None
    ntok: int = 0
    done: bool = False
    failed: bool = False
    states: list = dataclasses.field(default_factory=list)


class Recorder:
    """The batcher's ``on_token`` hook: token times, the store's update count
    at each token's dispatch, the visible context of each decode row."""

    def __init__(self, store):
        self.store = store
        self.recs: dict[int, Rec] = {}
        self.batcher = None
        self.decode_ctx = 0  # sum of the visible keys of the window's decode rows
        self.decode_rows = 0
        self.traced: dict = {}  # dispatch -> [ctx] of the rows traced
        self.admitted: list = []  # [(cached, prompt length)] of every admitting round
        self.tracer = None
        self.live = False

    def __call__(self, req, tok):
        r = self.recs.get(req.uid)
        if r is None:
            return
        t = time.perf_counter()
        if r.first is None:
            r.first = t
        r.last = t
        r.ntok += 1
        if self.store is not None:
            r.states.append(self.store.updates)
        n = len(req.out)
        if n >= 2 and self.live:  # a decode row: it read its whole context
            ctx = r.prompt_len + n - 1
            self.decode_ctx += ctx
            self.decode_rows += 1
            if self.tracer is not None and self.tracer.active:
                self.traced.setdefault(self.batcher.decode_dispatches, []).append(ctx)


def build(c: dict, spec: dict, seed: int, device):
    """(model, batcher, store, recorder) of a serving cell."""
    import torch
    from repro_torch.core.graph import TaskGraph
    from repro_torch.models.model import TransformerLM
    from repro_torch.serve.adapters import TaskAdapterStore
    from repro_torch.serve.batching import ContinuousBatcher
    from repro_torch.serve.paging import PagingSpec

    from h100bench.reference import mixing

    model = TransformerLM(common.arch_config(c), device=device, dtype=torch.float32, seed=0)
    weights.load_into(model, c, seed)
    srv = spec["server"]
    bs = srv["block_size"]
    paging = PagingSpec(block_size=bs, num_blocks=srv["pool_tokens"] // bs + 1,
                        max_blocks_per_slot=srv["max_seq"] // bs)
    store = None
    if "store" in spec:
        st = spec["store"]
        graph = TaskGraph(mixing.band_adjacency(c["num_tasks"], st["bandwidth"]))
        store = TaskAdapterStore(model, graph, rank=st["rank"], mixing=st["mixing"],
                                 eta=st["eta"], tau=st["tau"], alpha=st["alpha"],
                                 max_delay=st["max_delay"], fixed_delay=st["fixed_delay"],
                                 update_every=st["update_every"], seed=0)
        store.set_raw(weights.store_tree(weights.adapters(c, store_params(c, st), seed, device)))
    rec = Recorder(store)
    batcher = ContinuousBatcher(model, num_slots=srv["num_slots"], max_seq=srv["max_seq"],
                                prefill_chunk=srv["prefill_chunk"], policy=srv["policy"],
                                chunk_budget=srv.get("chunk_budget"), paging=paging,
                                prefix_cache=srv["prefix_cache"], adapters=store, on_token=rec)
    rec.batcher = batcher
    return model, batcher, store, rec


def store_params(c: dict, st: dict) -> dict:
    return {**st, "num_tasks": c["num_tasks"]}


def _request(spec: traffic.Spec):
    from repro_torch.serve.batching import Request

    return Request(uid=spec.uid, tokens=spec.prompt, max_new=spec.max_new, task_id=spec.task)


def warm_specs(mix: dict, seed: int, c: dict, n: int) -> list:
    """The warm-up: ``n`` requests of the mix's shortest prompt and answer
    (every dispatch has one shape, so short ones warm them all, in the same
    time for every seed), tokens from another stream of the seed."""
    rng = np.random.default_rng([abs(int(seed)), 9])
    lo, out = mix["prompt"]["min"], mix["output"]["min"]
    return [traffic.Spec(uid=0, due=0.0, max_new=out, task=j % c["num_tasks"],
                         prompt=rng.integers(0, c["vocab_size"], size=lo, dtype=np.int32))
            for j in range(n)]


def warm_up(batcher, specs: list) -> None:
    """Capture both graphs, then serve ``specs`` (uids below 0) together to
    completion."""
    batcher.capture()
    for j, s in enumerate(specs):
        req = _request(s)
        req.uid = -1 - j
        batcher.submit(req)
    batcher.run()


def counters(batcher, store) -> dict:
    out = {k: getattr(batcher, k) for k in (
        "prefill_tokens", "prefill_dispatches", "decode_dispatches", "mixed_dispatches",
        "decode_s", "prefill_s", "cow_copies", "admission_waits")}
    if batcher.prefix is not None:
        out["prefix_lookup_tokens"] = batcher.prefix.lookup_tokens
        out["prefix_hit_tokens"] = batcher.prefix.hit_tokens
    if store is not None:
        out["updates"] = store.updates
    return out


def window(torch, batcher, rec, store, source, seconds: float, tracer) -> dict:
    """Offer the traffic of ``source`` (``traffic.source``) for ``seconds``;
    returns what the readers need."""
    reqs: dict[int, object] = {}
    prefill_rows = []  # traced: per admitting round, [(cached, prompt length)]
    update_events = []
    if store is not None and tracer.enabled:
        update = store.update

        def timed_update():
            with tracer.range("update"):
                if tracer.active:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    update()
                    b.record()
                    update_events.append((a, b))
                else:
                    update()
        store.update = timed_update
    before = counters(batcher, store)
    rec.live = True
    t0 = time.perf_counter()
    end = t0 + seconds
    nfin = len(batcher.finished)

    def submit(spec):
        now = time.perf_counter()
        rec.recs[spec.uid] = Rec(due=spec.due, prompt_len=len(spec.prompt), submit=now - t0)
        req = reqs[spec.uid] = _request(spec)
        batcher.submit(req)

    for spec in source.start():
        submit(spec)
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        tracer.poll(now - t0)
        with tracer.range("generator"):
            for spec in source.due(now - t0):
                submit(spec)
        if batcher.queue or batcher.slots.any_live():
            queued = {r.uid for r in batcher.queue}
            ts = time.perf_counter()
            with tracer.range("step"):
                batcher.step()
            left = queued - {r.uid for r in batcher.queue}
            rows = []
            for uid in left:
                if uid in rec.recs:
                    rec.recs[uid].admit = ts - t0
                    req = reqs[uid]
                    rows.append((req.cached_tokens, len(req.tokens)))
            if rows:
                rec.admitted.append(rows)
                if tracer.active:
                    prefill_rows.append(rows)
            done = batcher.finished[nfin:]
            nfin = len(batcher.finished)
            for req in done:
                r = rec.recs.get(req.uid)
                if r is None:
                    continue
                r.done = bool(req.done)
                r.failed = not req.done
                with tracer.range("generator"):
                    for spec in source.done(req.uid, time.perf_counter() - t0, req):
                        submit(spec)
        else:
            with tracer.range("generator"):
                nd = source.next_due()
                wake = min(t0 + nd, end) if nd is not None else end
                time.sleep(max(0.0, wake - time.perf_counter()))
    if batcher.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    rec.live = False
    tracer.stop()
    after = counters(batcher, store)
    # every request due in the window, submitted or not
    due_recs = [r for r in rec.recs.values() if r.due < seconds]
    due_recs += [Rec(due=s.due, prompt_len=len(s.prompt)) for s in source.unsent(seconds)]
    for r in due_recs:
        for k in ("first", "last"):
            if getattr(r, k) is not None:
                setattr(r, k, getattr(r, k) - t0)
    return {"elapsed": elapsed, "requests": due_recs, "reqs": reqs,
            "counters": {k: after[k] - before[k] for k in after},
            "prefill_rows": prefill_rows, "update_events": update_events}


def run(cell, seed: int, seconds: float, tracing: bool, device, rehearse: bool,
        control: bool = False) -> tuple[dict, dict]:
    """One run of a serving cell: (result line without ``checks``, checks)."""
    import torch

    from h100bench.reference import serve as ref_serve

    spec, mix = cell.spec, cell.traffic
    if rehearse:
        spec, mix = common.rehearsal(spec, mix)
    c = cell.arch(rehearse)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, batcher, store, rec = build(c, spec, seed, device)
    cell.mark("model, weights, store")
    src = traffic.source(mix, seed, c["vocab_size"], c["num_tasks"], seconds)
    warm_up(batcher, warm_specs(mix, seed, c, spec["warmup_requests"]))
    cell.mark("captures and warm-up")
    tr = spec.get("trace", {})
    tracer = trace.Tracer(torch, tracing and device.type == "cuda", seconds,
                          min(tr.get("seconds", 3.0), 0.5 * seconds))
    tracer.warm()
    rec.tracer = tracer
    if device.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way, as a server does
    setup_s = time.perf_counter() - cell.t_start
    out = window(torch, batcher, rec, store, src, seconds, tracer)
    dev = common.device_info(torch, device, cell.entry["chips"])
    work = flops.serve_work(c, spec, rec)
    traced = tracer.summary({"prefill_rows": out["prefill_rows"], "decode_rows": rec.traced,
                             "update_events": out["update_events"]})
    run_rec = {"kind": "serve", "arch": c, "spec": spec, "seconds": out["elapsed"],
               "bench": cell.bench, "requests": out["requests"], "counters": out["counters"],
               "work": work, "trace": traced, "setup_s": setup_s, "device": device.type}
    # the sample to check, drawn from the seed among the finished requests
    finished = [(u, r) for u, r in rec.recs.items() if r.done and r.ntok > 0]
    sample = pick_sample(finished, out["reqs"], spec["check"]["sample_tokens"], seed)
    store_p = store_params(c, spec["store"]) if "store" in spec else None
    served = None
    if store is not None:  # the store's served rows after the window, on the host
        served = {"count": store.updates,
                  "rows": {k: v.to("cpu", copy=True)
                           for k, v in weights.store_flat(store.serving, c["num_tasks"]).items()}}
    attempted = len(out["requests"])
    failed = sum(1 for r in out["requests"] if r.failed)
    del batcher, store, rec, out
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = ref_serve.gaps(c, seed, device, sample, store_p, tf32_control=control)
    lim = spec["check"]["limits"]
    checks = {"logit_gap": {"value": readings["logit_gap"], "limit": lim["logit_gap"]}}
    if control:
        checks["control_gap"] = {"value": readings["control_gap"], "limit": lim["logit_gap"]}
    if served is not None:
        st = ref_serve.store_gap(c, store_p, seed, device, served["rows"], served["count"],
                                 control)
        checks["store_rel"] = {"value": st.pop("store_rel"), "limit": lim["store_rel"]}
        checks.update({k: {"value": v, "limit": lim["store_rel"]} for k, v in st.items()})
    correct = (readings["tokens"] > 0 and failed == 0
               and all(checks[k]["value"] <= checks[k]["limit"]
                       for k in ("logit_gap", "store_rel") if k in checks))
    return {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "run": run_rec, "device": dev}, checks


def pick_sample(finished, reqs, target: int, seed: int) -> list[dict]:
    """The longest finished request, then others drawn from the seed, until
    ``target`` served tokens."""
    if not finished:
        return []
    order = sorted(finished, key=lambda ur: -ur[1].ntok)
    first, rest = order[0], order[1:]
    rng = np.random.default_rng([abs(int(seed)), 5])
    picked, total = [first], first[1].ntok
    for j in rng.permutation(len(rest)):
        if total >= target:
            break
        picked.append(rest[j])
        total += rest[j][1].ntok
    out = []
    for uid, r in picked:
        req = reqs[uid]
        out.append({"prompt": np.asarray(req.tokens), "out": np.asarray(req.out),
                    "task": req.task_id, "states": np.asarray(r.states)})
    return out
