"""The arithmetic of the metric readers (``metrics/<name>.py``): each
function takes a run's record and returns the metric, or None when the run
has nothing to read for it."""
from __future__ import annotations

import numpy as np

from h100bench.lib import common, flops
from h100bench.lib.flops import PEAKS


def setup_s(run):
    """Set-up: process start to the window's start (interpreter, imports, the
    kernels from the checkout's build cache, weights from the seed, graph
    captures, warm-up)."""
    return run["setup_s"]


def ttft_p95_s(run):
    """95th percentile, over every request due in the window, of first-token time
    minus due time; a request still without a token when the window closes
    counts with the wait it has had."""
    if run["kind"] != "serve" or not run["requests"]:
        return None
    end = run["seconds"]
    waits = [(r.first if r.first is not None else end) - r.due for r in run["requests"]]
    return float(np.percentile(waits, 95))


def tpot_p95_ms(run):
    """95th percentile, over the requests that completed in the window, of
    (last - first token time) / (tokens - 1), in ms."""
    if run["kind"] != "serve":
        return None
    per = [(r.last - r.first) / (r.ntok - 1) * 1e3 for r in run["requests"]
           if r.done and r.ntok > 1]
    return float(np.percentile(per, 95)) if per else None


def output_tok_s(run):
    """Every token generated in the window, over the window."""
    if run["kind"] != "serve":
        return None
    return sum(r.ntok for r in run["requests"]) / run["seconds"]


def train_tok_s(run):
    """Tokens of the training steps that completed in the window (synchronized at
    its end), over the window."""
    if run["kind"] != "train" or not run["steps"]:
        return None
    return run["tokens"] / run["seconds"]


def arrival_lag_p95_ms(run):
    """How late the load generator submitted: 95th percentile of submit time
    minus due time, in ms, over the requests due in the window (one never
    submitted counts with the lag it had when the window closed)."""
    if run["kind"] != "serve" or not run["requests"]:
        return None
    end = run["seconds"]
    lag = [((r.submit if r.submit is not None else end) - r.due) * 1e3 for r in run["requests"]]
    return float(np.percentile(lag, 95))


def queue_wait_p95_s(run):
    """95th percentile of the time from a request's due time to the start of the
    scheduling round that took it out of the batcher's queue, over the requests
    due in the window (one still queued at the close counts with its wait)."""
    if run["kind"] != "serve" or not run["requests"]:
        return None
    end = run["seconds"]
    w = [(r.admit if r.admit is not None else end) - r.due for r in run["requests"]]
    return float(np.percentile(w, 95))


def prefill_row_share(run):
    """The share of the prefill slab's rows that held a prompt token: the
    batcher's prompt tokens computed over its prefill dispatches times slots
    times the chunk, over the window, in %."""
    if run["kind"] != "serve":
        return None
    c, srv = run["counters"], run["spec"]["server"]
    if not c["prefill_dispatches"]:
        return None
    return 100.0 * c["prefill_tokens"] / (
        c["prefill_dispatches"] * srv["num_slots"] * srv["prefill_chunk"])


def decode_dispatch_ms(run):
    """Host ms a decode dispatch takes in the batcher (its ``decode_s`` over its
    ``decode_dispatches``, from packing the inputs to the read-back that waits
    for the device), over the window."""
    if run["kind"] != "serve" or not run["counters"]["decode_dispatches"]:
        return None
    c = run["counters"]
    return 1e3 * c["decode_s"] / c["decode_dispatches"]


def adapter_update_ms(run):
    """Device ms per adapter-store ``update()`` in the traced window: CUDA events
    recorded on the stream before and after each call."""
    tr = run.get("trace")
    if not tr or not tr.get("update_ms"):
        return None
    return sum(tr["update_ms"]) / len(tr["update_ms"])


def serve_mfu(run):
    """Useful operations over the window (2 N a computed prompt or generated
    token, its attention over its visible context, its adapter products; no
    slab row without a token) over the window times the f32 peak, in %."""
    if run["kind"] != "serve":
        return None
    return 100.0 * run["work"]["ops"] / (run["seconds"] * PEAKS["f32_flops_per_s"])


def train_mfu(run):
    """(6 N T + attention) a step, times the steps of the window, over the window
    times the f32 peak, in %."""
    if run["kind"] != "train" or not run["steps"]:
        return None
    return 100.0 * run["work"]["ops"] / (run["seconds"] * PEAKS["f32_flops_per_s"])


def decode_attn_roofline(run):
    """Decode attention's share of its roofline in the traced window: the least
    time of every traced decode dispatch's live rows (their visible K/V once,
    from the harness's record of each row's context) over the device time of
    the kernels named in ``kernels/decode_attn/``, in %."""
    tr = run.get("trace")
    if not tr or not tr.get("decode_rows"):
        return None
    names = common.kernel_names(run["bench"], "decode_attn")
    busy = sum(s for n, s in tr["ops"] if any(k in n for k in names))
    if busy <= 0:
        return None
    bound = sum(flops.decode_attn_bound(run["arch"], ctxs) for ctxs in tr["decode_rows"].values())
    return 100.0 * bound / busy


def prefill_attn_roofline(run):
    """Prefill attention's share of its roofline in the traced window: the least
    time of the valid rows of every traced prefill dispatch (each admitted
    prompt's chunks from its cached prefix on; the dispatch j of a round holds
    chunk j of each prompt) over the device time of the kernels named in
    ``kernels/prefill_attn/``, in %."""
    tr = run.get("trace")
    if not tr or not tr.get("prefill_rows"):
        return None
    names = common.kernel_names(run["bench"], "prefill_attn")
    busy = sum(s for n, s in tr["ops"] if any(k in n for k in names))
    if busy <= 0:
        return None
    chunk = run["spec"]["server"]["prefill_chunk"]
    bound = 0.0
    for admitted in tr["prefill_rows"]:
        per = [flops.prefill_rows(cached, length, chunk) for cached, length in admitted]
        for j in range(max(len(p) for p in per)):
            bound += flops.prefill_attn_bound(run["arch"], [p[j] for p in per if j < len(p)])
    return 100.0 * bound / busy


def graph_mix_roofline(run):
    """The graph mix's share of its roofline in the traced window: 2 m^2 d
    operations and mu, theta and the output once per launch of a kernel named
    in ``kernels/graph_mix/`` (one launch mixes the store's whole (m, d)
    tree), over those launches' device time, in %."""
    tr = run.get("trace")
    if not tr or "store" not in run["spec"]:
        return None
    names = common.kernel_names(run["bench"], "graph_mix")
    times = [s for n, s in tr["ops"] if any(k in n for k in names)]
    if not times:
        return None
    c = run["arch"]
    width = flops.store_width(c, run["spec"]["store"]["rank"])
    bound = flops.graph_mix_bound(c["num_tasks"], width)
    return 100.0 * bound * len(times) / sum(times)


def device_idle_pct(run):
    """The share of the traced window in which no kernel, copy or set ran on the
    device, from the profiler's timeline, in %."""
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
