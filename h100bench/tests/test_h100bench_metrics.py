"""The metric arithmetic on synthetic logs: whole-window rates, tails over
all requests, censored waits; operations and bytes; the trace's reduction."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench.lib import common, flops, trace  # noqa: E402
from h100bench.lib.serve import Rec  # noqa: E402

BENCH = ROOT / "h100bench"


def read(name, run):
    return common.reader(BENCH, name)(run)


def serve_run():
    reqs = [
        Rec(due=0.0, prompt_len=10, submit=0.01, admit=0.1, first=0.5, last=1.5, ntok=11,
            done=True),
        Rec(due=1.0, prompt_len=10, submit=1.0, admit=1.2, first=1.4, last=1.9, ntok=6, done=True),
        Rec(due=2.0, prompt_len=10, submit=2.3, admit=3.0, first=3.5, last=4.0, ntok=3),
        # still queued when the window (10 s) closed: censored at the close
        Rec(due=8.0, prompt_len=10, submit=8.0),
        # never submitted: lags, waits and has no token
        Rec(due=9.5, prompt_len=10),
    ]
    return {"kind": "serve", "seconds": 10.0, "requests": reqs, "bench": BENCH,
            "counters": {"prefill_tokens": 40, "prefill_dispatches": 5, "decode_dispatches": 4,
                         "decode_s": 0.2},
            "spec": {"server": {"num_slots": 4, "prefill_chunk": 8}},
            "work": {"ops": 67e12 * 2.5}, "setup_s": 12.5, "trace": None}


def test_ttft_counts_every_due_request_and_censors_at_the_close():
    waits = [0.5, 0.4, 1.5, 2.0, 0.5]
    assert read("ttft_p95_s", serve_run()) == pytest.approx(np.percentile(waits, 95))


def test_tpot_over_completed_requests_only():
    per = [(1.5 - 0.5) / 10 * 1e3, (1.9 - 1.4) / 5 * 1e3]
    assert read("tpot_p95_ms.open", serve_run()) == pytest.approx(np.percentile(per, 95))


def test_rates_are_taken_over_the_whole_window():
    assert read("output_tok_s", serve_run()) == pytest.approx(20 / 10.0)
    assert read("serve_mfu", serve_run()) == pytest.approx(25.0)
    train = {"kind": "train", "seconds": 4.0, "steps": 3, "tokens": 3 * 32 * 1024,
             "work": {"ops": 67e12}, "trace": None}
    assert read("train_tok_s", train) == pytest.approx(3 * 32 * 1024 / 4.0)
    assert read("train_mfu", train) == pytest.approx(25.0)
    assert read("ttft_p95_s", train) is None and read("train_tok_s", serve_run()) is None


def test_waits_lags_and_counters():
    run = serve_run()
    assert read("queue_wait_p95_s", run) == pytest.approx(
        np.percentile([0.1, 0.2, 1.0, 2.0, 0.5], 95))
    assert read("arrival_lag_p95_ms", run) == pytest.approx(
        np.percentile([10.0, 0.0, 300.0, 0.0, 500.0], 95))
    assert read("prefill_row_share.open", run) == pytest.approx(100 * 40 / (5 * 4 * 8))
    assert read("decode_dispatch_ms", run) == pytest.approx(50.0)
    assert read("setup_s", run) == 12.5
    assert read("device_idle_pct.serve", run) is None  # no trace, no device metric


def test_operations_and_bytes():
    c = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
         "d_ff": 16, "vocab_size": 10, "norm_kind": "rmsnorm"}
    n = 2 * (2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16) + 8 * 10
    assert flops.matmul_params(c) == n
    assert flops.token_ops(c, 3, 12.0) == 3 * 2 * n + 4 * 2 * 2 * 4 * 12
    assert flops.prefill_rows(0, 150, 64) == [(0, 64), (64, 64), (128, 22)]
    assert flops.prefill_rows(32, 40, 64) == [(32, 8)]
    # decode: K and V of every visible position, once
    kv = 2 * 1 * 4 * 4
    nbytes = 2 * (kv * (5 + 7) + 2 * 2 * 4 * 4 * 2)
    assert flops.decode_attn_bound(c, [5, 7]) == pytest.approx(
        max(nbytes / 3.35e12, 4 * 2 * 2 * 4 * 12 / 67e12))
    assert flops.store_width({**c, "num_layers": 12, "d_model": 1024, "vocab_size": 32000},
                             8) == 426240
    assert flops.graph_mix_bound(256, 426240) == pytest.approx(2 * 256**2 * 426240 / 67e12)


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "h100bench.window", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "h100bench.step", "ts": 0, "dur": 500},
        {"ph": "X", "cat": "user_annotation", "name": "h100bench.update", "ts": 550, "dur": 250},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 150, "dur": 150},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 600, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 990, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10, "dur": 5},
    ]
    r = trace.reduce(ev)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx((200 + 100 + 10) * 1e-6)  # clipped to the window
    assert r["device_ops"][0] == ["gemm", pytest.approx(250e-6)]
    gaps = dict((round(s * 1e6), n) for n, s in r["idle_gaps"])
    assert gaps == {300: "step", 100: "step", 290: "host"}
