"""The program's spans read against the profiler's timeline
(``lib/spans.join``) and against their own records (the span readers), on
synthetic traces and records; and that an untraced run records no span."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench.lib import spans  # noqa: E402

US = 1e-6


def x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def prog(name, ts, dur):
    return x("user_annotation", "repro_torch." + name, ts, dur)


SERVE = [
    x("user_annotation", "h100bench.window", 0, 1000),
    x("user_annotation", "h100bench.step", 0, 600),  # the harness's: never a program span
    prog("serve.round", 0, 600),
    prog("serve.admit", 0, 50),
    prog("serve.decode", 50, 450),
    prog("serve.decode.pack", 50, 50),
    prog("serve.decode.launch", 100, 20),
    prog("serve.decode.wait", 120, 280),
    prog("serve.decode.emit", 400, 100),
    prog("serve.finish", 500, 100),
    prog("store.update", 500, 100),
    prog("store.mix", 510, 30),
    x("cuda_runtime", "cudaMemcpyAsync", 30, 2, corr=9),
    x("cuda_runtime", "cudaGraphLaunch", 110, 5, corr=7),
    x("cuda_runtime", "cudaLaunchKernel", 520, 3, corr=8),
    x("gpu_memcpy", "Memcpy HtoD", 40, 10, corr=9),
    # a replay's two kernels carry the correlation of its cudaGraphLaunch
    x("kernel", "k1", 130, 100, corr=7, tid=7),
    x("kernel", "k2", 250, 100, corr=7, tid=7),
    x("kernel", "graph_mix", 540, 40, corr=8, tid=7),
    # launched before the profiler started: no launch in the trace
    x("kernel", "early", 0, 20, corr=3, tid=7),
    x("cpu_op", "aten::mm", 10, 5),
]


def test_idle_goes_to_the_innermost_span_open_on_the_host():
    j = spans.join(SERVE)
    want = {"serve.admit": 20, "serve.decode.pack": 50, "serve.decode.launch": 20,
            "serve.decode.wait": 80, "serve.decode.emit": 100, "store.update": 30,
            "store.mix": 30, "outside": 400}
    assert j["idle_self"] == pytest.approx({k: v * US for k, v in want.items()})
    assert j["idle_s"] == pytest.approx(730 * US)
    assert j["idle_in"]["store.update"] == pytest.approx(60 * US)
    assert j["idle_in"]["serve.round"] == pytest.approx(330 * US)
    assert j["idle_spans"][0] == ["outside", pytest.approx(400 * US)]
    assert len(j["idle_spans"]) == 8
    # serve.round, serve.decode, serve.finish and store.update enclose others
    assert j["idle_leaf_share"] == pytest.approx(700 / 730)


def test_device_work_goes_to_the_span_of_its_launch():
    j = spans.join(SERVE)
    assert j["device_self"] == pytest.approx({"serve.decode.launch": 200 * US,
                                              "store.mix": 40 * US, "serve.admit": 10 * US})
    assert j["device_in"]["serve.round"] == pytest.approx(250 * US)
    assert j["device_in"]["store.update"] == pytest.approx(40 * US)
    assert j["launched_s"] == pytest.approx(250 * US)
    assert j["unlaunched_s"] == pytest.approx(20 * US)
    assert j["count_in"]["serve.round"] == 1 and "h100bench.step" not in j["count_in"]


def test_nested_spans_that_share_a_start_keep_the_longer_outside():
    ev = [x("user_annotation", "h100bench.window", 0, 100), prog("a", 0, 100),
          prog("a.wait", 0, 40), x("kernel", "k", 60, 40, corr=1)]
    j = spans.join(ev)
    assert j["idle_self"] == pytest.approx({"a.wait": 40 * US, "a": 20 * US})
    assert j["unlaunched_s"] == pytest.approx(40 * US)


def test_device_times_are_moved_onto_the_host_clock_by_the_blocking_copies():
    # the device's clock reads 300 us late: the replay really ran at [155, 455)
    # and its read-back at [455, 460), which the host's call saw end at 460
    ev = [x("user_annotation", "h100bench.window", 0, 2000),
          prog("serve.decode.launch", 100, 100), prog("serve.decode.wait", 200, 300),
          prog("serve.decode.emit", 500, 100),
          x("cuda_runtime", "cudaGraphLaunch", 110, 80, corr=1),
          x("cuda_runtime", "cudaMemcpyAsync", 210, 250, corr=2),
          x("kernel", "k", 455, 300, corr=1), x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                                              755, 5, corr=2)]
    j = spans.join(ev)
    assert j["clock_offset_ms"] == pytest.approx([0.3, 0.3])
    assert j["idle_self"] == pytest.approx({"outside": 1500 * US, "serve.decode.launch": 55 * US,
                                            "serve.decode.wait": 40 * US,
                                            "serve.decode.emit": 100 * US})
    assert j["device_self"]["serve.decode.launch"] == pytest.approx(300 * US)


def test_without_the_window_range_it_raises():
    with pytest.raises(RuntimeError):
        spans.join([prog("a", 0, 1)])


TRAIN = [
    x("user_annotation", "h100bench.window", 0, 1000),
    prog("train.upload", 0, 50),
    prog("train.step", 50, 850),
    prog("train.grads", 50, 550),
    prog("train.mix", 600, 100),
    prog("train.optimizer", 700, 200),
    x("cuda_runtime", "cudaMemcpyAsync", 10, 2, corr=1),
    x("cuda_runtime", "cudaLaunchKernel", 100, 2, corr=2, tid=2),  # the autograd thread
    x("cuda_runtime", "cudaLaunchKernel", 650, 2, corr=3),
    x("cuda_runtime", "cudaLaunchKernel", 750, 2, corr=4),
    x("cuda_runtime", "cudaLaunchKernel", 800, 2, corr=5),
    x("gpu_memcpy", "Memcpy HtoD", 20, 20, corr=1),
    x("kernel", "bwd", 100, 300, corr=2),
    x("kernel", "mix", 650, 80, corr=3),
    x("kernel", "adam", 750, 50, corr=4),
    x("kernel", "adam", 810, 60, corr=5),
]


def train_run():
    return {"kind": "train", "trace": {"spans": spans.join(TRAIN)}}


def test_train_readers_take_device_ms_per_span():
    assert spans.train_mix_ms(train_run()) == pytest.approx(0.08)
    assert spans.train_optimizer_ms(train_run()) == pytest.approx(0.11)
    j = train_run()["trace"]["spans"]
    four = sum(j["device_in"].get(n, 0.0) for n in
               ("train.grads", "train.mix", "train.optimizer", "train.upload"))
    assert four == pytest.approx(j["launched_s"])


RECORDS = [
    ("serve.round", 1_000_000, 11_000_000, -1, None),
    ("serve.decode", 2_000_000, 9_000_000, 0, None),
    ("serve.decode.wait", 3_000_000, 7_000_000, 1, None),
    ("serve.finish", 9_000_000, 10_500_000, 0, None),
    ("store.update", 9_000_000, 10_500_000, 3, None),
    ("store.delays", 9_000_000, 9_500_000, 4, None),
    ("store.delays.wait", 9_100_000, 9_400_000, 5, None),
    ("request.queued", 500_000, 1_500_000, 0, 1),
    ("request.queued", 600_000, 3_600_000, 0, 2),
    ("serve.round", 20_000_000, 22_000_000, -1, None),
]


def test_host_readers_on_the_records():
    run = {"kind": "serve", "spans": RECORDS, "trace": {"spans": spans.join(SERVE)}}
    assert spans.round_host_ms(run) == pytest.approx((10 - 4 - 0.3 + 2) / 2)
    assert spans.admit_wait_p95_ms(run) == pytest.approx(1 + 0.95 * 2)
    assert spans.update_host_ms(run) == pytest.approx(1.5)
    assert spans.update_idle_ms(run) == pytest.approx(0.06)
    assert spans.train_mix_ms(run) is None


@pytest.mark.parametrize("name", ["round_host_ms", "admit_wait_p95_ms", "update_host_ms",
                                  "update_idle_ms", "train_mix_ms", "train_optimizer_ms"])
def test_a_run_without_spans_reads_nothing(name):
    for run in ({"kind": "serve", "trace": None}, {"kind": "serve", "spans": [], "trace": {}}):
        assert getattr(spans, name)(run) is None


def batcher_records():
    """The records of a small CPU batcher run with an adapter store: the
    spans the program opens, without the harness around them."""
    import numpy as np

    from repro_torch import tracing
    from repro_torch.configs import get
    from repro_torch.core import band_graph
    from repro_torch.models import TransformerLM
    from repro_torch.serve import ContinuousBatcher, Request
    from repro_torch.serve.adapters import TaskAdapterStore

    cfg = get("multitask_lm", smoke=True)
    model = TransformerLM(cfg, device="cpu", seed=0)
    store = TaskAdapterStore(model, band_graph(cfg.num_tasks, 1), max_delay=2, seed=1)
    bt = ContinuousBatcher(model, num_slots=2, max_seq=32, prefill_chunk=8, adapters=store)
    rng = np.random.default_rng(0)
    tracing.start()
    try:
        for i, (n, k) in enumerate([(5, 3), (7, 2), (3, 4)]):
            bt.submit(Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                              max_new=k, task_id=i % cfg.num_tasks))
        steps = 0
        while bt.queue or bt.slots.any_live():
            bt.step()
            steps += 1
    finally:
        recs = tracing.stop()
    return recs, steps


def test_readers_and_script_on_a_batcher_run(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import span_profile

    recs, steps = batcher_records()
    run = {"kind": "serve", "spans": recs, "trace": None}
    rounds = [(t1 - t0) * 1e-6 for n, t0, t1, _, _ in recs if n == "serve.round"]
    assert len(rounds) == steps
    assert 0 < spans.round_host_ms(run) <= max(rounds)
    assert spans.admit_wait_p95_ms(run) > 0 and spans.update_host_ms(run) > 0
    assert spans.update_idle_ms(run) is None and spans.train_mix_ms(run) is None
    longest = span_profile.longest_rounds(recs, k=2)
    assert [r["ms"] for r in longest] == sorted(rounds, reverse=True)[:2]
    assert sum(longest[0]["children_ms"].values()) <= longest[0]["ms"]
    means = span_profile.span_ms(recs)
    assert {"serve.round", "serve.admit", "serve.finish", "store.update",
            "request.queued"} <= set(means)
    assert means["serve.round"] == pytest.approx(sum(rounds) / steps, abs=1e-4)
    assert span_profile.record_bytes(recs) >= 56 * len(recs)


def rehearse(capsys, monkeypatch, main, *argv):
    """A rehearsal of the train cell with a 1 s window: training's check
    reads set-up's steps, so the window may be short (a serving cell's
    check needs a request finished in the window, PERF.md §7 item 10)."""
    from h100bench.lib import common

    loaded = set(common.forbidden_modules())
    guard = common.forbidden_modules
    monkeypatch.setattr(common, "forbidden_modules",
                        lambda: [m for m in guard() if m not in loaded])
    monkeypatch.chdir(ROOT)
    rc = main(["--workload", "mtlm.train", "--seed", str(2**31 + 7), "--seconds", "1",
               "--rehearse", *argv])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return [json.loads(line) for line in out.out.strip().splitlines()[-2:]]


def test_an_untraced_run_records_no_span(capsys, monkeypatch):
    from h100bench import run
    from repro_torch import tracing

    res = rehearse(capsys, monkeypatch, run.main, "--trace", "0")[-1]
    assert res["correct"] is True
    assert not tracing.enabled() and tracing.stop() == []


def test_span_profile_reads_the_host_spans_in_a_rehearsal(capsys, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import span_profile

    from h100bench.lib import trace
    from repro_torch import tracing

    plain = trace.Tracer
    res, out = rehearse(capsys, monkeypatch, span_profile.main, "--trace", "0")
    assert res["correct"] is True
    # the harness's tracer is put back and the recorder left off
    assert trace.Tracer is plain and not tracing.enabled()
    counts = out["span_counts"]
    assert counts["train.step"] == counts["train.mix"] == counts["train.optimizer"] > 0
    assert counts["train.upload"] == counts["train.step"]
    assert counts["train.grads"] % counts["train.step"] == 0
    assert out["records"] == sum(counts.values())
    assert "round_host_ms" not in out and "train_mix_ms" not in out
