"""Every cell of BENCHMARK.json runs end to end on the CPU at its
configuration's smoke size (``--rehearse``), agrees with the plain
reference there, and reports no device metric."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2**31 + 11  # past 32 signed bits, as the driver's are


def run_cell(capsys, monkeypatch, workload, *extra):
    from h100bench import run
    from h100bench.lib import common

    # other test files of this worker may have loaded the JAX package; the
    # guard holds the run to what it loads itself
    loaded = set(common.forbidden_modules())
    guard = common.forbidden_modules
    monkeypatch.setattr(common, "forbidden_modules",
                        lambda: [m for m in guard() if m not in loaded])
    monkeypatch.chdir(ROOT)
    rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", "6",
                   "--rehearse", *extra])
    captured = capsys.readouterr()
    assert rc == 0, captured.err[-2000:]
    return json.loads(captured.out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearses_correct_without_device_metrics(capsys, monkeypatch, workload):
    res = run_cell(capsys, monkeypatch, workload, "--trace", "0")
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0, res
    assert res["device"]["platform"] == "cpu"
    names = set(res["metrics"])
    ends = {m["name"] for m in MANIFEST["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert "setup_s" in names and len(names & ends) >= 2
    device = {m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]
              if m["source"] == "device_trace"}
    assert not names & device
    assert list(res)[-1] == "checks" and res["checks"]
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]


def test_traced_rehearsal_reports_per_layer_metrics(capsys, monkeypatch):
    res = run_cell(capsys, monkeypatch, "mtlm.tenants-online", "--trace", "1")
    assert res["correct"] is True
    assert {"queue_wait_p95_s", "tpot_p95_ms.open", "prefill_row_share.open",
            "decode_dispatch_ms", "arrival_lag_p95_ms"} <= set(res["metrics"])
    assert "ttft_p95_s" not in res["metrics"]
    assert not any("roofline" in k or "mfu" in k or "idle" in k for k in res["metrics"])
