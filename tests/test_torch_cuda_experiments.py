"""The port's five examples and the experiment runner's kernels entry on the
card: every example runs on CUDA at its default size (train_multitask_lm
for 3 steps), serve_batched's parity booleans hold with its attention
kernels launched, and ``python -m repro_torch.experiments --only kernels``
launches the graph-mix kernel once and matches its plain version. Needs a
CUDA device and skips without one; imports no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_experiments.py``."""
import contextlib
import io
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (  # noqa: E402
    consensus_vs_multitask,
    learn_the_graph,
    quickstart,
    serve_batched,
    train_multitask_lm,
)
from repro_torch.experiments import common, run  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.graph_mix import ops as mix_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _main(module, argv=(), **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return module.main(list(argv), **kw)


def test_paper_examples_run_on_the_card(cuda):
    q = _main(quickstart)
    f_star = q["f_star"]
    for name in ("BSR (batch, solve regularizer)", "BOL (batch, optimize loss)"):
        assert abs(q["methods"][name][1] - f_star) <= 3e-4
    c = _main(consensus_vs_multitask)
    assert c["consensus_spread"] <= 1e-6
    assert [s[1] for s in c["spreads"]] == sorted((s[1] for s in c["spreads"]), reverse=True)
    g = _main(learn_the_graph)
    assert g["risks"]["oracle graph"] < g["risks"]["no coupling"]
    assert g["within"] > g["across"]


def test_train_multitask_lm_runs_on_the_card(cuda):
    t = _main(train_multitask_lm, ["--steps", "3"])
    assert [h["step"] for h in t["history"]] == [0, 1, 2]
    assert all(math.isfinite(h["loss"]) for h in t["history"]) and t["tok_s"] > 0


def test_serve_batched_parities_hold_with_the_kernels(cuda):
    ops = (dec_ops.decode_attention, pre_ops.prefill_attention, dec_ops.paged_decode_attention,
           pre_ops.paged_prefill_attention)
    for op in ops:
        op.launches = 0
    s = _main(serve_batched)
    for k in ("batcher_match", "paged_match", "scan_match", "kernel_match", "sla_match",
              "prefix_match"):
        assert s[k] is True, k
    assert max(s["cross_check"].values()) <= 2e-5
    assert all(op.launches > 0 for op in ops), [op.launches for op in ops]


def test_run_kernels_entry_launches_the_graph_mix_kernel(cuda, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "REPORTS", tmp_path)
    mix_ops.graph_mix.launches = 0
    out = run.main(["--only", "kernels"])
    assert mix_ops.graph_mix.launches == 1
    derived = out["kernels"][1]
    assert "route=cuda kernel" in derived
    assert float(derived.split("graph_mix_max_err=")[1].split(",")[0]) <= 1e-4
    assert "SUMMARY,kernels," in capsys.readouterr().out
