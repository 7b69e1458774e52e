"""The graph audit's card-only checks (repro_torch.analysis.graph_audit) on
the olmo_1b smoke config with the kernel backend, dense and paged: A001
(a content-varying batcher run captures each step kind once and replays
it), A004 (a replayed dispatch is one cudaGraphLaunch and two
cudaMemcpyAsync; a step body makes no tensor from host data), A005's
peak-memory bound, A007 (a decode tick and a prefill chunk run eagerly
under torch.cuda.set_sync_debug_mode("error")), the A003 ids probe in a
child process, the graph mix's launches per dtype group, and the CLI's
whole audit on the card. Needs a CUDA device and skips without one;
imports no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_analysis.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import graph_audit  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(cuda):
    return graph_audit.audit_model("olmo_1b", "kernel", cuda)


def _paging(paged):
    return graph_audit.audit_spec() if paged else None


@pytest.mark.parametrize("paged", [False, True])
def test_a001_one_capture_per_step_kind_and_a004_replay_copies(model, paged):
    findings, report = graph_audit.audit_captures(model, _paging(paged))
    assert findings == [], [f.format() for f in findings]
    assert report["captures"] == 2 and report["dispatches"] > 2
    assert report["replay"]["cudaGraphLaunch"] == 1
    assert report["replay"]["cudaMemcpyAsync"] == 2


@pytest.mark.parametrize("paged", [False, True])
def test_a004_a005_no_host_data_and_bounded_peak(model, paged):
    findings, report = graph_audit.audit_in_place(model, _paging(paged))
    assert findings == [], [f.format() for f in findings]
    for step in ("prefill", "decode"):
        assert report[step]["host_data_tensors"] == 0
        assert report[step]["extra_peak_bytes"] <= graph_audit.TICK_WORKSPACE_BYTES


@pytest.mark.parametrize("paged", [False, True])
def test_a007_no_host_sync_in_a_step_body(model, paged):
    findings, report = graph_audit.audit_sync(model, _paging(paged))
    assert findings == [], [f.format() for f in findings]
    assert report == {"prefill": "no sync", "decode": "no sync"}


def test_a007_catches_a_sync(model, monkeypatch):
    """The window sees a sync placed in the step body."""
    real = model._embed

    def syncing(batch):
        batch["tokens"].max().item()
        return real(batch)

    monkeypatch.setattr(model, "_embed", syncing)
    findings, _ = graph_audit.audit_sync(model, None)
    assert {f.rule for f in findings} == {"A007"}


@pytest.mark.parametrize("paged", [False, True])
def test_a002_kernel_counts_do_not_grow_with_the_chunk(model, paged):
    findings, report = graph_audit.audit_op_counts(model, _paging(paged))
    assert findings == [], [f.format() for f in findings]
    k4, k8 = report["prefill_kernels_c4"], report["prefill_kernels_c8"]
    assert min(k4, k8) > 0 and abs(k8 - k4) < report["decode_kernels_[2, 5]"]


def test_a003_ids_probe_in_a_child_process(cuda):
    findings, report = graph_audit.probe_ids_child(cuda, ("kernel", "plain"))
    assert findings == [], [f.format() for f in findings]
    assert report["exit"] == 0
    assert report["kernel,paged"]["decode"] == {"finite": True, "bit_identical": True}


def test_graph_mix_one_launch_per_dtype_group(cuda):
    findings, report = graph_audit.audit_graph_mix(cuda)
    assert findings == [], [f.format() for f in findings]
    assert report["launches"] == report["dtype_groups"] == 2


def test_whole_audit_on_the_card_is_clean(cuda):
    findings, report = graph_audit.run_audit(cuda, backends=("kernel",))
    assert findings == [], [f.format() for f in findings]
    assert report["checks"]["A001[olmo_1b full,kernel,paged]"]["captures"] == 2
