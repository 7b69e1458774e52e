"""The dry run's cost model, roofline and hill-climb on H100 terms
(``repro_torch.launch.costmodel`` / ``roofline`` / ``hillclimb``), CPU:

  * ``param_counts`` and ``model_flops`` equal the reference's
    ``benchmarks/costmodel.py`` for every architecture and input shape (and
    for mixed block patterns);
  * the roofline of a dense combination's dry-run record: its terms priced
    on the H100's constants, a 16 x 16 mesh's wire bytes on the network
    (groups of 16 ranks), the probes' extrapolation within 1 % of the
    full-depth record; the CLI writes its CSV and table;
  * ``hillclimb --microbatch 2`` at one period of olmo_1b's train_4k cuts
    the step's temp bytes at equal FLOPs;
  * no constant of the reference's accelerator is left in the port's
    cost model or roofline."""
import dataclasses
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import costmodel as jcost  # noqa: E402
from repro.configs import get as jax_get  # noqa: E402
from repro.launch.specs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402

from repro_torch.configs import get, list_archs  # noqa: E402
from repro_torch.launch import costmodel, dryrun, hillclimb, roofline  # noqa: E402
from repro_torch.launch.specs import INPUT_SHAPES  # noqa: E402

ARCHS = [a for a in list_archs() if a != "multitask_linreg"]
MIXED = [("mixtral_8x22b", ("attn", "attn_moe")), ("zamba2_7b", ("mamba", "attn", "shared_attn")),
         ("xlstm_350m", ("mlstm", "attn", "slstm"))]


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """The dry run's fake process group lives in this process: gone after
    the module."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _configs(arch, pattern=None):
    over = {} if pattern is None else {"pattern": pattern}
    return (dataclasses.replace(jax_get(arch), **over), dataclasses.replace(get(arch), **over))


@pytest.mark.parametrize("arch,pattern", [(a, None) for a in ARCHS] + MIXED,
                         ids=ARCHS + ["-".join((a, *p)) for a, p in MIXED])
def test_counts_equal_the_reference_cost_model(arch, pattern):
    j, t = _configs(arch, pattern)
    assert costmodel.param_counts(t) == pytest.approx(jcost.param_counts(j), rel=1e-12)
    for name, shape in INPUT_SHAPES.items():
        assert costmodel.model_flops(t, shape) == pytest.approx(
            jcost.model_flops(j, JAX_SHAPES[name]), rel=1e-12), name


def test_h100_constants():
    hw = costmodel.H100
    assert (hw.peak_flops, hw.peak_flops_f32, hw.hbm_bw) == (989.4e12, 67e12, 3.35e12)
    assert (hw.nvlink_bw, hw.nvlink_ranks, hw.network_bw) == (450e9, 8, 50e9)


def test_no_constant_of_the_reference_accelerator():
    for name in ("costmodel", "roofline"):
        text = (ROOT / "src" / "repro_torch" / "launch" / f"{name}.py").read_text()
        assert not re.search(r"197e12|819e9|tpu", text), name


@pytest.fixture(scope="module")
def olmo_decode(tmp_path_factory):
    """olmo_1b decode_32k on the 16 x 16 fake mesh with its probes, as
    ``python -m repro_torch.launch.dryrun --probes`` writes it."""
    out = tmp_path_factory.mktemp("dryrun") / "singlepod"
    return dryrun.run_one("olmo_1b", "decode_32k", False, True, str(out)), out


def test_roofline_terms_and_probe_check(olmo_decode):
    rec, _ = olmo_decode
    row = roofline.analyse_record(rec)
    sc, hw = rec["scanned"], costmodel.H100
    assert row.compute_s == sc["cost"]["flops"] / hw.peak_flops
    assert row.memory_s == sc["cost"]["bytes_accessed"] / hw.hbm_bw
    # 16 x 16: every collective's group has 16 ranks, past one 8-card node
    assert set(sc["wire_bytes_by_group"]) == {"16"}
    assert sum(sc["wire_bytes_by_group"].values()) == sc["collectives"]["total_wire_bytes"]
    assert row.nvlink_s == 0 and row.network_s == sc["collectives"]["total_wire_bytes"] / 50e9
    assert row.collective_s == row.network_s
    assert row.bottleneck == max(("compute", row.compute_s), ("memory", row.memory_s),
                                 ("collective", row.collective_s), key=lambda t: t[1])[0]
    assert 0 < row.useful_frac and row.mem_device_gib > 0
    assert row.model_flops_global == costmodel.model_flops(get("olmo_1b"),
                                                           INPUT_SHAPES["decode_32k"])
    # the reference's probe extrapolation against the exact full-depth record
    assert abs(row.probe_flops_rel) <= 0.01
    assert abs(row.probe_wire_rel) <= 0.01


def test_roofline_groups_of_eight_ride_nvlink():
    part = {"collectives": {"total_wire_bytes": 3}, "wire_bytes_by_group": {"8": 900, "16": 100}}
    assert roofline.collective_seconds(part) == (900 / 450e9, 100 / 50e9)


def test_roofline_cli_writes_csv_and_table(olmo_decode, tmp_path, capsys):
    _, directory = olmo_decode
    csv_path = tmp_path / "roofline.csv"
    assert roofline.main(["--dir", str(directory), "--csv", str(csv_path)]) == 0
    out = capsys.readouterr().out
    assert "| olmo_1b | decode_32k |" in out and "NVIDIA H100" in out
    lines = csv_path.read_text().splitlines()
    assert len(lines) == 2 and lines[0].startswith("arch,shape,mesh,flops_dev")


def test_hillclimb_microbatches_cut_temp_bytes_at_equal_flops(tmp_path, capsys):
    """olmo_1b train_4k at one period on 16 x 16: two microbatches hold
    half the activations at once (the reference's hill-climb lever)."""
    recs = {}
    for tag, mb in (("mb1", "1"), ("mb2", "2")):
        argv = ["--arch", "olmo_1b", "--shape", "train_4k", "--tag", tag, "--periods", "1",
                "--microbatch", mb, "--out", str(tmp_path)]
        assert hillclimb.main(argv) == 0
        recs[tag] = roofline.load(str(tmp_path))[-1]
        assert recs[tag]["tag"] == tag and recs[tag]["levers"]["microbatch"] == int(mb)
    one, two = (recs[t]["scanned"] for t in ("mb1", "mb2"))
    assert recs["mb1"]["num_layers"] == get("olmo_1b").period
    assert two["cost"]["flops"] == one["cost"]["flops"]
    assert two["memory"]["temp_bytes"] < one["memory"]["temp_bytes"]
    assert "olmo_1b train_4k [mb2]" in capsys.readouterr().out
