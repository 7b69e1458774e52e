"""The port's paper experiments (repro_torch.experiments) against the
reference's benchmarks/ scripts on the CPU: each reference ``main`` and the
port's on the same small sizes (m 12, d 10, n 40), JAX at matmul precision
"highest", float32.

* Figure 2 (C in {1, 5}, 50 iterations): the rows whose arithmetic the port
  repeats (local, centralized, bsr, bol, admm) give the reference's
  population risk and final objective within 1e-4 relative and its
  iterations to 1e-3; sdca, whose permutations JAX draws, reaches at most
  1.5 times the reference's gap to f* plus 3e-4.
* Figure 3 in lockstep: the port's run is fed the reference's own fresh
  samples (its key chain, replayed through the reference's sampler), so
  both pick the same sigma scale and give the same risks within 1e-4.
* Table 1: the theory rows and the measured rounds equal the reference's.
* Theorem 7: the fixed-delay rows match (|W - W*| within 1e-6, rates within
  1e-3); the Gamma = 0 row draws random delays in {0, 1} on both sides (the
  reference's quirk, kept and pinned here) and meets the slack rule.
* The LM ablation in lockstep over 5 steps from the JAX init's weights:
  final losses within 1e-4 relative, adapter spreads within 1e-4.
* The runner: ``--only kernels`` on the CPU says it ran the plain version;
  ``python -m repro_torch.experiments`` runs; entry points raise without a
  GPU unless given ``--device cpu``.

The reference writes its CSVs into a temporary directory (its
``benchmarks.common.REPORTS`` patched), the port into another."""
import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common as jcommon  # noqa: E402
from benchmarks import ablation_mtl_lm as jablation  # noqa: E402
from benchmarks import delay_bench as jdelay  # noqa: E402
from benchmarks import fig2_erm as jfig2  # noqa: E402
from benchmarks import fig3_stochastic as jfig3  # noqa: E402
from benchmarks import table1_complexity as jtable1  # noqa: E402
from repro.configs.base import ArchConfig as JaxConfig  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch.experiments import (  # noqa: E402
    ablation_mtl_lm,
    common,
    delay_bench,
    fig2_erm,
    fig3_stochastic,
    run,
    table1_complexity,
)

SIZE = ["--m", "12", "--d", "10", "--n", "40"]
CPU = ["--device", "cpu"]
RTOL = 1e-4
SLACK, GAP_TOL = 1.5, 3e-4  # runs whose draws differ: gap <= SLACK * reference's + GAP_TOL
CLUSTERS = [1, 5]
FIG3 = SIZE + ["--budget", "400", "--batches", "40"]
DELAY = ["--m", "12", "--d", "12", "--n", "60", "--iters", "200"]
ABLATION_STEPS = 5


def quiet(fn, *a, **kw):
    """fn's result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def reference(fn, *a):
    with jax.default_matmul_precision("highest"):
        return quiet(fn, *a)


@pytest.fixture(scope="module", autouse=True)
def reports(tmp_path_factory):
    """Both packages' CSVs go to temporary directories."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcommon, "REPORTS", str(tmp_path_factory.mktemp("jax_reports")))
    mp.setattr(common, "REPORTS", tmp_path_factory.mktemp("port_reports"))
    yield
    mp.undo()


def _by_key(rows):
    return {(r[0], r[1]): r for r in rows}


# ---------------------------------------------------------------- Figure 2
@pytest.fixture(scope="module")
def fig2():
    argv = SIZE + ["--iters", "50", "--clusters", *map(str, CLUSTERS)]
    ref, _ = reference(jfig2.main, argv)
    port, _ = quiet(fig2_erm.main, argv + CPU)
    return _by_key(ref), _by_key(port)


@pytest.mark.parametrize("c", CLUSTERS)
@pytest.mark.parametrize("method", ["local", "centralized", "bsr", "bol", "admm"])
def test_fig2_replayable_rows_match_the_reference(fig2, method, c):
    ref, port = fig2
    r, p = ref[(method, c)], port[(method, c)]
    assert p[:3] == r[:3]
    np.testing.assert_allclose(p[3], r[3], rtol=RTOL)
    if method == "local":
        assert np.isnan(p[4]) and np.isnan(r[4])
    else:
        np.testing.assert_allclose(p[4], r[4], rtol=RTOL)
    assert p[5] == r[5]


@pytest.mark.parametrize("c", CLUSTERS)
def test_fig2_sdca_meets_the_slack_rule(fig2, c):
    """sdca's permutations are JAX's on one side, the port's generator's on
    the other: its gap to f* may be up to 1.5 times the reference's + 3e-4."""
    ref, port = fig2
    gap_ref = ref[("sdca", c)][4] - ref[("centralized", c)][4]
    gap = port[("sdca", c)][4] - port[("centralized", c)][4]
    assert -GAP_TOL <= gap <= SLACK * max(gap_ref, 0.0) + GAP_TOL, (gap, gap_ref)


def test_setup_problem_draws_the_reference_data():
    tasks_j, xj, yj, pj = jcommon.setup_problem(5, m=12, d=10, n=40)
    tasks, x, y, p = common.setup_problem(5, m=12, d=10, n=40, device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(tasks.graph.adjacency, tasks_j.graph.adjacency)
    assert (p.eta, p.tau) == (pj.eta, pj.tau)
    assert common.tune_local_reg(tasks, x, y)[0] == jcommon.tune_local_reg(tasks_j, xj, yj)[0]


def test_iters_to_tol_counts_as_the_reference():
    trace = np.asarray([5.0, 3.5, 3.0011, 3.0009, 3.0], np.float32)
    for tol in (1e-3, 0.6, 1e-6, 10.0):
        assert fig2_erm.iters_to_tol(torch.as_tensor(trace), 3.0, tol) == jfig2.iters_to_tol(
            trace, 3.0, tol)


# ---------------------------------------------------------------- Figure 3
def replay_fresh_sampler():
    """``make_sampler`` for the port's main that hands out the reference's
    own fresh samples: every new generator the port's run passes starts the
    key chain of ``PRNGKey(seed)`` (seeds 7, 1, 2 for keys 7, 1, 2), and each
    draw takes the chain's next subkey (``k, sub = split(k)``, as the
    reference's scan does) through the reference's sampler."""
    tasks_j = jcommon.setup_problem(10, *map(int, SIZE[1::2]))[0]
    ref_sample = jfig3.make_fresh_sampler(tasks_j)
    chains, alive = {}, []

    def make(tasks, device):
        def sample(generator, b):
            if id(generator) not in chains:
                alive.append(generator)
                chains[id(generator)] = jax.random.PRNGKey(generator.initial_seed())
            chains[id(generator)], sub = jax.random.split(chains[id(generator)])
            x, y = ref_sample(sub, b)
            return torch.as_tensor(np.array(x)), torch.as_tensor(np.array(y))

        return sample

    return make


def _sigma_scales(text):
    return dict(re.findall(r"ssr b=\s*(\d+) .*\(sigma_scale=(\S+)\)", text))


@pytest.fixture(scope="module")
def fig3():
    ref, ref_text = reference(jfig3.main, FIG3)
    port, port_text = quiet(fig3_stochastic.main, FIG3 + CPU,
                            make_sampler=replay_fresh_sampler())
    return ref, ref_text, port, port_text


def test_fig3_lockstep_rows_match_the_reference(fig3):
    ref, _, port, _ = fig3
    assert [r[:3] for r in port] == [r[:3] for r in ref]
    np.testing.assert_allclose([r[3] for r in port], [r[3] for r in ref], rtol=RTOL)


def test_fig3_lockstep_picks_the_reference_sigma_scale(fig3):
    _, ref_text, _, port_text = fig3
    want = _sigma_scales(ref_text)
    assert len(want) == 1 and _sigma_scales(port_text) == want


def test_fig3_fresh_sampler_draws_the_true_distribution():
    """The port's own sampler: shapes, the generator's stream, and the
    population moments (x ~ N(0, Sigma), y = <w*, x> + N(0, 3))."""
    tasks = common.setup_problem(10, m=12, d=10, n=40, device="cpu")[0]
    sample = fig3_stochastic.make_fresh_sampler(tasks, "cpu")
    x, y = sample(torch.Generator().manual_seed(0), 4000)
    assert x.shape == (12, 4000, 10) and y.shape == (12, 4000) and x.dtype == torch.float32
    x2, _ = sample(torch.Generator().manual_seed(0), 4000)
    assert torch.equal(x, x2)
    sigma = tasks.sigma_chol @ tasks.sigma_chol.T
    cov = np.einsum("mbd,mbe->de", x.double().numpy(), x.double().numpy()) / (12 * 4000)
    np.testing.assert_allclose(cov, sigma, atol=0.05)
    resid = y.double().numpy() - np.einsum("mbd,md->mb", x.double().numpy(), tasks.true_w)
    assert abs(resid.var() - tasks.noise_std**2) < 0.1


# ------------------------------------------------------------------ Table 1
def test_table1_rows_and_measured_rounds_match_the_reference():
    argv = SIZE + ["--iters", "100"]
    ref, _ = reference(jtable1.main, argv)
    port, _ = quiet(table1_complexity.main, argv + CPU)
    assert [r[0] for r in port] == [r[0] for r in ref]
    assert [r[2] for r in port] == [r[2] for r in ref]  # measured rounds ("" where none)
    assert any(isinstance(r[2], int) and r[2] > 0 for r in port)
    for p, r in zip(port, ref):
        np.testing.assert_allclose([p[1], *p[3:]], [r[1], *r[3:]], rtol=1e-12)


# ---------------------------------------------------------------- Theorem 7
@pytest.fixture(scope="module")
def delay():
    ref, _ = reference(jdelay.main, DELAY)
    port, _ = quiet(delay_bench.main, DELAY + CPU)
    return {r[0]: r for r in ref}, {r[0]: r for r in port}


@pytest.mark.parametrize("gamma", [2, 5, 10])
def test_delay_fixed_rows_match_the_reference(delay, gamma):
    ref, port = delay
    r, p = ref[gamma], port[gamma]
    assert abs(p[1] - r[1]) <= 1e-6, (p[1], r[1])
    assert (np.isnan(p[2]) and np.isnan(r[2])) or abs(p[2] - r[2]) <= 1e-3, (p[2], r[2])
    assert p[3] == r[3]


def test_delay_gamma0_row_meets_the_slack_rule(delay):
    ref, port = delay
    assert port[0][1] <= SLACK * ref[0][1] + GAP_TOL, (port[0][1], ref[0][1])
    assert port[0][3] == ref[0][3] == pytest.approx(2.0 / 3.0)


def test_delay_gamma0_draws_random_delays_on_both_sides(monkeypatch):
    """The reference's quirk, kept by the port: a Gamma = 0 row runs
    ``max_delay=1, fixed_delay=False`` (delays drawn from {0, 1}), a Gamma > 0
    row fixed delays of Gamma; both compare with theorem7_rate(eta, tau, Gamma)."""
    calls = {"jax": [], "port": []}
    for side, mod in (("jax", jdelay), ("port", delay_bench)):
        inner = mod.bol_delayed

        def spy(*a, _inner=inner, _calls=calls[side], **kw):
            _calls.append((kw["max_delay"], kw["fixed_delay"]))
            return _inner(*a, **kw)

        monkeypatch.setattr(mod, "bol_delayed", spy)
    argv = ["--m", "6", "--d", "4", "--n", "20", "--iters", "20", "--gammas", "0", "3"]
    ref, _ = reference(jdelay.main, argv)
    port, _ = quiet(delay_bench.main, argv + CPU)
    assert calls["jax"] == calls["port"] == [(1, False), (3, True)]
    assert [r[3] for r in port] == [r[3] for r in ref]


# --------------------------------------------------------------- ablation
@pytest.fixture(scope="module")
def ablation():
    port_cfg = ablation_mtl_lm.ablation_config(8)
    fields = {f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(port_cfg)
              if f.name != "attn_backend"}
    init = JaxLM(JaxConfig(**fields)).init(jax.random.PRNGKey(0))
    argv = ["--steps", str(ABLATION_STEPS)]
    ref, _ = reference(jablation.main, argv)
    port, _ = quiet(ablation_mtl_lm.main, argv + CPU, params=jax.tree.map(np.asarray, init))
    return {r[0]: r for r in ref}, {r[0]: r for r in port}


@pytest.mark.parametrize("variant", ["local", "graph", "consensus"])
def test_ablation_lockstep_with_the_reference(ablation, variant):
    ref, port = ablation
    np.testing.assert_allclose(port[variant][1], ref[variant][1], rtol=RTOL)
    assert abs(port[variant][2] - ref[variant][2]) <= 1e-4


# ------------------------------------------------------------------ runner
def test_run_kernels_says_it_ran_the_plain_version_on_the_cpu(capsys):
    out = run.main(["--only", "kernels", "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("SUMMARY")]
    assert len(line) == 1 and "route=plain version on cpu tensors" in line[0]
    assert "graph_mix_max_err=0.00e+00" in out["kernels"][1]


def test_run_rejects_an_unknown_experiment():
    with pytest.raises(SystemExit):
        run.main(["--only", "fig4", "--device", "cpu"])


def test_module_entry_point_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", "--only", "kernels", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0] == "name,seconds,derived"
    assert re.search(r"^SUMMARY,kernels,[0-9.]+s,graph_mix_max_err=0.00e\+00,route=plain",
                     proc.stdout, re.M)


@pytest.mark.parametrize("entry", [fig2_erm.main, fig3_stochastic.main, table1_complexity.main,
                                   delay_bench.main, ablation_mtl_lm.main, run.main])
def test_entry_points_raise_without_a_gpu_unless_told(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry([])
