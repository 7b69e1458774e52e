"""Parity of the port's collectives and sharded solvers
(repro_torch.core.distributed.mix_all_gather / mix_ring,
repro_torch.core.runners.bol_sharded / bsr_sharded) with the JAX
package's shard_map versions, CPU.

The reference runs once per module in a subprocess on 8 forced host
devices, at the sizes of its own tests (tests/test_distributed_mixing.py,
tests/test_runners_extensions.py), and saves its inputs and outputs; the
port runs the same inputs over spawned gloo ranks (tests/torch_dist.py), one
task per rank, and is held to the reference's outputs and to its own
single-device bol / bsr within 1e-5. The reference's ring counts the
antipodal neighbour of an even ring twice (m = 2 and 4 below); the port's
ring equals mu^T theta there, and the test shows the reference's value
differs."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference's subprocess

from torch_threads import one_torch_thread  # noqa: E402, F401
from torch_dist import run_ranks, solvers  # noqa: E402

from repro_torch.core import SQUARED, MultiTaskProblem, band_graph, bol, bsr  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-5

REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import MultiTaskProblem, SQUARED, band_graph
from repro.core.distributed import mix_all_gather, mix_ring, mixing_spec_for_band_graph
from repro.core.runners import bol_sharded, bsr_sharded
from repro.data.synthetic import generate_clustered_tasks

out = {}
def mesh(m):
    return Mesh(np.array(jax.devices()[:m]), ("task",))

# mix_all_gather: m 8, d 64 (test_mix_all_gather_matches_dense_oracle)
g = band_graph(8, 2)
mu = jnp.asarray(g.bol_mixing(0.5, 2.0, 0.05), jnp.float32)
theta = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
fn = shard_map(lambda th, c: mix_all_gather(th, c[:, 0], "task"), mesh=mesh(8),
               in_specs=(P("task", None), P(None, "task")), out_specs=P("task", None))
out["mix_theta"], out["mix_all_gather"] = theta, np.asarray(fn(jnp.asarray(theta), mu))

# mix_ring: m 8 bandwidth 2, d 32 (test_mix_ring_matches_band_mixing); and
# the even rings whose antipodal neighbour the reference counts twice
for seed, (m, bw) in enumerate(((8, 2), (4, 2), (2, 1)), start=1):
    self_w, nbr = mixing_spec_for_band_graph(band_graph(m, bw), 0.5, 2.0, 0.04)
    theta = np.random.default_rng(seed).standard_normal((m, 32)).astype(np.float32)
    fn = shard_map(lambda th: mix_ring(th, self_w, nbr, "task", m), mesh=mesh(m),
                   in_specs=P("task", None), out_specs=P("task", None))
    out[f"ring_theta_{m}_{bw}"] = theta
    out[f"ring_{m}_{bw}"] = np.asarray(fn(jnp.asarray(theta)))

# bol_sharded / bsr_sharded: m 8, d 6, n 40; 60 / 80 iterations
# (test_bol_sharded_matches_single_device, test_bsr_sharded_matches_single_device)
for seed, name in ((0, "bol"), (1, "bsr")):
    rng = np.random.default_rng(seed)
    tasks = generate_clustered_tasks(rng, m=8, d=6, num_clusters=2, knn=2)
    x, y = tasks.sample(rng, 40)
    out[f"{name}_x"], out[f"{name}_y"] = np.asarray(x, np.float32), np.asarray(y, np.float32)
problem = MultiTaskProblem(band_graph(8, 2), SQUARED, 0.5, 1.5)
xb, yb = jnp.asarray(out["bol_x"]), jnp.asarray(out["bol_y"])
out["bol_ring"] = np.asarray(bol_sharded(problem, xb, yb, 60, mesh(8), use_ring=True))
out["bol_all_gather"] = np.asarray(bol_sharded(problem, xb, yb, 60, mesh(8), use_ring=False))
out["bsr"] = np.asarray(bsr_sharded(problem, jnp.asarray(out["bsr_x"]),
                                    jnp.asarray(out["bsr_y"]), 80, mesh(8)))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_sharded") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", f"OUT = {path!r}\n" + textwrap.dedent(REFERENCE)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


def _inputs(tmp_path_factory, ref, keys, extra=None):
    path = str(tmp_path_factory.mktemp("inputs") / "in.npz")
    np.savez(path, **{k: ref[k] for k in keys}, **(extra or {}))
    return path


@pytest.fixture(scope="module")
def port8(reference, tmp_path_factory):
    """The port over 8 gloo ranks: every rank's outputs."""
    path = _inputs(tmp_path_factory, reference,
                   ["mix_theta", "ring_theta_8_2", "bol_x", "bol_y", "bsr_x", "bsr_y"])
    return run_ranks(solvers, 8, tmp_path_factory.mktemp("ranks8"), path)


@pytest.fixture(scope="module")
def port_small(reference, tmp_path_factory):
    """The port over 4 and over 2 gloo ranks: the even rings, and 8 tasks
    over 4 ranks."""
    x = np.zeros((8, 5, 3), np.float32)
    p4 = _inputs(tmp_path_factory, reference, ["ring_theta_4_2"],
                 {"wrong_world_x": x, "wrong_world_y": x[..., 0]})
    p2 = _inputs(tmp_path_factory, reference, ["ring_theta_2_1"])
    return {4: run_ranks(solvers, 4, tmp_path_factory.mktemp("ranks4"), p4),
            2: run_ranks(solvers, 2, tmp_path_factory.mktemp("ranks2"), p2)}


def _stacked(results, key):
    """The (m, ...) stack of each rank's (1, ...) output."""
    return np.concatenate([r[key] for r in results], axis=0)


def _mu(m, bw, eta, tau, alpha):
    return band_graph(m, bw).bol_mixing(eta, tau, alpha)


@pytest.mark.parametrize("key", ["mix_all_gather", "ring_8_2"])
def test_collectives_match_jax_shard_map(reference, port8, key):
    got = _stacked(port8, key)
    np.testing.assert_allclose(got, reference[key], rtol=TOL, atol=TOL)
    # and the dense oracle mu^T theta (float64)
    theta = reference["mix_theta" if key == "mix_all_gather" else "ring_theta_8_2"]
    mu = _mu(8, 2, 0.5, 2.0, 0.05 if key == "mix_all_gather" else 0.04)
    np.testing.assert_allclose(got, mu.T @ theta.astype(np.float64), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("key", ["bol_ring", "bol_all_gather", "bsr"])
def test_sharded_solvers_match_jax(reference, port8, key):
    for r in port8:  # the full (m, d) iterate on every rank, as JAX returns it
        np.testing.assert_array_equal(r[key], port8[0][key])
    np.testing.assert_allclose(port8[0][key], reference[key], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("key", ["bol_ring", "bol_all_gather", "bsr"])
def test_sharded_solvers_match_single_device(reference, port8, key):
    name = key.split("_")[0]
    x = torch.as_tensor(reference[f"{name}_x"])
    y = torch.as_tensor(reference[f"{name}_y"])
    problem = MultiTaskProblem(band_graph(8, 2), SQUARED, 0.5, 1.5)
    if name == "bol":
        want = bol(problem, x, y, num_iters=60, accelerated=False).w
    else:
        want = bsr(problem, x, y, num_iters=80, accelerated=False).w
    np.testing.assert_allclose(port8[0][key], want.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m,bw", [(4, 2), (2, 1)])
def test_even_ring_counts_the_antipodal_neighbour_once(reference, port_small, m, bw):
    """The port's ring equals mu^T theta on an even ring whose band reaches
    the antipodal task; the reference's ring adds that neighbour twice and
    differs from mu^T theta by far more than the tolerance."""
    theta = reference[f"ring_theta_{m}_{bw}"].astype(np.float64)
    want = _mu(m, bw, 0.5, 2.0, 0.04).T @ theta
    got = _stacked(port_small[m], f"ring_{m}_{bw}")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    ref_err = np.abs(reference[f"ring_{m}_{bw}"] - want).max()
    assert ref_err > 100 * TOL, ref_err
    # the reference's value is mu^T theta plus the antipodal term once more
    # (its weight alpha * tau = 0.04 * 2.0)
    antipodal = np.roll(theta, m // 2, axis=0) * 0.04 * 2.0
    np.testing.assert_allclose(reference[f"ring_{m}_{bw}"], want + antipodal,
                               rtol=TOL, atol=TOL)


def test_tasks_must_match_the_ranks(port_small):
    for r in port_small[4]:
        assert r["wrong_world"] is not None and "8 tasks over a group of 4" in r["wrong_world"]


def test_one_rank_is_plain_bol(tmp_path):
    """World 1: the hops are the identity and the gather is the rank's own
    row, so the sharded solvers are the single-device ones on one task."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 40, 6)).astype(np.float32)
    y = rng.standard_normal((1, 40)).astype(np.float32)
    path = str(tmp_path / "in.npz")
    np.savez(path, bol_one_x=x, bol_one_y=y)
    (got,) = run_ranks(one_task, 1, tmp_path, path)
    problem = MultiTaskProblem(band_graph(1, 1), SQUARED, 0.5, 1.5)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_allclose(got["bol"], bol(problem, xt, yt, 20, accelerated=False).w.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["bsr"], bsr(problem, xt, yt, 20, accelerated=False).w.numpy(),
                               rtol=TOL, atol=TOL)


def test_runners_run_on_the_card_unless_told(tmp_path):
    """Without device="cpu" the solvers take the card, and without one they
    raise: no fall-back from CUDA to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is CUDA")
    (msg,) = run_ranks(default_device, 1, tmp_path)
    assert "pass device='cpu'" in msg


# rank programs of the two tests above (module level: spawned ranks import
# them from here, after the module's JAX-free imports)
def one_task(rank, world, path):
    from repro_torch.core.runners import bol_sharded, bsr_sharded

    ref = np.load(path)
    problem = MultiTaskProblem(band_graph(1, 1), SQUARED, 0.5, 1.5)
    x, y = ref["bol_one_x"], ref["bol_one_y"]
    return {"bol": bol_sharded(problem, x, y, 20, device="cpu").numpy(),
            "bsr": bsr_sharded(problem, x, y, 20, device="cpu").numpy()}


def default_device(rank, world):
    from repro_torch.core.runners import bol_sharded

    problem = MultiTaskProblem(band_graph(1, 1), SQUARED, 0.5, 1.5)
    x = np.zeros((1, 4, 2), np.float32)
    try:
        bol_sharded(problem, x, x[..., 0], 1)
    except RuntimeError as e:
        return str(e)
    return "no error"
