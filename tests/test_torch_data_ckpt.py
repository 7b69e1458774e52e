"""The port's token pipeline (repro_torch.data.tokens), npz checkpoints
(repro_torch.checkpoint) and training launcher (repro_torch.launch.train)
against the JAX package's, CPU: bit-identical batches from one seed; a
checkpoint written by either package loads in the other, and the two
models' logits then agree (atol 1e-4); convert.params_to_numpy inverts
params_from_numpy; the launcher runs as a subprocess with --device cpu and
refuses to run without a GPU otherwise."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.configs import get as jax_get  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxPipeline  # noqa: E402
from repro.data.tokens import synthetic_lm_batch as jax_synthetic  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params, params_to_numpy  # noqa: E402
from repro_torch.data import TokenPipeline, synthetic_lm_batch  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=16, global_batch=8, num_tasks=8),
    dict(vocab_size=500, seq_len=33, global_batch=6, num_tasks=4, seed=3, tilt=0.7),
    dict(vocab_size=64, seq_len=8, global_batch=5, num_tasks=16, seed=1, neighbor_corr=2),
])
def test_token_pipeline_is_bit_identical(kw):
    ours, ref = iter(TokenPipeline(**kw)), iter(JaxPipeline(**kw))
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_lm_batch_is_bit_identical():
    a = synthetic_lm_batch(np.random.default_rng(5), 6, 12, 97, num_tasks=3)
    b = jax_synthetic(np.random.default_rng(5), 6, 12, 97, num_tasks=3)
    for k in b:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def _batch(cfg):
    rng = np.random.default_rng(6)
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32),
            "task_ids": np.array([0, cfg.num_tasks - 1], np.int32)}


def _logits_close(jm, jparams, tm, atol=1e-4):
    batch = _batch(tm.cfg)
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(jm.forward)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = tm.forward({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ["olmo_1b", "multitask_lm"])
def test_jax_checkpoint_loads_in_the_port(arch, tmp_path):
    jm = JaxLM(jax_get(arch, smoke=True))
    params = jm.init(jax.random.PRNGKey(1))
    params["task"] = jax.tree.map(lambda t: t + 0.1, params["task"])
    path = str(tmp_path / "jax.npz")
    jax_save(path, params, step=7)
    tm = TransformerLM(get(arch, smoke=True), device="cpu", seed=5)
    tree, step = load_pytree(path, params_to_numpy(tm))
    assert step == 7 and not os.path.exists(path + ".tmp")
    _logits_close(jm, params, load_numpy_params(tm, tree))


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_5_14b"])
def test_port_checkpoint_loads_in_jax(arch, tmp_path):
    tm = TransformerLM(get(arch, smoke=True), device="cpu", seed=3)
    path = str(tmp_path / "ckpt" / "port.npz")
    save_pytree(path, params_to_numpy(tm), step=5)
    jm = JaxLM(jax_get(arch, smoke=True))
    template = jax.tree.map(lambda t: np.zeros(t.shape, t.dtype), jm.init(jax.random.PRNGKey(0)))
    tree, step = jax_load(path, template)
    assert step == 5
    _logits_close(jm, jax.tree.map(jnp.asarray, tree), tm)


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_5_14b", "multitask_lm"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """The tree has the JAX init's structure (empty dicts of parameter-free
    norms included) and its exact values."""
    jparams = jax.tree.map(np.asarray, JaxLM(jax_get(arch, smoke=True)).init(jax.random.PRNGKey(2)))
    tm = load_numpy_params(TransformerLM(get(arch, smoke=True), device="cpu"), jparams)
    back = params_to_numpy(tm)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_pytree_checks_keys_and_shapes(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"a": torch.zeros(2, 3), "b": [np.ones(4)]})
    tree, step = load_pytree(path, {"a": np.zeros((2, 3)), "b": [np.zeros(4)]})
    assert step is None and tree["b"][0].tolist() == [1.0] * 4
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(path, {"a": np.zeros((3, 2)), "b": [np.zeros(4)]})
    with pytest.raises(KeyError, match="missing leaf 'c'"):
        load_pytree(path, {"a": np.zeros((2, 3)), "c": np.zeros(1)})


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)


def test_launcher_trains_on_the_cpu_and_checkpoints(tmp_path):
    from repro_torch.launch.train import main

    ckpt = str(tmp_path / "run.npz")
    args = ["--arch", "multitask_lm", "--steps", "3", "--batch", "4", "--seq", "16",
            "--log-every", "1", "--device", "cpu"]
    proc = _launch(*args, "--ckpt", ckpt)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("multitask-lm:") and "2 tasks" in lines[0]  # 4 % 8: rewritten
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 3 and all(ln.endswith("ms/step)") for ln in steps)
    trained = main(args)  # the same run in this process
    cfg = trained.cfg
    fresh = TransformerLM(cfg, device="cpu", seed=11)
    tree, step = load_pytree(ckpt, params_to_numpy(fresh))
    load_numpy_params(fresh, tree)
    assert step == 3
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        torch.testing.assert_close(fresh.forward(batch)[0], trained.forward(batch)[0],
                                   rtol=0, atol=0)


def test_launcher_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _launch("--arch", "multitask_lm", "--steps", "1")
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    proc = _launch("--arch", "multitask_linreg", "--device", "cpu")
    assert proc.returncode != 0 and "not a language model" in proc.stderr
