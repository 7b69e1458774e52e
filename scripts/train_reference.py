"""The JAX reference's training trace for ``chip_smoke.py`` phase 10(a):
multitask-LM at full width (12 layers, d_model 1024, 16 heads over 4 KV
heads, vocab 32000, 256 tasks; 256.47 M parameters) trained through
``repro.train.trainer.make_train_step`` on the CPU (float32, matmul
precision "highest"), with the smoke's settings: the weights of
``chip_smoke.train_weights`` (numpy, seed ``TRAIN_SEED``),
``TokenPipeline(32000, seq 128, batch 8, 256 tasks, seed 0)``,
``adamw(TRAIN_LR)`` at a constant rate, ``GraphMultiTask(band_graph(256,
1), TRAIN_ETA, TRAIN_TAU)``, 2 microbatches, ``TRAIN_LOCKSTEP["steps"]``
jitted steps.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_reference.py

Prints ``TRAIN_REF``, as ``chip_smoke.py`` holds it: per step the loss and
nll (taken at the step's parameters) and the Frobenius norm of each task
leaf after the step. Takes about a minute on an 8-core CPU (a first step of
compilation, then a few seconds a step) and about 8 GB of host memory.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (its top level imports the standard library only)

from repro.configs import get  # noqa: E402
from repro.core import GraphMultiTask, band_graph  # noqa: E402
from repro.data.tokens import TokenPipeline  # noqa: E402
from repro.models import TransformerLM  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.train.trainer import TrainState, make_train_step  # noqa: E402


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def reference_trace(cfg, lock):
    """Train ``cfg`` from the smoke's weights for ``lock["steps"]`` steps;
    returns (trace, parameter count, seconds per step)."""
    model = TransformerLM(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    drawn = smoke.train_weights(np, [(_path(p), tuple(s.shape)) for p, s in flat])
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(drawn[_path(p)]) for p, _ in flat])
    del drawn
    opt = adamw(smoke.TRAIN_LR)
    gmt = GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=smoke.TRAIN_ETA,
                         tau=smoke.TRAIN_TAU)
    step = jax.jit(make_train_step(model, opt, gmt, microbatches=lock["microbatches"]))
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    pipe = TokenPipeline(cfg.vocab_size, seq_len=lock["seq"], global_batch=lock["batch"],
                         num_tasks=cfg.num_tasks, seed=smoke.TRAIN_SEED)
    ref = {"loss": [], "nll": [], "task_norms": {name: [] for name in state.params["task"]}}
    secs = []
    for _, batch in zip(range(lock["steps"]), pipe):
        t1 = time.perf_counter()
        with jax.default_matmul_precision("highest"):
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        ref["loss"].append(float(metrics["loss"]))
        ref["nll"].append(float(metrics["nll"]))
        for name, leaf in state.params["task"].items():
            ref["task_norms"][name].append(float(jnp.linalg.norm(leaf.astype(jnp.float32))))
        secs.append(time.perf_counter() - t1)
    return ref, sum(int(np.prod(s.shape)) for _, s in flat), secs


def main():
    t0 = time.perf_counter()
    ref, n, secs = reference_trace(get("multitask_lm"), smoke.TRAIN_LOCKSTEP)
    print(f"# multitask-LM full width, {n} parameters; steps {['%.2f' % s for s in secs]} s, "
          f"{time.perf_counter() - t0:.1f} s in all (CPU, {jax.devices()[0].platform})")
    print(f"TRAIN_REF = {json.dumps(ref)}")


if __name__ == "__main__":
    main()
