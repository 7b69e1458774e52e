"""The port's dry run (repro_torch.launch.dryrun) on the CPU: the sharded
programs at full size on ``meta`` DTensors over a fake process group of
256 or 512 ranks in this one process, against the JAX package's sharding
rules.

The reference's own dry run compiles on 512 forced host devices (its test
is the repo's known failure under the installed jax), so the oracle here is
its rules: every argument leaf's per-device shard shape from
``NamedSharding(AbstractMesh(...), spec).shard_shape`` on ``jax.eval_shape``
of the reference model and state, which needs no device and no compile.
The reference's TrainState also holds the step counter, a device scalar;
the port's is a host int, so the step is left out of both sides."""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402, F401

from repro.configs import get as jax_get  # noqa: E402
from repro.launch.mesh import mesh_axes as jax_mesh_axes  # noqa: E402
from repro.launch.specs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch.specs import input_specs as jax_input_specs  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.sharding.rules import batch_specs as jax_batch_specs  # noqa: E402
from repro.sharding.rules import cache_specs as jax_cache_specs  # noqa: E402
from repro.sharding.rules import param_specs as jax_param_specs  # noqa: E402
from repro.sharding.rules import train_state_specs as jax_train_state_specs  # noqa: E402
from repro.train.trainer import init_state as jax_init_state  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import axes_of, make_fake_mesh, mesh_axes  # noqa: E402
from repro_torch.launch.specs import INPUT_SHAPES  # noqa: E402

COMBOS = [("olmo_1b", "train_4k", False), ("olmo_1b", "decode_32k", False),
          ("mixtral_8x22b", "train_4k", False), ("olmo_1b", "train_4k", True)]
IDS = [f"{a}-{s}-{'2x16x16' if mp else '16x16'}" for a, s, mp in COMBOS]
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}

_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def fake_group_torn_down():
    """The fake process group lives for this module only."""
    yield
    import torch.distributed as dist

    _RUNS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _run(arch, shape, multi_pod):
    key = (arch, shape, multi_pod)
    if key not in _RUNS:
        _RUNS[key] = dryrun.run_one(arch, shape, multi_pod, True, None)
    return _RUNS[key]


def _reference_argument_bytes(arch, shape_name, multi_pod) -> int:
    """Per-device bytes of the reference dry run's arguments for one
    combination (its ``prepare`` and ``run_one`` config edits), without
    the TrainState's step."""
    ax = jax_mesh_axes(multi_pod=multi_pod)
    mesh = AbstractMesh((2, 16, 16) if multi_pod else (16, 16),
                        ("pod", "data", "model") if multi_pod else ("data", "model"))
    shape = JAX_SHAPES[shape_name]
    fsdp = tuple(ax.fsdp) if len(ax.fsdp) > 1 else ax.fsdp[0]
    batch_ax = fsdp if shape.global_batch % ax.fsdp_size == 0 else None
    cfg = dataclasses.replace(jax_get(arch), num_tasks=ax.fsdp_size, moe_groups=ax.fsdp_size,
                              activation_sharding=(batch_ax, None, ax.model),
                              logits_sharding=(batch_ax, None, ax.model))
    model = JaxLM(cfg, dtype=jnp.bfloat16)
    key = jax.random.PRNGKey(0)
    batch = jax_input_specs(cfg, shape)
    trees = [(batch, jax_batch_specs(cfg, batch, ax))]
    if shape.kind == "train":
        state = jax.eval_shape(lambda k: jax_init_state(model, jax_adamw(3e-4), k), key)
        specs = jax_train_state_specs(cfg, state, ax)
        trees += [(state.params, specs.params), (state.opt_state, specs.opt_state)]
    else:
        params = jax.eval_shape(model.init, key)
        caches = jax.eval_shape(lambda: model.init_cache(shape.global_batch, shape.seq_len))
        trees += [(params, jax_param_specs(cfg, params, ax)),
                  (caches, jax_cache_specs(cfg, caches, ax))]
    total = 4 if shape.kind == "decode" else 0  # decode's scalar position, replicated
    for tree, specs in trees:
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            local = NamedSharding(mesh, spec).shard_shape(leaf.shape)
            total += math.prod(local) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape,multi_pod", COMBOS, ids=IDS)
def test_argument_bytes_equal_the_reference_rules(arch, shape, multi_pod):
    """Every argument's per-device shard, summed, equals the reference
    rules' shard shapes exactly, and the keys are the reference's."""
    r = _run(arch, shape, multi_pod)
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    for part in ("scanned", "probe1", "probe2"):
        assert set(r[part]["memory"]) == MEMORY_KEYS
        assert set(r[part]["cost"]) == {"flops", "bytes_accessed"}
        assert "total_wire_bytes" in r[part]["collectives"]
    assert r["scanned"]["memory"]["argument_bytes"] == \
        _reference_argument_bytes(arch, shape, multi_pod)


@pytest.mark.parametrize("arch,shape,multi_pod", COMBOS, ids=IDS)
def test_accounting_is_positive_and_linear_in_depth(arch, shape, multi_pod):
    """temp_bytes and total_wire_bytes are positive, as the reference's
    own test asks; FLOPs and every collective count are exactly linear in
    depth: total = probe1 + (P - 1) (probe2 - probe1); a train step
    updates its whole state in place (alias == the state's bytes)."""
    r = _run(arch, shape, multi_pod)
    sc, p1, p2 = r["scanned"], r["probe1"], r["probe2"]
    assert sc["memory"]["temp_bytes"] > 0
    assert sc["collectives"]["total_wire_bytes"] > 0
    periods = r["num_periods"]
    assert r["remainder"] == 0 and periods * r["period"] == r["num_layers"]

    def linear(get):
        return get(p1) + (periods - 1) * (get(p2) - get(p1))

    assert sc["cost"]["flops"] == linear(lambda x: x["cost"]["flops"])
    kinds = {k for part in (sc, p1, p2) for k in part["collectives"] if k != "total_wire_bytes"}
    assert kinds
    for kind in kinds:
        assert sc["collectives"][kind]["count"] == linear(
            lambda x: x["collectives"].get(kind, {"count": 0})["count"]), kind
    mem = sc["memory"]
    if shape == "train_4k":
        assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]
    else:  # the caches, written in place
        assert mem["alias_bytes"] > 0


def test_remat_lowers_temp_bytes():
    """olmo_1b train_4k at two layers on 16 x 16: the step with each layer
    rematerialized holds fewer temp bytes than without."""
    mesh = make_fake_mesh(False)
    shape = INPUT_SHAPES["train_4k"]
    cfg = dryrun.probe_cfg(dryrun.combo_cfg("olmo_1b", shape, axes_of(mesh)), 2)
    temp = {remat: dryrun.account(dataclasses.replace(cfg, remat=remat), shape, mesh)
            ["memory"]["temp_bytes"] for remat in (True, False)}
    assert 0 < temp[True] < temp[False], temp


@pytest.mark.parametrize("arch,shape", [
    ("zamba2_7b", "train_4k"), ("deepseek_v2_236b", "train_4k"), ("xlstm_350m", "decode_32k"),
    ("pixtral_12b", "prefill_32k"), ("musicgen_large", "train_4k"),
    ("mixtral_8x22b", "decode_32k"), ("olmo_1b", "long_500k"),
])
def test_outside_the_tensor_parallel_scope_raises(arch, shape):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dryrun.run_one(arch, shape, False, False, None)


def test_tp_archs_and_shapes():
    assert set(dryrun.TP_ARCHS) == {"olmo_1b", "qwen2_5_14b", "qwen1_5_110b",
                                    "phi4_mini_3_8b", "multitask_lm", "mixtral_8x22b"}
    for arch in dryrun.TP_ARCHS:
        want = ["train_4k"] if arch == "mixtral_8x22b" else ["train_4k", "prefill_32k",
                                                             "decode_32k"]
        assert dryrun.applicable_shapes(arch) == want


def test_cli_writes_the_reference_keys(tmp_path, capsys):
    """``--arch olmo_1b --shape decode_32k --out DIR`` exits 0 and writes
    DIR/singlepod/olmo_1b__decode_32k.json with the reference's keys; an
    arch outside the scope makes the CLI exit 1."""
    assert dryrun.main(["--arch", "olmo_1b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    with open(tmp_path / "singlepod" / "olmo_1b__decode_32k.json") as f:
        r = json.load(f)
    assert {"arch", "shape", "mesh", "num_layers", "period", "num_periods", "remainder",
            "scanned"} <= set(r)
    assert set(r["scanned"]["memory"]) == MEMORY_KEYS
    assert r["scanned"]["cost"]["flops"] > 0
    assert "OK   olmo_1b" in capsys.readouterr().out
    assert dryrun.main(["--arch", "zamba2_7b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 1


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fake_mesh_is_the_production_mesh(multi_pod):
    mesh = make_fake_mesh(multi_pod)
    want = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert tuple(mesh.mesh_dim_names) == want
    assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
    assert axes_of(mesh) == mesh_axes(multi_pod=multi_pod)


@pytest.mark.parametrize("kind,size,g,want", [
    ("all-gather", 1600, 16, 1500), ("all-reduce", 1600, 16, 3000),
    ("reduce-scatter", 100, 16, 1500), ("all-to-all", 1600, 16, 1500),
    ("all-gather", 1600, 1, 0), ("collective-permute", 100, 2, 100),
])
def test_wire_bytes_are_the_reference_ring_formulas(kind, size, g, want):
    assert dryrun.wire_bytes(kind, size, g) == want
    stats = dryrun.summarize([{"kind": kind, "bytes": size, "group_size": g}] * 2)
    assert stats[kind] == {"count": 2, "result_bytes": 2 * size, "wire_bytes": 2 * want}
    assert stats["total_wire_bytes"] == 2 * want
