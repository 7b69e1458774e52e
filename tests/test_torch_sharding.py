"""Parity of the port's sharding rules (repro_torch.sharding.rules), input
specs and meshes (repro_torch.launch.specs / mesh) with the JAX package's,
and of the sharded DTensor train step (repro_torch.sharding.dtensor) with
the unsharded step and with the JAX package's 2 x 2 sharded step, CPU.

The reference runs once per module in a subprocess on 4 forced host
devices: the PartitionSpec of every param, AdamW-moment, decode_32k cache
and input leaf of every architecture at full size, from
``jax.eval_shape`` (nothing allocated), on the 16 x 16, 2 x 16 x 16 and
2 x 2 ``MeshAxes``; and the loss of its sharded-train-step test
(tests/test_distributed_mixing.py), unsharded and on a 2 x 2 mesh, with
the weights it started from. The port reads its full-size models on the
``meta`` device (nothing allocated, nothing drawn) and runs its step over
four spawned gloo ranks (tests/torch_dist.py)."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference's subprocess

from torch_threads import one_torch_thread  # noqa: E402, F401
from torch_dist import run_ranks, train_step  # noqa: E402

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get, list_archs  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.launch.mesh import mesh_axes  # noqa: E402
from repro_torch.launch.specs import INPUT_SHAPES, input_specs  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    MeshAxes,
    Spec,
    batch_specs,
    cache_specs,
    param_specs,
    placements,
    train_state_specs,
)
from repro_torch.train import init_state, make_train_step  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-5
ARCHS = [a for a in list_archs() if a != "multitask_linreg"]
MESHES = {"16x16": mesh_axes(), "2x16x16": mesh_axes(multi_pod=True),
          "2x2": MeshAxes(("data",), "model", 2, 2)}

REFERENCE = """
import dataclasses, json, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get, list_archs
from repro.core import GraphMultiTask, band_graph
from repro.launch.mesh import mesh_axes
from repro.launch.specs import INPUT_SHAPES, input_specs
from repro.models import TransformerLM
from repro.optim import adamw, sgd
from repro.sharding.rules import (MeshAxes, batch_specs, cache_specs, param_specs,
                                  train_state_specs)
from repro.train.trainer import init_state, make_train_step

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def leaves(tree, specs):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            [list(leaf.shape), str(leaf.dtype), enc(s)] for (p, leaf), s in zip(paths, flat)}

meshes = {"16x16": mesh_axes(), "2x16x16": mesh_axes(multi_pod=True),
          "2x2": MeshAxes(("data",), "model", 2, 2)}
out = {"archs": list_archs(), "mesh_axes": {k: dataclasses.asdict(v) for k, v in meshes.items()},
       "input_shapes": {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()}, "specs": {}}
key = jax.random.PRNGKey(0)
for arch in [a for a in list_archs() if a != "multitask_linreg"]:
    cfg = get(arch)
    model = TransformerLM(cfg)
    state = jax.eval_shape(lambda k: init_state(model, adamw(3e-4), k), key)
    caches = jax.eval_shape(lambda: model.init_cache(128, 32768))
    rec = {}
    for name, ax in meshes.items():
        ss = train_state_specs(cfg, state, ax)
        rec[name] = {"params": leaves(state.params, ss.params),
                     "mu": leaves(state.opt_state.mu, ss.opt_state.mu),
                     "nu": leaves(state.opt_state.nu, ss.opt_state.nu),
                     "cache": leaves(caches, cache_specs(cfg, caches, ax)),
                     "batch": {s: leaves(b, batch_specs(cfg, b, ax)) for s, b in
                               ((s, input_specs(cfg, sh)) for s, sh in INPUT_SHAPES.items())}}
    out["specs"][arch] = rec

# the sharded train step (test_sharded_train_step_matches_single_device)
cfg = dataclasses.replace(get("olmo_1b", smoke=True), num_tasks=2)
model = TransformerLM(cfg)
opt = sgd(1e-2)
step = make_train_step(model, opt, multitask=GraphMultiTask(band_graph(2, 1), eta=0.1, tau=1.0))
state = init_state(model, opt, jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
batch = {
    "tokens": rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int64).astype(np.int32),
    "labels": rng.integers(0, cfg.vocab_size, (4, 32), dtype=np.int64).astype(np.int32),
    "task_ids": np.asarray([0, 0, 1, 1], np.int32),
}
jb = jax.tree.map(jnp.asarray, batch)
_, m_single = jax.jit(step)(state, jb)
mesh = jax.make_mesh((2, 2), ("data", "model"))
ax = MeshAxes(("data",), "model", 2, 2)
sh = lambda specs: jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s), specs)
with mesh:
    _, m_shard = jax.jit(step, in_shardings=(sh(train_state_specs(cfg, state, ax)),
                                             sh(batch_specs(cfg, jb, ax))))(state, jb)
out["train"] = {"loss_single": float(m_single["loss"]), "loss_sharded": float(m_shard["loss"])}
with open(OUT + ".pkl", "wb") as f:
    pickle.dump(dict(batch, params=jax.tree.map(np.asarray, state.params)), f)
with open(OUT + ".json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_rules") / "ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", f"OUT = {path!r}\n" + textwrap.dedent(REFERENCE)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(path + ".json") as f:
        ref = json.load(f)
    ref["train_inputs"] = path + ".pkl"
    return ref


_MODELS: dict = {}


def _meta_model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = TransformerLM(get(arch), device="meta")
    return _MODELS[arch]


def _enc(spec):
    """A spec as the reference's JSON has it: JAX's PartitionSpec holds a
    one-axis tuple as the bare axis name."""
    assert isinstance(spec, Spec), spec
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e for e in spec]


def _ref_layers(cfg, ref_path):
    """The port's layer indices of a reference stage leaf path
    ("<stage>/slot<j>/..."), in repetition order, and the rest of the path."""
    parts = ref_path.split("/")
    kinds, reps, first = cfg.stages()[int(parts[0])]
    j = int(parts[1][len("slot"):])
    return [first + len(kinds) * i + j for i in range(reps)], parts[2:]


def _port_params_as_reference(cfg, tree_specs, shapes):
    """The port's param specs and shapes keyed by the reference's paths:
    each stage leaf's port layers must agree with one another, and the
    reference's leading period axis is dropped from its spec."""
    out = {}
    for name, spec in tree_specs.items():
        parts = name.split(".")
        if parts[0] == "layers":
            layer = int(parts[1])
            for si, (kinds, reps, first) in enumerate(cfg.stages()):
                if first <= layer < first + len(kinds) * reps:
                    j = (layer - first) % len(kinds)
                    key = "/".join(["stages", str(si), f"slot{j}"] + parts[2:])
            entry = [list(shapes[name]), _enc(spec)]
            if key in out:
                assert out[key] == entry, (name, out[key], entry)
            out[key] = entry
        else:
            out["/".join(parts)] = [list(shapes[name]), _enc(spec)]
    return out


def _check_params(cfg, ref_leaves, port_specs, port_shapes, what):
    port = _port_params_as_reference(cfg, port_specs, port_shapes)
    assert set(port) == set(ref_leaves), (what, set(port) ^ set(ref_leaves))
    for key, (shape, _, spec) in ref_leaves.items():
        if key.startswith("stages/"):
            shape, spec = shape[1:], spec[1:]
            assert ref_leaves[key][2][0] is None
        assert port[key] == [shape, spec], (what, key, port[key], [shape, spec])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_the_reference_at_full_size(reference, arch, mesh):
    """Every param, AdamW-moment, decode_32k cache and input leaf of the
    full-size model takes the reference's PartitionSpec (the stage leaves'
    without their period axis), and has the reference's shape."""
    ref = reference["specs"][arch][mesh]
    ax = MESHES[mesh]
    model = _meta_model(arch)
    cfg = model.cfg
    state = init_state(model, adamw(3e-4))
    specs = train_state_specs(cfg, state, ax)
    assert specs.step == Spec()
    shapes = {k: tuple(v.shape) for k, v in state.params.items()}
    assert all(v.device.type == "meta" for v in tree_lib.leaves(state[:2]))
    _check_params(cfg, ref["params"], specs.params, shapes, "params")
    assert specs.params == param_specs(cfg, state.params, ax)
    _check_params(cfg, ref["mu"], specs.opt_state.mu, shapes, "mu")
    _check_params(cfg, ref["nu"], specs.opt_state.nu, shapes, "nu")
    # decode_32k caches: the port's one tuple per layer against the
    # reference's (stage, slot) leaves
    caches = model.init_cache(128, 32768)
    cspecs = cache_specs(cfg, caches, ax)
    seen = set()
    for key, (shape, _, spec) in ref["cache"].items():
        stage, slot, idx = key.split("/")
        layers, _ = _ref_layers(cfg, f"{stage}/{slot}")
        for layer in layers:
            t = caches[layer][int(idx)]
            assert t.device.type == "meta"
            assert [list(t.shape), _enc(cspecs[layer][int(idx)])] == [shape[1:], spec[1:]], \
                (key, layer)
            seen.add((layer, int(idx)))
    assert seen == {(i, k) for i, entry in enumerate(caches) for k in range(len(entry))}
    for name, shape in INPUT_SHAPES.items():
        batch = input_specs(cfg, shape)
        bspecs = batch_specs(cfg, batch, ax)
        want = ref["batch"][name]
        assert set(batch) == set(want)
        for k, t in batch.items():
            dtype = str(t.dtype).replace("torch.", "")
            assert [list(t.shape), _enc(bspecs[k])] == [want[k][0], want[k][2]], (name, k)
            assert dtype == want[k][1], (name, k, dtype, want[k][1])


def test_archs_meshes_and_shapes_match_the_reference(reference):
    assert sorted(list_archs()) == sorted(reference["archs"])
    for name, ax in MESHES.items():
        assert dataclasses.asdict(ax) == {k: tuple(v) if isinstance(v, list) else v
                                          for k, v in reference["mesh_axes"][name].items()}
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        reference["input_shapes"]


class _Mesh:
    """The one attribute of a DeviceMesh that ``placements`` reads."""

    def __init__(self, *names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec,names,want", [
    (Spec(("data",), "model"), ("data", "model"), "(Shard(dim=0), Shard(dim=1))"),
    (Spec("model", ("data",)), ("data", "model"), "(Shard(dim=1), Shard(dim=0))"),
    (Spec(None, ("pod", "data"), "model"), ("pod", "data", "model"),
     "(Shard(dim=1), Shard(dim=1), Shard(dim=2))"),
    (Spec(None, None), ("data", "model"), "(Replicate(), Replicate())"),
    (Spec(("data",), None, None), ("data", "model"), "(Shard(dim=0), Replicate())"),
    (Spec(None, ("data", "model"), None), ("data", "model"),
     "(Shard(dim=1), Shard(dim=1))"),
])
def test_placements_of_a_spec(spec, names, want):
    assert repr(placements(spec, _Mesh(*names))) == want


@pytest.mark.parametrize("spec,names,match", [
    (Spec(("data", "pod")), ("pod", "data", "model"), "against the mesh's order"),
    (Spec("expert"), ("data", "model"), "not in the mesh"),
    (Spec("model", "model"), ("data", "model"), "shards two dims"),
])
def test_placements_refuse_what_dtensor_cannot_hold(spec, names, match):
    with pytest.raises(ValueError, match=match):
        placements(spec, _Mesh(*names))


def test_sharded_train_step_matches_unsharded_and_jax(reference, tmp_path):
    """One SGD step of the olmo_1b smoke model (2 tasks) from the JAX
    package's PRNGKey(0) weights: the port over a 2 x 2 gloo mesh on
    DTensors against the port's unsharded step (loss and every updated
    parameter) and against the JAX package's 2 x 2 sharded loss."""
    with open(reference["train_inputs"], "rb") as f:
        inputs = pickle.load(f)
    cfg = dataclasses.replace(get("olmo_1b", smoke=True), num_tasks=2)
    model = load_numpy_params(TransformerLM(cfg, device="cpu"), inputs["params"])
    opt = sgd(1e-2)
    step = make_train_step(model, opt, GraphMultiTask(band_graph(2, 1), eta=0.1, tau=1.0))
    _, metrics = step(init_state(model, opt),
                      {k: torch.as_tensor(inputs[k]) for k in ("tokens", "labels", "task_ids")})
    want = {k: v.detach().numpy() for k, v in model.named_parameters()}
    ranks = run_ranks(train_step, 4, tmp_path, reference["train_inputs"], 2)
    loss = float(metrics["loss"])
    ref = reference["train"]
    for r in ranks:
        assert r["loss"] == pytest.approx(loss, rel=TOL)
        assert r["loss"] == pytest.approx(ref["loss_sharded"], rel=TOL)
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k], v, rtol=TOL, atol=TOL, err_msg=k)
        assert r["placements"]["task.head_bias"] == "(Shard(dim=0), Shard(dim=1))"
        assert r["placements"]["embed"] == "(Shard(dim=1), Shard(dim=0))"
    assert loss == pytest.approx(ref["loss_single"], rel=TOL)
