"""Weights between the JAX package and the port.

``params_from_numpy(tree, cfg)`` takes the JAX model's params pytree with
numpy leaves (``jax.tree.map(np.asarray, params)``) and the model's
``ArchConfig``, and returns the state dict of
``repro_torch.models.TransformerLM``. Leaves are found by the same flat
paths as ``repro/checkpoint/npz.py::_paths`` ("stages/0/slot0/attn/wq"); the
(P, ...) period axis of each stage slot is unstacked into per-layer weights
in layer order ("layers.3.attn.wq", "layers.3.moe.shared.wg",
"layers.7.slstm.r"): the period stage's ``slot{j}`` of period ``i`` is
layer ``period * i + j`` (an ("attn",) or ("attn_moe",) model, GQA or MLA,
has one slot and one layer a period; xLSTM-350M has 8: seven mLSTM slots
and one sLSTM) and the remainder stage's ``slot{j}`` (a Mamba2 hybrid's,
Zamba2) is layer ``num_periods * period + j``; the top-level
``shared_attn`` tree is the one shared block's ("shared_attn.attn.wq"). ``params_to_numpy(model)`` is its
inverse: the port's weights as the JAX params tree with numpy leaves, so
trained weights or a checkpoint cross back to JAX.

``adapters_from_numpy(store, tree)`` carries a JAX ``TaskAdapterStore``'s
raw tree (numpy leaves, ``jax.tree.map(np.asarray, store.raw)``) into the
port's store of the same layout: one dict per stage, an {"attn", "mlp"}
pair per attention slot and an "out" pair per recurrent slot; the model's per-task ``task.*`` params
come across with the other weights through ``params_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: go through f32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(tree, cfg) -> dict[str, torch.Tensor]:
    """The port's state dict of a JAX params tree (numpy leaves) of the
    model ``cfg`` (its ``ArchConfig``)."""
    stages = cfg.stages()
    state = {}
    for path, leaf in tree_lib.paths(tree):
        parts = path.split("/")
        if parts[0] != "stages":
            state[".".join(parts)] = _tensor(leaf)
            continue
        if len(parts) < 5 or int(parts[1]) >= len(stages):
            raise ValueError(
                f"{path}: not a stage leaf of {cfg.name}'s layout "
                f"({len(stages)} stages of 'stages/<stage>/slot<j>/<group>/...' leaves)"
            )
        name = ".".join(parts[3:])
        stacked = np.asarray(leaf)
        kinds, _, first = stages[int(parts[1])]
        j = int(parts[2][len("slot"):])
        for i in range(stacked.shape[0]):
            state[f"layers.{first + len(kinds) * i + j}.{name}"] = _tensor(stacked[i])
    return state


def to_numpy(leaf) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array; bfloat16 as
    float32, which holds it exactly (numpy has no bfloat16)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.float()
    return leaf.cpu().numpy()


def params_to_numpy(model) -> dict:
    """The model's weights as the JAX model's params tree with numpy leaves:
    the per-layer weights restacked into the stages' (P, ...) slot leaves
    ("stages/0/slot0/attn/wq", "stages/0/slot0/moe/shared/wg"; a hybrid's
    period stage and remainder stage), the shared block as the top-level
    ``shared_attn`` tree, a parameter-free norm as an empty dict, as the JAX
    ``init`` leaves it. bfloat16 weights come out as float32."""
    cfg = model.cfg
    tree: dict = {"final_norm": {}}
    if hasattr(model, "shared_attn"):
        tree["shared_attn"] = {group: {} for group in model.shared_attn._modules}
    per_layer: dict = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(int(parts[1]), {})[tuple(parts[2:])] = to_numpy(t)
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = to_numpy(t)
    stages = []
    for kinds, reps, first in cfg.stages():
        slots = {}
        for j, kind in enumerate(kinds):
            if kind == "shared_attn":
                continue
            layers = [first + len(kinds) * i + j for i in range(reps)]
            slot: dict = {group: {} for group in model.layers[layers[0]]._modules}
            for path in per_layer[layers[0]]:
                node = slot
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = np.stack([per_layer[i][path] for i in layers])
            slots[f"slot{j}"] = slot
        stages.append(slots)
    tree["stages"] = stages
    return tree


def load_numpy_params(model, tree):
    """Load a JAX params tree (numpy leaves) into ``model`` in place, each
    leaf cast to its weight's dtype (the model's, or float32 for an MoE
    router and the mamba mixer's ``a_log`` / ``dt_bias`` / ``d_skip``);
    every weight must be present and shaped alike."""
    own = model.state_dict()
    state = {k: v.to(own[k].dtype) if k in own else v
             for k, v in params_from_numpy(tree, model.cfg).items()}
    model.load_state_dict(state, strict=True)
    return model


def adapters_from_numpy(store, tree):
    """Set the raw per-task adapters of ``store`` (a
    ``repro_torch.serve.adapters.TaskAdapterStore``) from a JAX store's raw
    tree with numpy leaves; ``set_raw`` validates the layout (structure,
    shapes, dtypes) and republishes the serving tree."""
    store.set_raw(tree_lib.map_(_tensor, tree))
    return store
