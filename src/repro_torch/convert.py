"""Weights between the JAX package and the port.

``params_from_numpy(tree)`` takes the JAX model's params pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the state dict of
``repro_torch.models.TransformerLM``. Leaves are found by the same flat
paths as ``repro/checkpoint/npz.py::_paths`` ("stages/0/slot0/attn/wq"); the
(P, ...) period axis of the one stage of an ("attn",) or ("attn_moe",)
model is unstacked into per-layer weights ("layers.3.attn.wq",
"layers.3.moe.shared.wg"). ``params_to_numpy(model)`` is
its inverse: the port's weights as the JAX params tree with numpy leaves,
so trained weights or a checkpoint cross back to JAX.

``adapters_from_numpy(store, tree)`` carries a JAX ``TaskAdapterStore``'s
raw tree (numpy leaves, ``jax.tree.map(np.asarray, store.raw)``) into the
port's store of the same layout; the model's per-task ``task.*`` params
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


def params_from_numpy(tree) -> dict[str, torch.Tensor]:
    state = {}
    for path, leaf in tree_lib.paths(tree):
        parts = path.split("/")
        if parts[0] != "stages":
            state[".".join(parts)] = _tensor(leaf)
            continue
        if parts[1:3] != ["0", "slot0"] or len(parts) < 5:
            raise ValueError(
                f"{path}: only one-stage ('attn',) and ('attn_moe',) models are ported "
                "(stages/0/slot0/<group>/...); MLA, mamba2, xLSTM, shared-attention and "
                "multi-stage layouts are not"
            )
        name = ".".join(parts[3:])
        stacked = np.asarray(leaf)
        for i in range(stacked.shape[0]):
            state[f"layers.{i}.{name}"] = _tensor(stacked[i])
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
    the per-layer weights restacked into the one stage's (P, ...) leaves
    ("stages/0/slot0/attn/wq", "stages/0/slot0/moe/shared/wg"), a
    parameter-free norm as an empty dict, as the JAX ``init`` leaves it.
    bfloat16 weights come out as float32."""
    tree: dict = {"final_norm": {}}
    slot: dict = {group: {} for group in model.layers[0]._modules}
    per_layer: dict = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(tuple(parts[2:]), {})[int(parts[1])] = to_numpy(t)
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = to_numpy(t)
    for path, by_layer in per_layer.items():
        node = slot
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([by_layer[i] for i in range(len(by_layer))])
    tree["stages"] = [{"slot0": slot}]
    return tree


def load_numpy_params(model, tree):
    """Load a JAX params tree (numpy leaves) into ``model`` in place, each
    leaf cast to its weight's dtype (the model's, or float32 for an MoE
    router); every weight must be present and shaped alike."""
    own = model.state_dict()
    state = {k: v.to(own[k].dtype) if k in own else v
             for k, v in params_from_numpy(tree).items()}
    model.load_state_dict(state, strict=True)
    return model


def adapters_from_numpy(store, tree):
    """Set the raw per-task adapters of ``store`` (a
    ``repro_torch.serve.adapters.TaskAdapterStore``) from a JAX store's raw
    tree with numpy leaves; ``set_raw`` validates the layout (structure,
    shapes, dtypes) and republishes the serving tree."""
    store.set_raw(tree_lib.map_(_tensor, tree))
    return store
