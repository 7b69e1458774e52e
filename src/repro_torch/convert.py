"""Weights from the JAX package into the port.

``params_from_numpy(tree)`` takes the JAX model's params pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the state dict of
``repro_torch.models.TransformerLM``. Leaves are found by the same flat
paths as ``repro/checkpoint/npz.py::_paths`` ("stages/0/slot0/attn/wq"); the
(P, ...) period axis of the one stage of an ("attn",) model is unstacked
into per-layer weights ("layers.3.attn.wq").

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
        if parts[1:3] != ["0", "slot0"] or len(parts) != 5:
            raise ValueError(
                f"{path}: only one-stage ('attn',) models are ported "
                "(stages/0/slot0/<group>/<name>)"
            )
        group, name = parts[3], parts[4]
        stacked = np.asarray(leaf)
        for i in range(stacked.shape[0]):
            state[f"layers.{i}.{group}.{name}"] = _tensor(stacked[i])
    return state


def load_numpy_params(model, tree):
    """Load a JAX params tree (numpy leaves) into ``model`` in place, cast
    to the model's dtype; every weight must be present and shaped alike."""
    state = {k: v.to(model.dtype) for k, v in params_from_numpy(tree).items()}
    model.load_state_dict(state, strict=True)
    return model


def adapters_from_numpy(store, tree):
    """Set the raw per-task adapters of ``store`` (a
    ``repro_torch.serve.adapters.TaskAdapterStore``) from a JAX store's raw
    tree with numpy leaves; ``set_raw`` validates the layout (structure,
    shapes, dtypes) and republishes the serving tree."""
    store.set_raw(tree_lib.map_(_tensor, tree))
    return store
