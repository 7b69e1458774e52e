"""Flat-path npz checkpointing for trees of tensors or numpy arrays.

Counterpart of ``repro.checkpoint.npz``, with the same file format: each
leaf is keyed by its tree path ("stages/0/slot0/attn/wq", keys joined as
``repro_torch.tree.paths`` joins them, which is how the reference's
``_paths`` joins them), the step under ``__step__``, written to a ``.tmp``
file and published with an atomic ``os.replace``. So a checkpoint written by
either package loads in the other; ``repro_torch.convert.params_to_numpy``
gives a model's weights in the reference's tree. Leaves may be tensors on
any device (bfloat16 is saved as float32) or arrays. Restore fills a
caller-provided template (every key present, shapes checked) and returns
numpy leaves.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np

from repro_torch import tree as tree_lib
from repro_torch.convert import to_numpy

PyTree = Any


def save_pytree(path: str, tree: PyTree, step: int | None = None) -> None:
    arrs = {k: to_numpy(v) for k, v in tree_lib.paths(tree)}
    if step is not None:
        arrs["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)  # atomic publish


def load_pytree(path: str, template: PyTree) -> tuple[PyTree, int | None]:
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else None
        restored = []
        for key, leaf in tree_lib.paths(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                    f"template {tuple(leaf.shape)}"
                )
            restored.append(arr)
    return tree_lib.unflatten(template, restored), step
