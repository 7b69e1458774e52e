"""Public ops ``graph_mix`` and ``graph_mix_tree``: the neighbour-mixing
contraction ``mu^T @ theta`` over task-stacked parameters.

On CUDA tensors ``graph_mix`` launches the hand-written kernel
(``csrc/graph_mix.cu``) or raises; on CPU tensors it runs the plain version
in ``ref.py``. ``graph_mix.launches`` counts kernel launches (CPU calls do
not count). ``graph_mix_tree`` mixes every leaf of a tree of task-leading
tensors with one ``graph_mix`` call per leaf dtype."""
import ctypes

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import runtime
from repro_torch.kernels.graph_mix.ref import graph_mix_reference

_lib = None


def _lib_fn():
    global _lib
    if _lib is None:
        lib = runtime.load_library("graph_mix")
        fn = lib.graph_mix_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def graph_mix(mu: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """mu: (m, m) mixing weights (column i = the weights into task i);
    theta: (m, d) stacked parameters, float32 or bfloat16. Returns
    ``mu^T @ theta`` in theta's dtype, accumulated in float32."""
    if theta.ndim != 2 or mu.shape != (theta.shape[0], theta.shape[0]):
        raise ValueError(
            f"graph_mix: want mu (m, m) and theta (m, d), got {tuple(mu.shape)} and "
            f"{tuple(theta.shape)}"
        )
    if mu.device.type == "cpu" and theta.device.type == "cpu":
        return graph_mix_reference(mu, theta)
    if mu.device != theta.device or theta.device.type != "cuda":
        raise ValueError(
            f"graph_mix: mu and theta must lie on one CUDA device, got {mu.device} and "
            f"{theta.device}"
        )
    if theta.dtype not in runtime.DTYPE_CODES:
        raise TypeError(f"graph_mix: theta dtype {theta.dtype} not in {list(runtime.DTYPE_CODES)}")
    if not theta.is_contiguous():
        raise ValueError("graph_mix: theta must be contiguous")
    m, d = theta.shape
    mu = mu.float().contiguous()  # the reference mixes with f32 weights
    out = torch.empty_like(theta)
    if out.numel() == 0:
        return out
    vec = m % 4 == 0 and d % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (mu, theta, out)
    )
    err = _lib_fn().graph_mix_launch(
        mu.data_ptr(), theta.data_ptr(), out.data_ptr(), m, d,
        runtime.DTYPE_CODES[theta.dtype], int(vec),
        torch.cuda.current_stream(theta.device).cuda_stream,
    )
    runtime.check_launch("graph_mix", err)
    graph_mix.launches += 1
    return out


graph_mix.launches = 0


def graph_mix_tree(mu: torch.Tensor, tree):
    """Mix EVERY leaf of a tree of stacked per-task parameters in one
    ``graph_mix`` call per distinct leaf dtype.

    Every leaf must be task-leading, ``(m, ...)`` with ``m == mu.shape[0]``.
    Leaves are flattened to ``(m, d_i)``, concatenated along the
    personalization axis into one ``(m, sum d_i)`` block per dtype, mixed,
    then split and reshaped back (views into the mixed block)."""
    leaves = tree_lib.leaves(tree)
    if not leaves:
        return tree
    m = mu.shape[0]
    for leaf in leaves:
        if leaf.ndim == 0 or leaf.shape[0] != m:
            raise ValueError(
                f"graph_mix_tree: every leaf must be task-leading (m={m}, ...); got "
                f"leaf shape {tuple(leaf.shape)}"
            )
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    mixed: list = [None] * len(leaves)
    for idxs in groups.values():
        flat = [leaves[i].reshape(m, -1) for i in idxs]
        block = torch.cat(flat, dim=1) if len(flat) > 1 else flat[0].contiguous()
        out = graph_mix(mu, block)
        off = 0
        for i, f in zip(idxs, flat):
            sz = f.shape[1]
            mixed[i] = out[:, off : off + sz].view(leaves[i].shape)
            off += sz
    it = iter(mixed)
    return tree_lib.map_(lambda _: next(it), tree)
