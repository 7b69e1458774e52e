"""Plain PyTorch versions of the graph-mixing contraction — the
counterparts of ``graph_mix_reference`` and ``graph_mix_tree_reference`` in
the JAX package, and the oracles the CUDA kernel is held against."""
import torch

from repro_torch import tree as tree_lib


def graph_mix_reference(mu: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k mu[k, i] theta[k]  ==  mu^T @ theta, accumulated in
    f32 and cast back to theta's dtype."""
    out = torch.einsum("ki,kd->id", mu.float(), theta.float())
    return out.to(theta.dtype)


def graph_mix_tree_reference(mu: torch.Tensor, tree):
    """Leaf-by-leaf oracle of ``graph_mix_tree``: every task-leading
    ``(m, ...)`` leaf is flattened, mixed and reshaped back."""
    m = mu.shape[0]
    return tree_lib.map_(
        lambda t: graph_mix_reference(mu, t.reshape(m, -1)).reshape(t.shape), tree
    )
