"""Plain PyTorch version of flash decode (grouped GQA, causal/windowed) —
the counterpart of ``decode_attention_reference`` in the JAX package, and
the oracle the CUDA kernel is held against."""
import torch

from repro_torch.kernels.runtime import pos_vector, scale_for

NEG_INF = -1e30


def decode_attention_reference(
    q: torch.Tensor,  # (B, KVH, G, hd)
    k: torch.Tensor,  # (B, S, KVH, hd)
    v: torch.Tensor,  # (B, S, KVH, hd)
    pos,  # () or (B,) decode positions
    *,
    window: int | None = None,
) -> torch.Tensor:
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * scale_for(
        q.shape[-1]
    )
    kv_pos = torch.arange(k.shape[1], device=k.device)
    pos_b = pos_vector(pos, q.shape[0], k.device)
    mask = kv_pos[None, :] <= pos_b[:, None]
    if window is not None:
        mask &= kv_pos[None, :] > pos_b[:, None] - window
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.to(q.dtype)
