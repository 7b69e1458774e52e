"""Plain PyTorch versions of chunked flash prefill (GQA, causal/windowed,
per-slot offsets) over a dense cache and over a paged pool — the
counterparts of ``prefill_attention_reference`` and
``paged_prefill_attention_reference`` in the JAX package, and the oracles
the CUDA kernels are held against."""
import torch

from repro_torch.kernels.runtime import gather_pages, pos_vector, scale_for

NEG_INF = -1e30


def prefill_attention_reference(
    q: torch.Tensor,  # (B, KVH, C, G, hd)
    k: torch.Tensor,  # (B, S, KVH, hd)
    v: torch.Tensor,  # (B, S, KVH, hd)
    pos,  # () or (B,) positions of the chunk's FIRST token
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Query i of slot b sits at ``pos[b] + i`` and reads
    ``kv_idx <= pos[b] + i`` only — the decode mask with a per-query
    offset, which also gives in-chunk causality."""
    cq = q.shape[2]
    scores = torch.einsum("bkcgd,bskd->bkcgs", q.float(), k.float()) * scale_for(
        q.shape[-1]
    )  # (B, KVH, C, G, S)
    kv_pos = torch.arange(k.shape[1], device=k.device)
    pos_b = pos_vector(pos, q.shape[0], k.device)
    q_pos = pos_b[:, None] + torch.arange(cq, device=k.device)[None, :]  # (B, C)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]  # (B, C, S)
    if window is not None:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - window
    scores = torch.where(mask[:, None, :, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkcgs,bskd->bkcgd", w, v.float())
    return out.to(q.dtype)


def paged_prefill_attention_reference(
    q: torch.Tensor,  # (B, KVH, C, G, hd)
    k_pool: torch.Tensor,  # (num_blocks, block_size, KVH, hd)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks)
    pos,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Gather each slot's logical view (ids clamped) and run the dense
    version; masking by ``pos + i`` hides the null block and unmapped
    pages."""
    return prefill_attention_reference(
        q, gather_pages(k_pool, block_tables), gather_pages(v_pool, block_tables), pos,
        window=window,
    )
