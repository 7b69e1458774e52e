"""Plain PyTorch versions of flash decode (grouped GQA, causal/windowed)
over a dense cache and over a paged pool — the counterparts of
``decode_attention_reference`` and ``paged_decode_attention_reference`` in
the JAX package, and the oracles the CUDA kernels are held against."""
import torch

from repro_torch.kernels.runtime import gather_pages, pos_vector, scale_for

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


def paged_decode_attention_reference(
    q: torch.Tensor,  # (B, KVH, G, hd)
    k_pool: torch.Tensor,  # (num_blocks, block_size, KVH, hd)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks)
    pos,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Gather each slot's logical view (``max_blocks * block_size`` rows,
    ids clamped) and run the dense version: masking by ``pos`` hides the
    null block and unmapped pages, and a row that sees no key averages all
    logical rows, null-block rows included, as the JAX kernel does."""
    return decode_attention_reference(
        q, gather_pages(k_pool, block_tables), gather_pages(v_pool, block_tables), pos,
        window=window,
    )
