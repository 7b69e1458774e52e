"""GQA attention (± QKV bias, ± sliding window) over a dense KV cache.

Counterpart of the serving part of ``repro.models.attention``. The serving
cache paths (decode tick + parallel prefill chunk) dispatch through
``cached_attend`` on ``ArchConfig.attn_backend``: ``"plain"`` runs the
masked-softmax ``decode_attend`` below (the reference semantics),
``"kernel"`` runs the hand-written CUDA kernels in
``repro_torch.kernels.decode_attention`` (one query token) and
``repro_torch.kernels.prefill_attention`` (a (B, C) chunk slab).

Shapes: x (B, C, d); q (B, C, H, hd); caches (B, max_seq, KVH, hd) written
at per-slot positions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.prefill_attention.ops import prefill_attention
from repro_torch.kernels.runtime import pos_vector, scale_for
from repro_torch.models.layers import dense_init, matmul

NEG_INF = -1e30


def init_gqa(d: int, n_heads: int, n_kv: int, head_dim: int, qkv_bias: bool,
             dtype, generator: torch.Generator) -> dict:
    p = {
        "wq": dense_init((d, n_heads * head_dim), generator, dtype=dtype),
        "wk": dense_init((d, n_kv * head_dim), generator, dtype=dtype),
        "wv": dense_init((d, n_kv * head_dim), generator, dtype=dtype),
        "wo": dense_init((n_heads * head_dim, d), generator, dtype=dtype),
    }
    if qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
    return p


def gqa_project(params, x, n_heads, n_kv, head_dim):
    b, s, _ = x.shape
    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (
        q.reshape(b, s, n_heads, head_dim),
        k.reshape(b, s, n_kv, head_dim),
        v.reshape(b, s, n_kv, head_dim),
    )


def decode_attend(q, k_cache, v_cache, pos, *, sliding_window=None):
    """Chunk-of-queries attention against a cache (the plain backend).

    q: (B, C, H, hd) — C == 1 is the decode tick, C > 1 the parallel
    prefill chunk; caches: (B, max_seq, KVH, hd); pos: () or (B,) positions
    of the FIRST query token (query i sits at ``pos + i`` and reads
    ``kv_idx <= pos + i`` only; the cache already holds the whole chunk).
    Returns (B, C, H, hd)."""
    b, c, h, hd = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, c, kvh, h // kvh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float()
    scores = scores * scale_for(hd)  # (B, KVH, G, C, S)
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)
    q_pos = pos_vector(pos, b, q.device)[:, None] + torch.arange(c, device=q.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]  # (B, C, S)
    if sliding_window is not None:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - sliding_window
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(q.dtype), v_cache)
    return out.to(q.dtype).reshape(b, c, h, v_cache.shape[-1])


def cached_attend(q, k_cache, v_cache, pos, *, sliding_window=None,
                  backend: str = "kernel", block_tables=None):
    """GQA chunk-of-queries attention against the dense cache, dispatching
    on the serving attention backend (``ArchConfig.attn_backend``):

      * ``"plain"``  — ``decode_attend`` (the reference semantics).
      * ``"kernel"`` — ``decode_attention`` for a C == 1 query,
        ``prefill_attention`` for C > 1: the CUDA kernels on CUDA tensors,
        their plain versions on CPU tensors.

    The paged cache (``block_tables``) belongs to a later slice of the port
    and raises here."""
    if block_tables is not None:
        raise NotImplementedError(
            "paged KV caches (block_tables) are not ported yet: dense caches only"
        )
    if backend == "kernel":
        op = decode_attention if q.shape[1] == 1 else prefill_attention
        return op(q, k_cache, v_cache, pos, window=sliding_window)
    if backend == "plain":
        return decode_attend(q, k_cache, v_cache, pos, sliding_window=sliding_window)
    raise ValueError(f"unknown attention backend {backend!r}")
