"""GQA attention (± QKV bias, ± sliding window) and DeepSeek-V2's
multi-head latent attention (MLA): full-sequence causal attention for
training, and attention over a dense KV cache or a paged KV pool for
serving.

Counterpart of ``repro.models.attention``. The training
forward attends through ``causal_attend``: query-chunked masked softmax in
plain torch, the reference's arithmetic (no kernel: the reference's is plain
``jnp`` too, whatever ``attn_backend`` says). The serving
cache paths (decode tick + parallel prefill chunk) dispatch through
``cached_attend`` on ``ArchConfig.attn_backend``: ``"plain"`` runs the
masked-softmax ``decode_attend`` below (the reference semantics; over the
``gather_pages`` view when paged), ``"kernel"`` runs the hand-written CUDA
kernels in ``repro_torch.kernels.decode_attention`` (one query token) and
``repro_torch.kernels.prefill_attention`` (a (B, C) chunk slab), dense or
paged.

MLA (``init_mla``, ``mla_full``, ``mla_decode``) is plain torch on every
backend, as in the reference (``kernels.runtime.resolve_attn_backend``):
training attends through ``causal_attend`` over the up-projected heads;
serving runs the absorbed-matrix decode over the compressed caches, a
(…, kv_lora) latent and a (…, qk_rope) rotary key per token, shared by
every head.

Shapes: x (B, C, d); q (B, C, H, hd); dense caches (B, max_seq, KVH, hd)
(MLA: (B, max_seq, r)) written at per-slot positions; paged pools
(num_blocks, block_size, KVH, hd) (MLA: (num_blocks, block_size, r))
written through a (B, max_blocks) block table. Every write is in place
(``index_put_``), where the JAX functions return new arrays.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.prefill_attention.ops import (
    paged_prefill_attention,
    prefill_attention,
)
from repro_torch.kernels.runtime import gather_pages, pos_vector, scale_for
from repro_torch.models.layers import apply_rope, dense_init, matmul
from repro_torch.sharding.tensor_parallel import (
    cached_attention,
    is_dtensor,
    split_ready,
    tp_input,
)

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
    x = tp_input(x, params["wq"])  # once for the three products
    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (
        split_ready(q, -1, n_heads).reshape(b, s, n_heads, head_dim),
        split_ready(k, -1, n_kv).reshape(b, s, n_kv, head_dim),
        split_ready(v, -1, n_kv).reshape(b, s, n_kv, head_dim),
    )


def causal_attend(q, k, v, *, sliding_window=None, q_chunk: int = 1024, q_start: int = 0):
    """Query-chunked causal (optionally windowed) attention, the reference's
    ``causal_attend`` op for op: chunks of ``q_chunk`` queries (one chunk
    when ``q_chunk`` does not divide S), each against all S keys, with the
    GQA group kept as an explicit (KVH, G) split; float32 scores, masked to
    ``NEG_INF`` (never -inf, so a row stays finite), the probabilities cast
    to q's dtype before the second product, accumulated in float32.

    q: (B, S, H, hd); k, v: (B, S_kv, KVH, hd) with S_kv = S, or the whole
    sequence's keys for a block of S queries from position ``q_start`` (a
    rank's share of the queries, ``sharding.tensor_parallel.attention``).
    Returns (B, S, H, hd_v)."""
    b, s, h, hd = q.shape
    hd_v = v.shape[-1]
    kvh = k.shape[2]
    g = h // kvh
    scale = scale_for(hd)
    q_chunk = min(q_chunk, s)
    if s % q_chunk != 0:  # fall back to one chunk when not divisible
        q_chunk = s
    qg = q.reshape(b, s // q_chunk, q_chunk, kvh, g, hd)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    kf, vf = k.float(), v.float()
    outs = []
    for ci in range(s // q_chunk):
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg[:, ci].float(), kf) * scale
        q_pos = q_start + ci * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if sliding_window is not None:
            mask &= kv_pos[None, :] > q_pos[:, None] - sliding_window
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", w.to(q.dtype).float(), vf)
        outs.append(out.to(q.dtype))  # (B, qc, KVH, G, hd_v)
    return torch.cat(outs, dim=1).reshape(b, s, h, hd_v)


def masked_scores(q, k_cache, pos, sliding_window=None, kv_start: int = 0):
    """``decode_attend``'s float32 scores (B, KVH, G, C, S) of a (B, C, H,
    hd) query chunk against (B, S, KVH, hd) keys, masked to ``NEG_INF``
    outside ``kv_idx <= pos + i`` (and the window); the keys' first row is
    position ``kv_start`` (a rank's block of a sequence-split cache,
    ``sharding.tensor_parallel.cached_attention``)."""
    b, c, h, hd = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, c, kvh, h // kvh, hd)
    # analysis: ignore[R005] -- the reference's decode_attend contracts at this dtype too
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float()
    scores = scores * scale_for(hd)  # (B, KVH, G, C, S)
    kv_pos = torch.arange(kv_start, kv_start + k_cache.shape[1], device=q.device)
    q_pos = pos_vector(pos, b, q.device)[:, None] + torch.arange(c, device=q.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]  # (B, C, S)
    if sliding_window is not None:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - sliding_window
    return torch.where(mask[:, None, None, :, :], scores, NEG_INF)


def decode_attend(q, k_cache, v_cache, pos, *, sliding_window=None):
    """Chunk-of-queries attention against a cache (the plain backend).

    q: (B, C, H, hd) — C == 1 is the decode tick, C > 1 the parallel
    prefill chunk; caches: (B, max_seq, KVH, hd); pos: () or (B,) positions
    of the FIRST query token (query i sits at ``pos + i`` and reads
    ``kv_idx <= pos + i`` only; the cache already holds the whole chunk).
    Returns (B, C, H, hd). On DTensor caches (the dry run's serving steps)
    each rank attends over its own shards (``tp.cached_attention``)."""
    if is_dtensor(k_cache):
        return cached_attention(q, k_cache, v_cache, pos, masked_scores,
                                sliding_window=sliding_window)
    b, c, h, _ = q.shape
    w = torch.softmax(masked_scores(q, k_cache, pos, sliding_window), dim=-1)
    # analysis: ignore[R005] -- the reference's decode_attend contracts at this dtype too
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(q.dtype), v_cache)
    return out.to(q.dtype).reshape(b, c, h, v_cache.shape[-1])


def cached_attend(q, k_cache, v_cache, pos, *, sliding_window=None,
                  backend: str = "kernel", block_tables=None):
    """GQA chunk-of-queries attention against the cache, dispatching on the
    serving attention backend (``ArchConfig.attn_backend``). Dense caches
    are (B, S, KVH, hd); with ``block_tables`` (B, max_blocks) int32 the
    caches are the shared (num_blocks, block_size, KVH, hd) pools.

      * ``"plain"``  — ``decode_attend`` (the reference semantics), over
        the ``gather_pages`` view of the pools when paged.
      * ``"kernel"`` — ``decode_attention`` / ``paged_decode_attention``
        for a C == 1 query, ``prefill_attention`` /
        ``paged_prefill_attention`` for C > 1: the CUDA kernels on CUDA
        tensors (the paged ones walk the table themselves; no view is
        built), their plain versions on CPU tensors."""
    if backend == "kernel":
        decode = q.shape[1] == 1
        if block_tables is None:
            op = decode_attention if decode else prefill_attention
            return op(q, k_cache, v_cache, pos, window=sliding_window)
        op = paged_decode_attention if decode else paged_prefill_attention
        return op(q, k_cache, v_cache, block_tables, pos, window=sliding_window)
    if backend == "plain":
        if block_tables is not None:
            k_cache = gather_pages(k_cache, block_tables)
            v_cache = gather_pages(v_cache, block_tables)
        return decode_attend(q, k_cache, v_cache, pos, sliding_window=sliding_window)
    raise ValueError(f"unknown attention backend {backend!r}")


# --------------------------------------------------------- paged KV cache
def _physical(block_tables, blk, nb):
    """Physical ids of table columns ``blk`` (already within the table);
    an id outside the pool is routed to the null block 0, where the JAX
    scatter drops it — block 0 is never read unmasked, so the two agree on
    every row attention can see."""
    # analysis: ignore[R001] -- the callers clamp blk to the table width
    bidx = torch.gather(block_tables.long(), 1, blk)
    return torch.where((bidx >= 0) & (bidx < nb), bidx, 0)


def paged_cache_write(pool, new, pos, block_tables, live=None):
    """Write one token per slot into the shared block pool, IN PLACE.

    pool: (num_blocks, block_size, ...); new: (B, 1, ...); pos: (B,) logical
    positions; block_tables: (B, max_blocks). The table column
    ``pos // block_size`` is clamped to the table width (a dead slot's
    stale pos can point past it; JAX ``mode="clip"``), and dead slots
    (``live == False``) are then routed to the null block 0, so the write
    is unconditional. Live slots own disjoint blocks, so lanes collide only
    in block 0, which is never read. Returns the pool."""
    bs, mb = pool.shape[1], block_tables.shape[1]
    pos = pos.long()
    blk = torch.div(pos, bs, rounding_mode="floor").clamp(0, mb - 1)
    bidx = _physical(block_tables, blk[:, None], pool.shape[0])[:, 0]
    if live is not None:
        bidx = torch.where(live, bidx, 0)
    pool.index_put_((bidx, torch.remainder(pos, bs)), new[:, 0].to(pool.dtype))
    return pool


def paged_cache_write_slab(pool, new, pos, block_tables, valid):
    """Write a whole (B, C) prefill chunk into the shared block pool, IN
    PLACE: chunk token i of slot b lands at logical position ``pos[b] + i``.
    valid: (B, C) — invalid lanes (prompt shorter than the chunk, slots not
    being prefilled) are routed to the null block 0, like dead slots in
    ``paged_cache_write``; table columns are clamped to the table width.
    Chunk tokens of one slot occupy distinct (block, row) pairs, so lanes
    collide only in block 0. Returns the pool."""
    bs, mb = pool.shape[1], block_tables.shape[1]
    c = new.shape[1]
    tgt = pos.long()[:, None] + torch.arange(c, device=pool.device)[None, :]  # (B, C)
    blk = torch.div(tgt, bs, rounding_mode="floor").clamp(0, mb - 1)
    bidx = torch.where(valid, _physical(block_tables, blk, pool.shape[0]), 0)
    pool.index_put_((bidx, torch.remainder(tgt, bs)), new.to(pool.dtype))
    return pool


# --------------------------------------------------------------------- MLA
@dataclasses.dataclass(frozen=True)
class MLADims:
    n_heads: int
    qk_nope: int  # per-head non-rotary key/query dims
    qk_rope: int  # shared rotary dims
    v_dim: int
    kv_lora: int


def init_mla(d: int, dims: MLADims, dtype, generator: torch.Generator) -> dict:
    h, dn, dr, dv, r = dims.n_heads, dims.qk_nope, dims.qk_rope, dims.v_dim, dims.kv_lora
    return {
        "wq": dense_init((d, h * (dn + dr)), generator, dtype=dtype),
        "w_dkv": dense_init((d, r), generator, dtype=dtype),  # compress
        "w_krope": dense_init((d, dr), generator, dtype=dtype),  # shared rope key
        "w_uk": dense_init((r, h * dn), generator, dtype=dtype),  # up: keys
        "w_uv": dense_init((r, h * dv), generator, dtype=dtype),  # up: values
        "wo": dense_init((h * dv, d), generator, dtype=dtype),
    }


def mla_full(params, x, dims: MLADims, positions, theta, q_chunk: int = 1024):
    """Materialized MLA for training: the heads' keys and values are
    up-projected from the latent and attended through ``causal_attend`` at
    query width qk_nope + qk_rope (so scaled by its inverse square root).
    x: (B, S, d); positions: (B, S). Returns (out (B, S, d), (c_kv (B, S,
    r), k_rope (B, S, qk_rope)))."""
    b, s, _ = x.shape
    h, dn, dr, dv = dims.n_heads, dims.qk_nope, dims.qk_rope, dims.v_dim
    q = matmul(x, params["wq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, theta)
    c_kv = matmul(x, params["w_dkv"])  # (B, S, r)
    k_rope = apply_rope(matmul(x, params["w_krope"])[:, :, None, :], positions,
                        theta)  # (B, S, 1, dr), shared across heads
    k_nope = matmul(c_kv, params["w_uk"]).reshape(b, s, h, dn)
    v = matmul(c_kv, params["w_uv"]).reshape(b, s, h, dv)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    out = causal_attend(q_full, k_full, v, q_chunk=q_chunk)
    out = matmul(out.reshape(b, s, h * dv), params["wo"])
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(params, x, dims: MLADims, c_cache, krope_cache, pos, theta):
    """Absorbed-matrix MLA over the compressed caches: W_uk is folded into
    the query and W_uv applied after the weighted sum, so scores and context
    live in the kv_lora space and the per-token cache is kv_lora + qk_rope
    wide. Everything from the absorbed query to the W_uv product computes
    in float32 whatever the dtype; only the result is cast back to x's
    dtype before ``wo``.

    x: (B, C, d) — C == 1 is the decode tick, C > 1 the parallel prefill
    chunk; c_cache (B, S, r) and krope_cache (B, S, qk_rope) already hold
    the whole chunk (a paged pool's ``gather_pages`` view); pos: () or (B,)
    positions of the FIRST query token (query i sits at ``pos + i`` and
    reads ``kv_idx <= pos + i`` only). Returns (B, C, d)."""
    b, c, _ = x.shape
    h, dn, dr, dv, r = dims.n_heads, dims.qk_nope, dims.qk_rope, dims.v_dim, dims.kv_lora
    q_pos = pos_vector(pos, b, x.device)[:, None] + torch.arange(c, device=x.device)
    q = matmul(x, params["wq"]).reshape(b, c, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, q_pos, theta)
    w_uk = params["w_uk"].reshape(r, h, dn)
    q_c = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk.float())
    c_f = c_cache.float()
    scores = (torch.einsum("bqhr,bkr->bhqk", q_c, c_f)
              + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), krope_cache.float())
              ) * scale_for(dn + dr)
    kv_pos = torch.arange(c_cache.shape[1], device=x.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]  # (B, C, S)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkr->bqhr", w, c_f)  # (B, C, H, r)
    w_uv = params["w_uv"].reshape(r, h, dv)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv.float()).to(x.dtype)
    return matmul(out.reshape(b, c, h * dv), params["wo"])
