"""Operations and bytes of the work, counted from the traffic's own shapes
(whatever implements it), and the H100's peaks (``peaks.json``).

Float32 throughout: 4 bytes an element. A product of an (a, b) by a (b, c)
matrix is 2abc operations. Attention of one query over ``ctx`` visible keys
is 4 * H * hd * ctx operations a layer (scores and the weighted sum).
"""
from __future__ import annotations

import json
from pathlib import Path

F32 = 4
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def matmul_params(c: dict) -> int:
    """N: the weights of the products a token goes through (the layers'
    projections and MLP, the head), not the embedding gather, the norms or
    the per-task rows."""
    d, hd = c["d_model"], c["head_dim"]
    per_layer = (2 * d * c["num_heads"] * hd + 2 * d * c["num_kv_heads"] * hd
                 + 3 * d * c["d_ff"])
    return c["num_layers"] * per_layer + d * c["vocab_size"]


def attn_ops(c: dict, ctx_sum: float) -> float:
    """Attention operations of queries whose visible keys sum to ``ctx_sum``."""
    return 4.0 * c["num_layers"] * c["num_heads"] * c["head_dim"] * ctx_sum


def adapter_ops(c: dict, rank: int) -> int:
    """The two low-rank products of both branches of every layer, a token."""
    return 8 * c["num_layers"] * c["d_model"] * rank


def token_ops(c: dict, ntok: int, ctx_sum: float, rank: int = 0) -> float:
    """Useful operations of ``ntok`` computed tokens whose visible keys sum to
    ``ctx_sum``."""
    return ntok * (2.0 * matmul_params(c) + adapter_ops(c, rank)) + attn_ops(c, ctx_sum)


def prefill_rows(cached: int, length: int, chunk: int):
    """The (first position, tokens) of each dispatch of a prompt prefilled
    from ``cached`` in chunks of ``chunk``."""
    return [(p, min(chunk, length - p)) for p in range(cached, length, chunk)]


def serve_work(c: dict, spec: dict, rec) -> dict:
    """Useful operations and tokens of the window's computed positions:
    every prompt token prefilled (not those served from the prefix cache)
    and every decode row, each over its visible context."""
    rank = spec["store"]["rank"] if "store" in spec else 0
    n_pre, ctx_pre = 0, 0
    for rows in rec.admitted:
        for cached, length in rows:
            n_pre += length - cached
            ctx_pre += (length * (length + 1) - cached * (cached + 1)) // 2
    ops = (token_ops(c, n_pre, ctx_pre, rank)
           + token_ops(c, rec.decode_rows, rec.decode_ctx, rank))
    return {"ops": ops, "prefill_tokens": n_pre, "decode_tokens": rec.decode_rows}


def decode_attn_bound(c: dict, ctxs) -> float:
    """Least seconds of the decode attention of rows with visible contexts
    ``ctxs``: each row's K and V once, its query and output, every layer;
    against the f32 operations."""
    kv = 2 * c["num_kv_heads"] * c["head_dim"] * F32
    qo = 2 * c["num_heads"] * c["head_dim"] * F32
    total = sum(ctxs)
    nbytes = c["num_layers"] * (kv * total + qo * len(ctxs))
    return max(nbytes / PEAKS["hbm_bytes_per_s"], attn_ops(c, total) / PEAKS["f32_flops_per_s"])


def prefill_attn_bound(c: dict, rows) -> float:
    """Least seconds of the prefill attention of the valid rows: (first
    position, tokens) each, reading its visible K and V once. Operations
    against the rate of float32-exact products on the tensor cores (three
    TF32 products each, ``tf32_flops_per_s`` / 3), the prefill kernel's
    arithmetic."""
    kv = 2 * c["num_kv_heads"] * c["head_dim"] * F32
    qo = 2 * c["num_heads"] * c["head_dim"] * F32
    nbytes, ctx = 0, 0
    for p, n in rows:
        nbytes += kv * (p + n) + qo * n
        ctx += n * p + n * (n + 1) // 2
    nbytes *= c["num_layers"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               attn_ops(c, ctx) / (PEAKS["tf32_flops_per_s"] / 3))


def graph_mix_bound(m: int, d: int) -> float:
    """mu^T theta over (m, d): 2 m^2 d operations; mu, theta and the output
    once."""
    return max((m * m + 2 * m * d) * F32 / PEAKS["hbm_bytes_per_s"],
               2.0 * m * m * d / PEAKS["f32_flops_per_s"])


def store_width(c: dict, rank: int) -> int:
    """d of the store's one mix: every leaf's row, flattened."""
    d = c["d_model"]
    width = c["num_layers"] * 4 * d * rank + c["vocab_size"]
    return width + (d if c["norm_kind"] == "rmsnorm" else 0)


def train_step_ops(c: dict, b: int, s: int) -> float:
    """Model operations of one training step: 6 N T over T = b s tokens,
    plus the attention products as computed (every query against all S
    keys, masked): 4 b H S^2 hd a layer forward, three times that with the
    backward. (The arithmetic of ``chip_smoke.train_flops``.)"""
    attn = 3 * c["num_layers"] * 4 * b * c["num_heads"] * s * s * c["head_dim"]
    return 6.0 * matmul_params(c) * b * s + attn
