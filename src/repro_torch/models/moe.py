"""Mixture of experts with sort-based capacity dispatch: the port of
``repro.models.moe`` (GShard-style capacity, no one-hot dispatch product).

Each dispatch group routes its tokens to their ``top_k`` experts, sorts the
assignments by expert (stable, so ties keep token order), keeps the first
``cap`` of each expert and runs every expert's SwiGLU over its ``cap``-row
buffer as one batched product; dropped assignments add nothing. Shared
experts (DeepSeek-V2 style) are one always-on SwiGLU over every token. A
per-token router bias (the per-task routing of the graph-multi-task model)
is added to the router logits.

Shapes are static: the capacity comes from the token count, the top-k and
``capacity_factor`` in Python, so a dispatch reads no value back to the
host and runs inside a captured CUDA graph. The expert products are plain
``torch.bmm`` with float32 accumulation, as the reference's
``jnp.einsum(..., preferred_element_type=jnp.float32)``.

Where torch and JAX differ, the port follows JAX:

  * Dead tokens (``live`` False) go to the sentinel expert ``E``, which
    sorts last and takes no capacity. JAX drops the out-of-range ``E`` from
    its ``(E,)`` count scatter; torch's scatters raise on it, so the port
    counts into ``E + 1`` bins and slices the sentinel's off.
  * A buffer row is gathered from the one assignment that lands there, not
    scattered, so no two writes meet (JAX's scatter only collides on its
    discarded overflow row).
  * The combine scatter-adds ``top_k`` float32 terms into each token's
    zero row. At ``top_k`` <= 2 that sum is exact in any order, so the
    atomic adds of CUDA give the reference's result; at ``top_k`` > 2 the
    order, and so the last bit, may differ.
  * ``torch.topk`` and ``jax.lax.top_k`` may order tied probabilities
    differently; ties of float32 router probabilities do not occur in
    practice, and the tests draw inputs without them.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, silu


def init_moe(d: int, d_ff: int, n_experts: int, n_shared: int, dtype,
             generator: torch.Generator) -> dict:
    """Router (d, E) in float32 whatever ``dtype``, the experts' SwiGLU
    weights (E, d, d_ff) / (E, d_ff, d), and ``shared``, one SwiGLU of
    width ``n_shared * d_ff``, when ``n_shared`` > 0."""
    p = {
        "router": dense_init((d, n_experts), generator, dtype=torch.float32),
        "wg": dense_init((n_experts, d, d_ff), generator, in_axis=1, dtype=dtype),
        "wi": dense_init((n_experts, d, d_ff), generator, in_axis=1, dtype=dtype),
        "wo": dense_init((n_experts, d_ff, d), generator, in_axis=1, dtype=dtype),
    }
    if n_shared > 0:
        p["shared"] = init_mlp(d, n_shared * d_ff, "swiglu", dtype, generator)
    return p


def _experts(params, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its rows. buf: (E, R, d) in the
    activations' dtype. The gate and up products accumulate and stay in
    float32 (SiLU at float32); their product is cast to buf's dtype before
    the down product, whose float32 result is cast back."""
    xf = buf.float()
    gate = silu(torch.bmm(xf, params["wg"].float()))
    up = torch.bmm(xf, params["wi"].float())
    h = (gate * up).to(buf.dtype)
    return torch.bmm(h.float(), params["wo"].float()).to(buf.dtype)


def _moe_groups(params, xg, bias, top_k: int, cap: int, live):
    """Dispatch, expert compute and combine for G groups at once: the
    reference's ``_moe_one_group`` over a leading group axis (its vmap),
    the experts' products batched across the groups.

    xg: (G, T, d); bias: optional (G, T, E); live: optional (G, T) bool.
    Returns (out (G, T, d) in xg's dtype, aux (G,) float32)."""
    g, t, d = xg.shape
    e = params["router"].shape[1]
    dev = xg.device
    logits = torch.matmul(xg.float(), params["router"].float())  # (G, T, E)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)  # (G, T, k), descending
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Switch-style load-balance loss: every token's top-k counts, dead ones
    # too, as in the reference
    a = t * top_k
    me = probs.mean(dim=1)  # (G, E)
    # analysis: ignore[R001] -- top-k indices over the E experts lie in [0, E)
    ce = torch.zeros((g, e), dtype=torch.float32, device=dev).scatter_add_(
        1, expert_idx.reshape(g, a), torch.ones((g, a), dtype=torch.float32, device=dev)
    ) / a
    aux = e * (me * ce).sum(dim=-1)

    # sort-based dispatch; dead tokens to the sentinel expert e
    flat_expert = expert_idx.reshape(g, a)
    if live is not None:
        flat_expert = torch.where(live.repeat_interleave(top_k, dim=1), flat_expert, e)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    se = flat_expert.gather(1, order)
    sg = gate_vals.reshape(g, a).gather(1, order)
    st_tok = torch.div(order, top_k, rounding_mode="floor")  # token of each assignment
    counts = torch.zeros((g, e + 1), dtype=torch.long, device=dev).scatter_add_(
        1, se, torch.ones_like(se)
    )[:, :e]
    starts = counts.cumsum(dim=1) - counts  # (G, E)
    slot = torch.arange(a, device=dev) - starts.gather(1, se.clamp(max=e - 1))
    keep = (slot < cap) & (se < e)
    dest = torch.where(keep, se * cap + slot, 0)

    # buffer row (expert j, c) holds the token of sorted assignment
    # starts[j] + c, when c < counts[j] (and c < cap by construction)
    c_idx = torch.arange(cap, device=dev)
    src = (starts[:, :, None] + c_idx).clamp(max=a - 1).reshape(g, e * cap)
    filled = (c_idx < counts[:, :, None]).reshape(g, e * cap, 1)
    rows = st_tok.gather(1, src)  # (G, E * cap)
    buf = torch.where(filled, xg.gather(1, rows[..., None].expand(-1, -1, d)), 0)
    buf = buf.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    y = _experts(params, buf).reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)

    # combine: each kept assignment adds gate * its expert's row, in float32
    y_assign = torch.where(keep[..., None], y.gather(1, dest[..., None].expand(-1, -1, d)), 0)
    out = torch.zeros((g, t, d), dtype=torch.float32, device=dev).scatter_add_(
        1, st_tok[..., None].expand(-1, -1, d), y_assign.float() * sg[..., None]
    )
    return out.to(xg.dtype), aux


def apply_moe(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              router_bias: torch.Tensor | None = None, groups: int = 1,
              live: torch.Tensor | None = None):
    """x: (B, S, d) -> (out (B, S, d), aux loss () float32).

    router_bias: optional (B, S, E) per-token logit bias. ``groups``: the
    number of dispatch groups (tokens are batch-major; a count that does
    not divide B * S, or exceeds it, falls back to 1), each with capacity
    ``ceil(tokens per group * top_k * capacity_factor / E)``. live:
    optional (B,) or (B, S) bool; dead tokens take no capacity and cannot
    move a live token's routing, and their own rows come out zero (plus
    the shared experts' term)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    if t % groups != 0 or t < groups:
        groups = 1
    tg = t // groups
    cap = int(max(1, -(-tg * top_k * capacity_factor // e)))  # ceil per group
    bias = None if router_bias is None else router_bias.reshape(groups, tg, e)
    lv = None
    if live is not None:
        lv = live if live.ndim == 2 else live[:, None].expand(b, s)
        lv = lv.reshape(groups, tg)
    out, aux = _moe_groups(params, x.reshape(groups, tg, d), bias, top_k, cap, lv)
    out = out.reshape(b, s, d)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x.reshape(t, d), "swiglu").reshape(b, s, d)
    return out, aux.mean()
