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

On DTensors (the sharded train step, ``repro_torch.sharding``) the
dispatch is shard-local, as the reference's ``vmap`` over data-sharded
groups lowers: ``_moe_groups`` runs through ``local_map`` on each rank's
own groups (the group axis split as the tokens are, ``moe_groups`` =
the data ranks), so the sort, the scatters and the capacity arithmetic see
local tensors only. Each rank routes its groups' tokens over every expert
(router replicated) and computes the experts it holds: a slice of them
where the rules split the expert axis over the model ranks (expert
parallelism), or every expert's slice of the ff dim where they split ff
(``regather_expert_weights``, the reference's ``fsdp_gather_moe``). The
output is then ``Partial`` over the model ranks, and so is the aux loss,
which the first model rank alone carries.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, silu
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.rules import Spec, placements


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


def regather_expert_weights(params):
    """The reference's explicit FSDP gather of the expert weights: on
    DTensors, ``wg`` / ``wi`` to ``Spec(None, None, "model")`` and ``wo``
    to ``Spec(None, "model", None)`` (only the ff dim on the model axis),
    so the expert products contract a whole d against model-split ff. Plain
    tensors come back as they are."""
    if not tp.is_dtensor(params["wg"]):
        return params
    out = dict(params)
    for name, spec in (("wg", Spec(None, None, "model")), ("wi", Spec(None, None, "model")),
                       ("wo", Spec(None, "model", None))):
        w = params[name]
        out[name] = w.redistribute(w.device_mesh, placements(spec, w.device_mesh))
    return out


def _moe_groups(params, xg, bias, top_k: int, cap: int, live, experts=None):
    """Dispatch, expert compute and combine for G groups at once: the
    reference's ``_moe_one_group`` over a leading group axis (its vmap),
    the experts' products batched across the groups.

    xg: (G, T, d); bias: optional (G, T, E); live: optional (G, T) bool;
    experts: optional (first, count) of the experts whose weights
    ``params`` holds (all E by default; every assignment is routed over all
    E, and only these experts' outputs are combined).
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
    lo, n = (0, e) if experts is None else experts
    keep = (slot < cap) & (se >= lo) & (se < lo + n)
    dest = torch.where(keep, (se - lo) * cap + slot, 0)

    # buffer row (expert lo + j, c) holds the token of sorted assignment
    # starts[lo + j] + c, when c < counts[lo + j] (and c < cap by construction)
    c_idx = torch.arange(cap, device=dev)
    src = (starts[:, lo:lo + n, None] + c_idx).clamp(max=a - 1).reshape(g, n * cap)
    filled = (c_idx < counts[:, lo:lo + n, None]).reshape(g, n * cap, 1)
    rows = st_tok.gather(1, src)  # (G, n * cap)
    buf = torch.where(filled, xg.gather(1, rows[..., None].expand(-1, -1, d)), 0)
    buf = buf.reshape(g, n, cap, d).transpose(0, 1).reshape(n, g * cap, d)
    y = _experts(params, buf).reshape(n, g, cap, d).transpose(0, 1).reshape(g, n * cap, d)

    # combine: each kept assignment adds gate * its expert's row, in float32
    y_assign = torch.where(keep[..., None], y.gather(1, dest[..., None].expand(-1, -1, d)), 0)
    out = torch.zeros((g, t, d), dtype=torch.float32, device=dev).scatter_add_(
        1, st_tok[..., None].expand(-1, -1, d), y_assign.float() * sg[..., None]
    )
    return out.to(xg.dtype), aux


def _moe_sharded(params, xg, bias, top_k: int, cap: int, live):
    """``_moe_groups`` on DTensors, shard-local through ``local_map`` (see
    the module docstring). On each mesh dim: where the expert weights are
    split (expert axis or ff), every rank takes all its groups' tokens
    whole and the output is ``Partial``; else where the groups are split,
    the weights are whole and their gradients ``Partial``; else both are
    whole."""
    import torch.distributed.tensor as dt
    from torch.distributed.tensor.experimental import local_map

    mesh = params["router"].device_mesh
    xg = tp.as_dtensor(xg, mesh)
    names = ("wg", "wi", "wo")
    kinds = {"wg": (0, 2), "wi": (0, 2), "wo": (0, 1)}  # expert axis, ff axis

    def layout(i):
        """'experts', 'ff', 'groups' or None: what mesh dim i splits."""
        pls = [params[k].placements[i] for k in names]
        for j, kind in enumerate(("experts", "ff")):
            if all(tp.is_split(p, kinds[k][j]) for p, k in zip(pls, names)):
                return kind
        return "groups" if tp.is_split(xg.placements[i], 0) else None

    lay = [layout(i) for i in range(mesh.ndim)]
    whole, part = dt.Replicate(), dt.Partial()
    split_w = [lay[i] in ("experts", "ff") for i in range(mesh.ndim)]
    tok_pl = [dt.Shard(0) if k == "groups" else whole for k in lay]
    w = {k: params[k].redistribute(mesh, [
        dt.Shard(kinds[k][0] if lay[i] == "experts" else kinds[k][1]) if split_w[i] else whole
        for i in range(mesh.ndim)]) for k in names}
    router = params["router"].redistribute(mesh, [whole] * mesh.ndim)
    args = [router, w["wg"], w["wi"], w["wo"], xg.redistribute(mesh, tok_pl)]
    tok_grad = [part if s else p for s, p in zip(split_w, tok_pl)]
    grads = [[part if (k == "groups" or s) else whole for k, s in zip(lay, split_w)]]
    grads += [[part if k == "groups" else p for k, p in zip(lay, w[n].placements)]
              for n in names]
    grads.append(tok_grad)
    if bias is not None:
        args.append(tp.as_dtensor(bias, mesh).redistribute(mesh, tok_pl))
        grads.append(tok_grad)
    if live is not None:
        args.append(tp.as_dtensor(live, mesh).redistribute(mesh, tok_pl))
        grads.append(tok_pl)
    n_exp, first = tp.local_rows(w["wg"], 0)
    coord = mesh.get_coordinate()
    lead = all(coord[i] == 0 for i in range(mesh.ndim) if split_w[i])
    out_pl = [part if s else p for s, p in zip(split_w, tok_pl)]

    def local(router_l, wg_l, wi_l, wo_l, xg_l, *rest):
        rest = list(rest)
        bias_l = rest.pop(0) if bias is not None else None
        live_l = rest.pop(0) if live is not None else None
        p = {"router": router_l, "wg": wg_l, "wi": wi_l, "wo": wo_l}
        out, aux = _moe_groups(p, xg_l, bias_l, top_k, cap, live_l, experts=(first, n_exp))
        return out, (aux if lead else torch.zeros_like(aux))

    return local_map(local, out_placements=(out_pl, out_pl), in_grad_placements=grads,
                     device_mesh=mesh)(*args)


def apply_moe(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              router_bias: torch.Tensor | None = None, groups: int = 1,
              fsdp_gather: bool = False, live: torch.Tensor | None = None):
    """x: (B, S, d) -> (out (B, S, d), aux loss () float32).

    router_bias: optional (B, S, E) per-token logit bias. ``groups``: the
    number of dispatch groups (tokens are batch-major; a count that does
    not divide B * S, or exceeds it, falls back to 1), each with capacity
    ``ceil(tokens per group * top_k * capacity_factor / E)``. live:
    optional (B,) or (B, S) bool; dead tokens take no capacity and cannot
    move a live token's routing, and their own rows come out zero (plus
    the shared experts' term). fsdp_gather: ``regather_expert_weights``
    first (DTensors only)."""
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
    if fsdp_gather:
        params = regather_expert_weights(params)
    moe = _moe_sharded if tp.is_dtensor(params["router"]) else _moe_groups
    out, aux = moe(params, x.reshape(groups, tg, d), bias, top_k, cap, lv)
    out = tp.settle(out.reshape(b, s, d))  # a Partial output reduce-scattered
    if "shared" in params:
        out = out + apply_mlp(params["shared"], x.reshape(t, d), "swiglu").reshape(b, s, d)
    return out, aux.mean()
