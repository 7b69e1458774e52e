"""Tensor-parallel pieces of the model's forward on DTensors: the port of
the reference's in-forward sharding constraints and of what GSPMD lowers
its vocab-sharded ops to.

Every function here takes plain tensors too, and then does exactly what
the unsharded model does (or nothing, for ``constrain`` and
``tp_input``): the model calls them on every path, and only the sharded
train step (``repro_torch.sharding.dtensor.sharded_step``) and the dry run
(``repro_torch.launch.dryrun``) hand it DTensors.

  * ``constrain(x, spec)`` — ``jax.lax.with_sharding_constraint``: a
    ``redistribute`` of ``x`` to the placements of ``Spec(*spec)``.
  * ``tp_input(x, w)`` — the activation of a product ``x @ w`` arranged
    for the weight's placements, Megatron's schedule: whole over the
    contraction dim where ``w`` splits its output dim (column-parallel: an
    all-gather of the activation, never of the weight), split where ``w``
    splits its contraction dim (row-parallel: a local slice; the product
    then comes out ``Partial`` and the next ``constrain`` reduce-scatters
    it).
  * ``split_ready(x, dim, lead)`` — a reshape of a split dim into heads
    made possible: the dim whole where the heads do not divide the ranks.
  * ``attention(fn, q, k, v)`` — the training attention head-parallel.
  * ``mean_last(x)`` — a norm's statistics over a split feature dim;
    ``reduced(t)`` — a tensor's partial sums reduced (the loss terms);
    ``settle(y)`` — a row-parallel product's partial sums reduce-scattered;
    ``contiguous_grad(x)`` — a product's gradient made contiguous.
  * ``embedding(ids, table)`` — a lookup of a table whose rows are split
    over model ranks (Megatron's vocab-parallel embedding): each rank looks
    up the ids that fall in its rows, zeroes the others, and the output is
    ``Partial`` over those ranks. DTensor's own ``F.embedding`` takes its
    ``MaskPartial`` path instead, which fails against data-sharded ids.
  * ``label_logits(logits, labels)`` — the reference's masked reduction
    over the vocab, per vocab shard, ``Partial`` over the ranks that split
    the vocab: the logits are never gathered.
  * ``logsumexp(logits)`` — over a vocab split across ranks: the max, then
    the sum of exponentials, each reduced across the ranks (two small
    all-reduces), never a gather of the logits.
  * ``cached_attention`` / ``cache_write`` — the serving steps on DTensor
    caches (the dry run): each rank attends and writes on its own batch
    rows, sequence rows and kv heads; a sequence-split cache's softmax is
    combined across the ranks, flash-decode style.

``torch.distributed.tensor`` is imported only inside a function that has
a DTensor in hand, so importing the model imports none of it.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import Spec, placements


def is_dtensor(x) -> bool:
    """``isinstance(x, DTensor)`` without importing DTensor: nothing can be
    one before ``torch.distributed.tensor`` is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _dt():
    import torch.distributed.tensor as dt

    return dt


def _local_map(fn, out_placements, mesh, in_grad_placements=None):
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh)


def as_dtensor(x, mesh):
    """A plain tensor the forward made for itself (positions, masks) as a
    replicated DTensor on ``mesh``."""
    if is_dtensor(x):
        return x
    dt = _dt()
    return dt.DTensor.from_local(x, mesh, [dt.Replicate()] * mesh.ndim, run_check=False)


def _to(x, want):
    want = tuple(want)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def is_split(p, dim=None) -> bool:
    """Whether placement ``p`` shards (tensor dim ``dim``, or any)."""
    return isinstance(p, _dt().Shard) and (dim is None or p.dim == dim)


def constrain(x, spec):
    """``x`` in the placements of ``Spec(*spec)`` on its mesh (a
    ``redistribute``), when ``x`` is a DTensor and ``spec`` is not None;
    otherwise ``x`` itself."""
    if spec is None or not is_dtensor(x):
        return x
    return _to(x, placements(Spec(*spec), x.device_mesh))


def reduced(t):
    """A DTensor with its ``Partial`` entries reduced (an all-reduce), its
    shards kept, as an explicit ``redistribute`` (the loss terms: DTensor's
    backward cannot carry a gradient into a ``Partial(avg)``); a plain
    tensor as it is."""
    if not is_dtensor(t):
        return t
    return _to(t, [_dt().Replicate() if isinstance(p, _dt().Partial) else p
                   for p in t.placements])


def mean_last(x):
    """``x.mean(-1, keepdim=True)``. On a DTensor whose last dim is split
    over ranks (a norm over a model-sharded residual stream): the sum,
    reduced across them, over the dim's length. DTensor's own ``mean``
    leaves a ``Partial(avg)`` that its propagation spreads into the
    norm's output, and its backward cannot turn the gradient's
    ``Partial(sum)`` into one."""
    last = x.ndim - 1
    if not is_dtensor(x) or not any(is_split(p, last) and x.device_mesh.size(i) > 1
                                    for i, p in enumerate(x.placements)):
        return x.mean(dim=-1, keepdim=True)
    return reduced(x.sum(dim=-1, keepdim=True)) / x.shape[-1]


def settle(y):
    """A product's DTensor output with its ``Partial`` entries (a
    row-parallel product) reduce-scattered over its last dim, as an
    explicit ``redistribute`` whose backward all-gathers the gradient:
    left to an op's implicit redistribution, the gradient keeps the split
    and the weight's gradient product then gathers a whole activation."""
    if not is_dtensor(y) or not any(isinstance(p, _dt().Partial) for p in y.placements):
        return y
    return _to(y, [_dt().Shard(y.ndim - 1) if isinstance(p, _dt().Partial) else p
                   for p in y.placements])


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient's local tensor
    contiguous: a DTensor's redistributions can leave a gradient's local
    tensor strided (a reduce-scatter over its last dim), and a DTensor
    ``view`` in the backward of a product then fails on it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        loc = g.to_local()
        if loc.is_contiguous():
            return g
        return _dt().DTensor.from_local(loc.contiguous(), g.device_mesh, g.placements,
                                        shape=g.shape, stride=g.stride(), run_check=False)


def contiguous_grad(x):
    """``x``; on a DTensor, its gradient arrives with a contiguous local
    tensor (``_ContiguousGrad``)."""
    return _ContiguousGrad.apply(x) if is_dtensor(x) and x.requires_grad else x


def tp_input(x, w):
    """``x`` arranged for ``x @ w`` (``w`` (K, N), or a batch of them): on
    each mesh dim where ``w`` splits N, ``x`` whole there (column-parallel:
    the activation gathered, never the weight); where ``w`` splits K,
    ``x`` split over its last dim the same way (row-parallel); elsewhere as
    it is. Plain ``w`` or ``x``: ``x``."""
    if not (is_dtensor(w) and is_dtensor(x)):
        return x
    dt = _dt()
    k_dim, last = w.ndim - 2, x.ndim - 1
    want = [px if isinstance(pw, dt.Replicate) else
            dt.Shard(last) if is_split(pw, k_dim) else dt.Replicate()
            for pw, px in zip(w.placements, x.placements)]
    return _to(x, want)


def split_ready(x, dim: int, lead: int):
    """``x`` ready for its dim ``dim`` to be split into (``lead``, ...) (a
    reshape into heads, or heads into (kv heads, group)): on DTensors, made
    whole over the mesh dims that shard it unless ``lead`` divides evenly
    over them (DTensor cannot unflatten an uneven shard). Plain: ``x``."""
    if not is_dtensor(x):
        return x
    dims = [i for i, p in enumerate(x.placements) if is_split(p, dim % x.ndim)]
    n = 1
    for i in dims:
        n *= x.device_mesh.size(i)
    if lead % n == 0:
        return x
    return _to(x, [_dt().Replicate() if i in dims else p for i, p in enumerate(x.placements)])


def attention(fn, q, k, v):
    """``fn(q, k, v, q_start)``, an attention over (B, S, H, hd) queries and
    (B, S, KVH, hd) keys and values in which heads and query rows are
    independent (the training forward's ``causal_attend``; ``q_start``: the
    position of the first query row it is given). On DTensors each rank
    attends with its own batch rows and its own query heads, or, where the
    heads do not divide the ranks, its own block of query positions
    (``local_map``): keys and values split by head the same way where their
    heads divide the ranks, else whole there, each rank then taking the kv
    head of each of its query heads (their gradients come back
    ``Partial``). DTensor's own propagation of the products and the softmax
    picks other splits in the backward and gathers whole score tensors."""
    if not is_dtensor(q):
        return fn(q, k, v, 0)
    dt = _dt()
    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    # heads split where the model split of H*hd left them; the rest of the
    # model split goes to the query positions
    q_pl = [p if is_split(p, 0) or is_split(p, 2) else dt.Shard(1) for p in q.placements]
    q = _to(q, q_pl)
    head_dims = [i for i, p in enumerate(q_pl) if is_split(p, 2)]
    n = 1
    for i in head_dims:
        n *= mesh.size(i)
    split_kv = kvh % n == 0
    kv_pl = [p if is_split(p, 0) or (split_kv and is_split(p, 2)) else dt.Replicate()
             for p in q_pl]
    k, v = _to(as_dtensor(k, mesh), kv_pl), _to(as_dtensor(v, mesh), kv_pl)
    kv_grad = [dt.Partial() if (is_split(pq, 2) or is_split(pq, 1)) and not is_split(pk) else pk
               for pq, pk in zip(q_pl, kv_pl)]
    _, h0 = local_rows(q, 2)
    _, s0 = local_rows(q, 1)

    def local(q_l, k_l, v_l):
        if k_l.shape[2] * g != q_l.shape[2]:  # kv whole here: each query head's kv head
            idx = torch.div(torch.arange(h0, h0 + q_l.shape[2], device=q_l.device), g,
                            rounding_mode="floor")
            k_l, v_l = k_l.index_select(2, idx), v_l.index_select(2, idx)
        return fn(q_l, k_l, v_l, s0)

    return _local_map(local, list(q_pl), mesh, (q_pl, kv_grad, kv_grad))(q, k, v)


def local_rows(t, dim: int = 0) -> tuple[int, int]:
    """(rows on this rank, global index of its first row) of tensor dim
    ``dim`` of DTensor ``t``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                          t.placements)
    return shape[dim], offset[dim]


def embedding(ids, table):
    """``F.embedding(ids, table)``; on DTensors the vocab-parallel lookup
    (see the module docstring). On each mesh dim: where the table splits
    its rows and the ids are whole, each rank looks up its rows and the
    output is ``Partial``; where the table splits its second dim, so does
    the output; where the ids are split, the table is whole there (its
    gradient then comes back ``Partial``). Ids must lie in [0, rows) (the
    caller clamps, R001)."""
    if not is_dtensor(table):
        return F.embedding(ids, table)
    dt = _dt()
    mesh = table.device_mesh
    ids = as_dtensor(ids, mesh)
    tpl = [pt if is_split(pt) and not is_split(pi) else dt.Replicate()
           for pi, pt in zip(ids.placements, table.placements)]
    table = _to(table, tpl)
    rows, first = local_rows(table)
    out_pl = [dt.Partial() if is_split(pt, 0) else dt.Shard(ids.ndim) if is_split(pt) else pi
              for pi, pt in zip(ids.placements, tpl)]
    grad_pl = [dt.Partial() if is_split(pi) else pt for pi, pt in zip(ids.placements, tpl)]

    def lookup(ids_l, table_l):
        local = ids_l - first
        mine = (local >= 0) & (local < rows)
        out = F.embedding(local.clamp(0, rows - 1), table_l)
        return torch.where(mine[..., None], out, 0.0)

    return _local_map(lookup, out_pl, mesh, (ids.placements, grad_pl))(ids, table)


def _vocab_layout(logits, labels):
    """Logits without ``Partial`` entries, and labels split as the logits'
    leading dims are and whole where the logits split the vocab."""
    dt = _dt()
    mesh, last = logits.device_mesh, logits.ndim - 1
    logits = reduced(logits)
    if labels is not None:
        labels = _to(as_dtensor(labels, mesh),
                     [p if is_split(p) and p.dim < last else dt.Replicate()
                      for p in logits.placements])
    return logits, labels


def _vocab_split(logits) -> bool:
    last = logits.ndim - 1
    return any(is_split(p, last) and logits.device_mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def label_logits(logits, labels):
    """The label's logit, ``sum_v where(v == label, logits[..., v], 0)``
    (the reference's masked reduction over the vocab): a label outside
    [0, V) matches nothing and gives 0. labels: logits' shape without its
    last dim. On DTensors each rank reduces its vocab shard, and the result
    is ``Partial`` over the ranks that split the vocab."""

    def pick(lg, lb, first=0):
        iota = torch.arange(first, first + lg.shape[-1], device=lg.device)
        return torch.where(iota == lb[..., None], lg, 0.0).sum(-1)

    if not is_dtensor(logits):
        return pick(logits, labels)
    dt = _dt()
    logits, labels = _vocab_layout(logits, labels)
    last = logits.ndim - 1
    _, first = local_rows(logits, last)
    out_pl = [dt.Partial() if is_split(p, last) else p for p in logits.placements]
    return _local_map(lambda lg, lb: pick(lg, lb, first), out_pl, logits.device_mesh,
                      (logits.placements, labels.placements))(logits, labels)


def logsumexp(logits):
    """``torch.logsumexp(logits, -1)``; where a DTensor's vocab is split
    over ranks, the max and the sum of exponentials are each all-reduced
    across them (the max held constant in the backward, as its gradient
    cancels), so the result is whole over those ranks."""
    if not (is_dtensor(logits) and _vocab_split(logits)):
        return torch.logsumexp(logits, dim=-1)
    logits, _ = _vocab_layout(logits, None)
    m = reduced(logits.detach().amax(dim=-1, keepdim=True))
    return reduced((logits - m).exp().sum(dim=-1)).log() + m[..., 0]


def cached_attention(q, k_cache, v_cache, pos, scores_fn, sliding_window=None):
    """Serving attention of a (B, C, H, hd) chunk against DTensor caches
    (B, S, KVH, hd) in the cache rules' layout (``rules.cache_specs``):
    each rank attends with its batch rows and kv heads where the cache
    splits them (the queries split the same way); where the cache splits
    its sequence (kv heads that do not divide the ranks), each rank scores
    its block of keys (``scores_fn(q, k, pos, sliding_window, kv_start)``:
    ``models.attention.masked_scores``) and the softmax is combined across
    the ranks, flash-decode style: the max, the sum of exponentials and the
    unnormalized output each all-reduced, then divided. The probabilities
    meet the values unnormalized, so the rounding is not the plain
    ``decode_attend``'s; only the dry run serves on DTensors."""
    import torch.distributed._functional_collectives as funcol

    dt = _dt()
    mesh = k_cache.device_mesh
    b = q.shape[0]
    pl = k_cache.placements
    q_pl = [dt.Shard(0) if is_split(p, 0) else dt.Shard(2) if is_split(p, 2) else dt.Replicate()
            for p in pl]
    row_pl = [dt.Shard(0) if is_split(p, 0) else dt.Replicate() for p in pl]
    q = _to(as_dtensor(q, mesh), q_pl)
    pos = _to(as_dtensor(pos.expand(b) if pos.ndim == 0 else pos, mesh), row_pl)
    groups = [mesh.get_group(i) for i, p in enumerate(pl) if is_split(p, 1)]
    _, s_first = local_rows(k_cache, 1)

    def local(q_l, k_l, v_l, pos_l):
        scores = scores_fn(q_l, k_l, pos_l, sliding_window, s_first)  # (b, kvh, g, c, s)
        if not groups:
            p, norm = torch.softmax(scores, dim=-1), None
        else:
            m = scores.amax(dim=-1, keepdim=True)
            for grp in groups:
                m = funcol.all_reduce(m, "max", grp)
            p = torch.exp(scores - m)
            norm = p.sum(dim=-1, keepdim=True)
            for grp in groups:
                norm = funcol.all_reduce(norm, "sum", grp)
        # analysis: ignore[R005] -- the plain decode_attend contracts at this dtype too
        out = torch.einsum("bkgqs,bskd->bqkgd", p.to(q_l.dtype), v_l).float()
        if norm is not None:
            for grp in groups:
                out = funcol.all_reduce(out, "sum", grp)
            out = out / norm.permute(0, 3, 1, 2, 4)
        return out.to(q_l.dtype).reshape(q_l.shape[:3] + v_l.shape[-1:])

    return _local_map(local, list(q_pl), mesh, (q_pl, pl, pl, row_pl))(q, k_cache, v_cache,
                                                                         pos)


def cache_write(write, cache, new, pos, valid):
    """``write(cache, new, pos, valid)`` (``TransformerLM._cache_write_slab``:
    a (B, C) slab at per-slot positions, in place) on a DTensor cache (B,
    S, ...): each rank writes its own batch rows, sequence rows and
    trailing-dim shards with its slots' positions shifted by its first
    sequence row; ``new`` is brought to the cache's layout, and ``pos`` /
    ``valid`` to its batch split. Returns the cache."""
    dt = _dt()
    mesh = cache.device_mesh
    _, s_first = local_rows(cache, 1)
    new_pl = [dt.Replicate() if is_split(p, 1) else p for p in cache.placements]
    row_pl = [p if is_split(p, 0) else dt.Replicate() for p in cache.placements]
    new = _to(as_dtensor(new, mesh), new_pl)
    pos = _to(as_dtensor(pos, mesh), row_pl)
    valid = _to(as_dtensor(valid, mesh), row_pl)
    _local_map(lambda c, n, p, v: write(c, n, p - s_first, v), list(cache.placements),
               mesh)(cache, new, pos, valid)
    return cache
