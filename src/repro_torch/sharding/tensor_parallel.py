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
  * ``whole(x, dim)`` — ``x`` gathered over the mesh dims that split
    ``dim`` (MLA's rope key before its rotation pairs dims of two ranks);
    ``match(t, ref)`` — ``t`` in ``ref``'s placements (a VLM's vision
    rows against the embedding's layout).
  * ``cat_shared(k, shared)`` — a key shared by every head (MLA's rope
    key) joined to each head's own: each rank expands it over its heads,
    and its gradient comes back ``Partial`` over them.
  * ``embedding(ids, table)`` — a lookup of a table whose rows are split
    over model ranks (Megatron's vocab-parallel embedding): each rank looks
    up the ids that fall in its rows, zeroes the others, and the output is
    ``Partial`` over those ranks. DTensor's own ``F.embedding`` takes its
    ``MaskPartial`` path instead, which fails against data-sharded ids. A
    (K, V, d) stack of codebook tables (MusicGen) sums the K lookups of
    (..., K) ids the same way.
  * ``label_logits(logits, labels, groups)`` — the reference's masked
    reduction over the vocab, per vocab shard, ``Partial`` over the ranks
    that split the vocab: the logits are never gathered. With ``groups``
    K > 1 the vocab is K codebooks of V columns each (MusicGen's flat (...,
    K V) logits) and each codebook's label picks within its own columns.
  * ``logsumexp(logits, groups)`` — over a vocab split across ranks: the
    max, then the sum of exponentials, each reduced across the ranks (two
    small all-reduces), never a gather of the logits; per codebook with
    ``groups`` > 1, each rank reducing the codebooks its columns meet.
  * ``cached_attention`` / ``cache_write`` — the serving steps on DTensor
    caches: each rank attends and writes on its own batch rows, sequence
    rows and kv heads; a sequence-split cache's softmax is combined across
    the ranks, flash-decode style (over every mesh dim that splits the
    sequence: at batch 1 the rules split it over both).
  * ``mla_cached_attention`` — MLA's absorbed decode on DTensor latent
    caches, its heads on the model ranks: a latent split over them is
    all-gathered, a sequence split over them combined flash-decode style.

The recurrent families' layers (``models/mamba2.py``, ``models/xlstm.py``)
run their cells inside ``on_ranks`` regions (``local_map`` on the plain
tensors of each rank) and move activations between layouts with:

  * ``exchange(x, dim, have, want, axis)`` — the columns of a tensor dim
    regrouped across the ranks of a mesh dim: each rank holds the global
    column ranges ``have[r]`` and ends up with ``want[r]``, in one
    all-to-all (a column held by several ranks is sent by one, the
    receiver itself when it can; its gradient sums every reader's);
  * ``swap_split(x, src, dst, axis)`` — a tensor split evenly over ``src``
    re-split over ``dst`` (one all-to-all);
  * ``all_gather`` / ``all_reduce`` on an axis (the serving steps');
  * ``unsplit(x, axis)`` — ``x`` whole over one mesh dim, and
    ``note_replicated(what)`` — a mixer run REPLICATED over the model
    ranks where its split does not divide them (Mamba2 heads, an mLSTM
    head width, MLA serving heads), told to the listeners in
    ``REPLICATED_LISTENERS`` (the dry run's ``Recorder`` counts them).

``torch.distributed.tensor`` is imported only inside a function that has
a DTensor in hand, so importing the model imports none of it.
"""
from __future__ import annotations

import functools
import sys
from typing import NamedTuple

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


def placed(x, want):
    """DTensor ``x`` in placements ``want`` (a ``redistribute`` when they
    differ)."""
    return _to(x, want)


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


def whole(x, dim: int):
    """``x`` whole over the mesh dims that split tensor dim ``dim`` (an
    explicit ``redistribute``, whose backward splits the gradient again);
    a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return _to(x, [_dt().Replicate() if is_split(p, dim % x.ndim) else p for p in x.placements])


def match(t, ref):
    """``t`` split as DTensor ``ref`` splits the leading dims they share
    (whole on a mesh dim where ``ref`` splits a dim ``t`` lacks; a plain
    ``t`` joins as replicated first): a VLM's vision rows (B, S, d) and
    mask (B, S) against the embedding's layout. With a plain ``ref``,
    ``t`` itself."""
    if not is_dtensor(ref):
        return t
    dt = _dt()
    want = [p if is_split(p) and p.dim < t.ndim else dt.Replicate() for p in ref.placements]
    return _to(as_dtensor(t, ref.device_mesh), want)


def cat_shared(k, shared):
    """``torch.cat([k, shared.expand(...)], -1)``: each of k's (B, S, H,
    dn) heads joined by the (B, S, 1, dr) key all heads share (MLA's rope
    key). On DTensors each rank expands ``shared`` (whole over the head
    split) over its own heads (``local_map``); its gradient, a sum over the
    rank's heads, comes back ``Partial`` over the ranks that split them."""
    if not is_dtensor(k):
        return torch.cat([k, shared.expand(k.shape[:-1] + shared.shape[-1:])], dim=-1)
    dt = _dt()
    mesh = k.device_mesh
    sh_pl = [p if is_split(p, 0) else dt.Replicate() for p in k.placements]
    shared = _to(as_dtensor(shared, mesh), sh_pl)
    grad_pl = [dt.Partial() if is_split(pk, 2) else p for pk, p in zip(k.placements, sh_pl)]

    def local(k_l, s_l):
        return torch.cat([k_l, s_l.expand(k_l.shape[:-1] + s_l.shape[-1:])], dim=-1)

    return _local_map(local, list(k.placements), mesh, (k.placements, grad_pl))(k, shared)


def attention(fn, q, k, v):
    """``fn(q, k, v, q_start)``, an attention over (B, S, H, hd) queries and
    (B, S, KVH, hd) keys and values in which heads and query rows are
    independent (the training forward's ``causal_attend``; ``q_start``: the
    position of the first query row it is given). On DTensors each rank
    attends with its own batch rows and its own query heads, or, where the
    heads do not divide the ranks, its own block of query positions (all
    of them where the ranks do not divide the positions either: replicated,
    ``note_replicated``) (``local_map``): keys and values split by head the same way where their
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
    # model split goes to the query positions where they divide them, else
    # every rank there attends with all of them (replicated)
    pos_dims = [i for i, p in enumerate(q.placements) if not (is_split(p, 0) or is_split(p, 2))]
    n_pos = 1
    for i in pos_dims:
        n_pos *= mesh.size(i)
    if q.shape[1] % n_pos:
        note_replicated("attention")
    pos_pl = dt.Shard(1) if q.shape[1] % n_pos == 0 else dt.Replicate()
    q_pl = [pos_pl if i in pos_dims else p for i, p in enumerate(q.placements)]
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


def _lookup(ids, table, first=None):
    """``F.embedding`` of ``ids`` into ``table``: a (V, d) table, or a (K,
    V, d) stack of codebook tables with (..., K) ids, whose K lookups are
    summed in codebook order. ``first``: the table is a block of rows from
    row ``first`` (a rank's shard), and the ids outside it give zero."""

    def one(i, t):
        if first is None:
            return F.embedding(i, t)
        rows = t.shape[0]
        local = i - first
        out = F.embedding(local.clamp(0, rows - 1), t)
        return torch.where(((local >= 0) & (local < rows))[..., None], out, 0.0)

    if table.ndim == 2:
        return one(ids, table)
    x = one(ids[..., 0], table[0])
    for k in range(1, table.shape[0]):
        x = x + one(ids[..., k], table[k])
    return x


def embedding(ids, table):
    """``F.embedding(ids, table)`` (a (K, V, d) stack of codebook tables:
    the sum of each codebook's lookup of (..., K) ids); on DTensors the
    vocab-parallel lookup (see the module docstring). On each mesh dim:
    where the table splits its rows and the ids are whole, each rank looks
    up its rows and the output is ``Partial``; where the table splits its
    last dim, so does the output; where the ids are split, the table is
    whole there (its gradient then comes back ``Partial``). Ids must lie
    in [0, rows) (the caller clamps, R001)."""
    if not is_dtensor(table):
        return _lookup(ids, table)
    dt = _dt()
    mesh = table.device_mesh
    ids = as_dtensor(ids, mesh)
    row, last = table.ndim - 2, table.ndim - 1
    out_last = ids.ndim - (table.ndim - 2)  # the output's d dim
    tpl = [pt if is_split(pt) and not is_split(pi) else dt.Replicate()
           for pi, pt in zip(ids.placements, table.placements)]
    table = _to(table, tpl)
    _, first = local_rows(table, row)
    out_pl = [dt.Partial() if is_split(pt, row) else dt.Shard(out_last) if is_split(pt, last)
              else pi for pi, pt in zip(ids.placements, tpl)]
    grad_pl = [dt.Partial() if is_split(pi) else pt for pi, pt in zip(ids.placements, tpl)]
    return _local_map(lambda i, t: _lookup(i, t, first), out_pl, mesh,
                      (ids.placements, grad_pl))(ids, table)


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


def _segments(first: int, n: int, total: int, groups: int):
    """(group, lo, hi) of the columns [first, first + n) of a vocab of
    ``total`` columns in ``groups`` equal codebooks: the local slice
    [lo, hi) of each codebook (empty where the block misses it)."""
    v = total // groups
    return [(k, min(max(k * v - first, 0), n), min(max((k + 1) * v - first, 0), n))
            for k in range(groups)]


def _pick(lg, lb, first: int, total: int, groups: int):
    """The label logits of a block of columns from ``first`` (see
    ``label_logits``)."""
    v = total // groups
    iota = torch.arange(first, first + lg.shape[-1], device=lg.device)
    if groups == 1:
        lb = lb[..., None]
    col = torch.where((lb >= 0) & (lb < v),
                      lb + v * torch.arange(groups, device=lb.device), -1)  # (..., K)
    out = torch.stack([
        torch.where(iota[lo:hi] == col[..., k, None], lg[..., lo:hi], 0.0).sum(-1)
        for k, lo, hi in _segments(first, lg.shape[-1], total, groups)], dim=-1)
    return out[..., 0] if groups == 1 else out


def label_logits(logits, labels, groups: int = 1):
    """The label's logit, ``sum_v where(v == label, logits[..., v], 0)``
    (the reference's masked reduction over the vocab): a label outside
    [0, V) matches nothing and gives 0. labels: logits' shape without its
    last dim; with ``groups`` K > 1, logits (..., K V) hold K codebooks of
    V columns and labels (..., K) one label per codebook, each matched in
    its codebook's columns. On DTensors each rank reduces its vocab shard,
    and the result is ``Partial`` over the ranks that split the vocab."""
    total = logits.shape[-1]
    if not is_dtensor(logits):
        return _pick(logits, labels, 0, total, groups)
    dt = _dt()
    logits, labels = _vocab_layout(logits, labels)
    last = logits.ndim - 1
    _, first = local_rows(logits, last)
    out_pl = [dt.Partial() if is_split(p, last) else p for p in logits.placements]
    return _local_map(lambda lg, lb: _pick(lg, lb, first, total, groups), out_pl,
                      logits.device_mesh, (logits.placements, labels.placements))(logits,
                                                                                   labels)


def logsumexp(logits, groups: int = 1):
    """``torch.logsumexp(logits, -1)`` (with ``groups`` K > 1: of each of
    the K codebooks of (..., K V) logits, (..., K) out); where a DTensor's
    vocab is split over ranks, the max and the sum of exponentials are each
    all-reduced across them (the max held constant in the backward, as its
    gradient cancels), so the result is whole over those ranks: each rank
    reduces the columns of each codebook its shard meets (a shard may
    straddle two), and a codebook it does not meet adds -inf to the max
    and 0 to the sum."""
    if not (is_dtensor(logits) and _vocab_split(logits)):
        if groups == 1:
            return torch.logsumexp(logits, dim=-1)
        return torch.logsumexp(logits.reshape(logits.shape[:-1] + (groups, -1)), dim=-1)
    import torch.distributed._functional_collectives as funcol

    dt = _dt()
    logits, _ = _vocab_layout(logits, None)
    mesh, last, total = logits.device_mesh, logits.ndim - 1, logits.shape[-1]
    _, first = local_rows(logits, last)
    pgs = [mesh.get_group(i) for i, p in enumerate(logits.placements) if is_split(p, last)]
    whole_pl = [dt.Replicate() if is_split(p, last) else p for p in logits.placements]
    part_pl = [dt.Partial() if is_split(p, last) else p for p in logits.placements]

    def seg_max(lg):
        m = torch.stack([lg[..., lo:hi].amax(-1) if hi > lo
                         else lg.new_full(lg.shape[:-1], float("-inf"))
                         for _, lo, hi in _segments(first, lg.shape[-1], total, groups)], -1)
        for pg in pgs:
            m = funcol.all_reduce(m, "max", pg)
        return m

    def seg_sum(lg, m):
        return torch.stack([(lg[..., lo:hi] - m[..., k, None]).exp().sum(-1) if hi > lo
                            else lg.new_zeros(lg.shape[:-1])
                            for k, lo, hi in _segments(first, lg.shape[-1], total, groups)], -1)

    m = _local_map(seg_max, whole_pl, mesh, (logits.placements,))(logits.detach())
    s = _local_map(seg_sum, part_pl, mesh, (logits.placements, whole_pl))(logits, m)
    out = reduced(s).log() + m
    return out[..., 0] if groups == 1 else out


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


def mla_cached_attention(parts, q_nope, q_rope, w_uk, w_uv, c_cache, r_cache, pos):
    """MLA's absorbed-matrix serving attention (``models.attention.
    mla_decode``) on DTensor caches in the cache rules' layout: c_cache (B,
    S, r) and r_cache (B, S, dr), queries q_nope (B, C, H, dn) and q_rope
    (B, C, H, dr) (roped), W_uk (r, H dn) and W_uv (r, H dv) with their
    heads on the model ranks. ``parts``: the plain pieces
    (``models.attention.MLAParts``). Each rank computes its own heads for
    its batch rows. On each mesh dim the cache splits:

      * its latent (the rules' default ``"lora"`` mode): the rank's latent
        and rope-key columns are all-gathered there before the scores (the
        whole latent of its batch rows, one layer at a time; why not
        all-reduce partial scores instead: ROADMAP §3);
      * its sequence (``mla_cache_seq_shard``): each rank scores its block
        of keys for every head (the absorbed queries all-gathered over the
        head split, a (B, C, H, r) tensor) and the softmax and the context
        are combined across the ranks, flash-decode style; the rank then
        keeps its own heads' context;
      * nothing (``mla_replicate_cache``): no collective.

    Where the ranks that split the weights' heads do not divide H, or split
    the cache's batch as well, the attention runs REPLICATED over them:
    W_uk and W_uv are gathered whole there and each rank computes every
    head of its batch rows (``note_replicated``).

    Returns the (B, C, H, dv) float32 output, heads split as the weights'
    (whole where replicated)."""
    import torch.distributed._functional_collectives as funcol

    dt = _dt()
    mesh = c_cache.device_mesh
    pl = c_cache.placements
    b, h = q_nope.shape[0], q_nope.shape[2]
    heads = [i for i, p in enumerate(w_uk.placements) if is_split(p, 1)]
    n = 1
    for i in heads:
        n *= mesh.size(i)
    if h % n or any(is_split(pl[i], 0) for i in heads):
        # heads the ranks do not divide, or ranks that split the cache's
        # batch too: W_uk / W_uv whole over them, every head on every rank
        note_replicated("mla")
        heads = []
    q_pl = [dt.Shard(2) if i in heads else dt.Shard(0) if is_split(p, 0) else dt.Replicate()
            for i, p in enumerate(pl)]
    row_pl = [dt.Shard(0) if is_split(p, 0) else dt.Replicate() for p in pl]
    w_pl = [dt.Shard(1) if i in heads else dt.Replicate() for i in range(mesh.ndim)]
    q_nope, q_rope = _to(q_nope, q_pl), _to(q_rope, q_pl)
    w_uk, w_uv = _to(w_uk, w_pl), _to(w_uv, w_pl)
    pos = _to(as_dtensor(pos.expand(b) if pos.ndim == 0 else pos, mesh), row_pl)
    latent = [mesh.get_group(i) for i, p in enumerate(pl) if is_split(p, 2)]
    seq = [mesh.get_group(i) for i, p in enumerate(pl) if is_split(p, 1)]
    gather_heads = [mesh.get_group(i) for i in heads if is_split(pl[i], 1)]
    _, s_first = local_rows(c_cache, 1)
    h_loc, h_first = local_rows(q_nope, 2)

    def local(qn, qr, wuk, wuv, cc, rc, p):
        for grp in reversed(latent):  # minor mesh dim first: data-major blocks
            cc = funcol.all_gather_tensor(cc, 2, grp)
            rc = funcol.all_gather_tensor(rc, 2, grp)
        q_c = parts.absorb(qn, wuk)  # (b, c, h_l, r) float32
        qr = qr.float()
        for grp in gather_heads:
            q_c = funcol.all_gather_tensor(q_c, 2, grp)
            qr = funcol.all_gather_tensor(qr, 2, grp)
        scores = parts.scores(q_c, qr, cc, rc, p, s_first)  # (b, H, c, s)
        if not seq:
            ctx = parts.context(torch.softmax(scores, dim=-1), cc)
        else:
            m = scores.amax(dim=-1, keepdim=True)
            for grp in seq:
                m = funcol.all_reduce(m, "max", grp)
            e = torch.exp(scores - m)
            norm = e.sum(dim=-1, keepdim=True)
            ctx = parts.context(e, cc)
            for grp in seq:
                norm = funcol.all_reduce(norm, "sum", grp)
                ctx = funcol.all_reduce(ctx, "sum", grp)
            ctx = ctx / norm.permute(0, 2, 1, 3)
        if gather_heads:
            ctx = ctx[:, :, h_first:h_first + h_loc]
        return parts.values(ctx, wuv)

    return _local_map(local, q_pl, mesh, (q_pl, q_pl, w_pl, w_pl, pl, r_cache.placements,
                                          row_pl))(q_nope, q_rope, w_uk, w_uv, c_cache,
                                                   r_cache, pos)


# ------------------------------------------------- the recurrent families' pieces
class Axis(NamedTuple):
    """One mesh dim seen from this rank."""

    dim: int  # its index in the mesh
    size: int
    rank: int  # this rank's coordinate on it
    group: object  # its process group


def model_axis(mesh) -> Axis:
    """The "model" dim of ``mesh``."""
    d = tuple(mesh.mesh_dim_names).index("model")
    return Axis(d, mesh.size(d), mesh.get_local_rank(d), mesh.get_group(d))


def shard_ranges(size: int, n: int) -> tuple:
    """The (lo, hi) rows of each of ``n`` ranks that ``Shard`` gives a dim
    of ``size`` (``torch.chunk``'s split: ceil(size / n) a rank, the last
    ones short or empty)."""
    c = -(-size // n)
    return tuple((min(i * c, size), min((i + 1) * c, size)) for i in range(n))


def held(t, dim: int, ax: Axis) -> tuple:
    """Per rank of ``ax``, the global ranges of tensor dim ``dim`` that
    DTensor ``t``'s local tensor holds there: its ``Shard`` split, or the
    whole dim on each rank."""
    size = t.shape[dim]
    if is_split(t.placements[ax.dim], dim % t.ndim):
        return tuple(((lo, hi),) for lo, hi in shard_ranges(size, ax.size))
    return (((0, size),),) * ax.size


def rows_like(ref) -> list:
    """Placements of a (B, ...) tensor split as DTensor ``ref`` splits its
    batch dim, whole elsewhere."""
    dt = _dt()
    return [dt.Shard(0) if is_split(p, 0) else dt.Replicate() for p in ref.placements]


def columns_like(ref, ax: Axis) -> list:
    """Placements of a (B, T, n) tensor split as DTensor ``ref`` splits its
    batch dim, and over n on the mesh dim of ``ax``."""
    out = rows_like(ref)
    out[ax.dim] = _dt().Shard(2)
    return out


def as_rows(x, ref):
    """A plain or DTensor (B, ...) mask or id vector as a DTensor split as
    ``ref`` splits its batch (``rows_like``)."""
    return _to(as_dtensor(x, ref.device_mesh), rows_like(ref))


def weight_grad(w, varying) -> list:
    """The gradient placements of weight DTensor ``w`` read inside a
    ``local_map`` region: its own split where it is split; ``Partial`` on
    the mesh dims in ``varying`` (those over which the ranks compute
    different things with it: another batch shard, other heads);
    ``Replicate`` where every rank computes the same."""
    dt = _dt()
    return [p if is_split(p) else dt.Partial() if i in varying else dt.Replicate()
            for i, p in enumerate(w.placements)]


def batch_dims(t) -> set:
    """The mesh dims over which DTensor ``t``'s batch dim is split."""
    return {i for i, p in enumerate(t.placements) if is_split(p, 0)}


def on_ranks(fn, args, outs, grad_placements):
    """``fn`` on each rank's local tensors of the DTensors ``args``
    (``local_map``; ``grad_placements``: each input's gradient's), its
    outputs (a tuple of tensors) DTensors in ``outs`` (one placements
    sequence each). Returns the tuple of them."""
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    out = _local_map(fn, tuple(tuple(o) for o in outs), mesh, grad_placements)(*args)
    return tuple(out)


def _wait(t):
    import torch.distributed._functional_collectives as funcol

    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_to_all(x, out_splits, in_splits, group):
    import torch.distributed._functional_collectives as funcol

    return _wait(funcol.all_to_all_single(x.contiguous(), list(out_splits), list(in_splits),
                                          group))


class _AllToAll(torch.autograd.Function):
    """An all-to-all over dim 0 (``in_splits`` rows to each rank,
    ``out_splits`` from each); its backward is the reverse one."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.args = (in_splits, out_splits, group)
        return _all_to_all(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


@functools.lru_cache(maxsize=256)
def _exchange_plan(have: tuple, want: tuple) -> dict:
    """(source rank, destination rank) -> the (global lo, hi, offset in the
    destination's output) pieces the destination takes from the source,
    in output order. Each wanted column comes from the destination
    itself when it holds it, else from the lowest rank that does."""
    m = len(have)
    pieces: dict = {}
    for j in range(m):
        got, off = [], 0
        for lo, hi in want[j]:
            todo = [(lo, hi)]
            for i in [j] + [i for i in range(m) if i != j]:
                for a, b in have[i]:
                    rest = []
                    for u, v in todo:
                        s, e = max(a, u), min(b, v)
                        if s >= e:
                            rest.append((u, v))
                            continue
                        got.append((off + s - lo, i, s, e))
                        rest += [r for r in ((u, s), (e, v)) if r[0] < r[1]]
                    todo = rest
            if todo:
                raise ValueError(f"exchange: no rank holds columns {todo}")
            off += hi - lo
        for o, i, s, e in sorted(got):
            pieces.setdefault((i, j), []).append((s, e, o))
    return pieces


def _local_at(ranges, col: int) -> int:
    """The local index of global column ``col`` in a tensor holding the
    global ``ranges`` one after another."""
    off = 0
    for a, b in ranges:
        if a <= col < b:
            return off + col - a
        off += b - a
    raise ValueError(f"column {col} not in {ranges}")


def exchange(x, dim: int, have: tuple, want: tuple, ax: Axis):
    """Plain tensor ``x`` (this rank's columns ``have[ax.rank]`` of a tensor
    dim, one range after another) regrouped across the ranks of ``ax`` so
    that each rank r holds ``want[r]``, in one all-to-all (see the module
    docstring). Differentiable: the gradient of a column several ranks
    read sums theirs."""
    dim %= x.ndim
    pieces = _exchange_plan(tuple(map(tuple, have)), tuple(map(tuple, want)))
    me, m = ax.rank, ax.size
    send = [x.narrow(dim, _local_at(have[me], s), e - s)
            for j in range(m) for s, e, _ in pieces.get((me, j), ())]
    in_splits = [sum(e - s for s, e, _ in pieces.get((me, j), ())) for j in range(m)]
    out_splits = [sum(e - s for s, e, _ in pieces.get((i, me), ())) for i in range(m)]
    buf = torch.cat(send or [x.narrow(dim, 0, 0)], dim).movedim(dim, 0)
    recv = _AllToAll.apply(buf, out_splits, in_splits, ax.group).movedim(0, dim)
    parts, at = [], 0
    for i in range(m):
        for s, e, o in pieces.get((i, me), ()):
            parts.append((o, at, e - s))
            at += e - s
    return torch.cat([recv.narrow(dim, p, n) for _, p, n in sorted(parts)], dim)


def swap_split(x, src: int, dst: int, ax: Axis):
    """Plain tensor ``x``, this rank's block of a dim ``src`` split evenly
    over ``ax``, as its block of dim ``dst`` split evenly instead, dim
    ``src`` whole (one all-to-all; differentiable)."""
    m = ax.size
    buf = torch.stack(x.tensor_split(m, dim=dst), 0)
    recv = _AllToAll.apply(buf, [1] * m, [1] * m, ax.group)
    return torch.cat(recv.unbind(0), dim=src)


def all_gather(x, dim: int, ax: Axis):
    """The blocks of plain tensor ``x`` on the ranks of ``ax``, joined along
    ``dim`` in rank order (serving: no gradient)."""
    import torch.distributed._functional_collectives as funcol

    return _wait(funcol.all_gather_tensor(x.contiguous(), dim % x.ndim, ax.group))


def unsplit(x, ax: Axis):
    """DTensor ``x`` whole over the mesh dim of ``ax`` (an explicit
    ``redistribute``: an all-gather of whichever tensor dim it splits
    there; its backward splits the gradient again), its other placements
    kept."""
    dt = _dt()
    want = list(x.placements)
    want[ax.dim] = dt.Replicate()
    return _to(x, want)


REPLICATED_LISTENERS: list = []  # callables taking the name of a replicated layout


def note_replicated(what: str) -> None:
    """Tell every listener (``REPLICATED_LISTENERS``) that ``what`` runs
    replicated over the model ranks in this call: a layout the caller
    chose because its split does not divide them, stated in its docstring,
    never a fallback from an error."""
    for listen in REPLICATED_LISTENERS:
        listen(what)


def all_reduce(x, ax: Axis):
    """The sum of plain tensor ``x`` over the ranks of ``ax`` (serving: no
    gradient)."""
    import torch.distributed._functional_collectives as funcol

    return _wait(funcol.all_reduce(x, "sum", ax.group))
