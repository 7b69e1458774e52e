"""Mamba2 (SSD, state-space duality) layer: the counterpart of
``repro.models.mamba2``, in plain torch as the reference is plain ``jnp``.

A full sequence (training, serving prefill) runs the chunked SSD: quadratic
attention-like work inside chunks plus a loop that carries the chunk states,
O(S c) instead of O(S^2). Decode is the O(1) recurrence.

Per-layer state: the conv window (B, CONV_K - 1, conv_dim) in the model's
dtype and the SSM state (B, n_heads, head_dim, d_state) in float32. The SSD
arithmetic runs in float32 whatever the model's dtype, as the reference
casts. Simplifications of the reference kept as they are: one B/C group, no
bias terms, the norm before the gate. One deliberate divergence: the
chunked SSD masks its decay matrix before the ``exp`` (the reference after
it), so the forward is the same and the backward stays finite where the
reference's overflows to ``0 * inf`` (a full-width chunk of 128 tokens at a
typical dt already does; ``tests/test_torch_hybrid_train.py``).

``mamba2_full`` and the projections are functional. ``mamba2_step`` writes
the new state INTO the given state tensors (``layers.freeze_dead_slots``),
since the serving steps are captured as CUDA graphs over the cache storage.

On DTensors (the tensor-parallel steps of ``repro_torch.sharding``) both
run the same SSD over each model rank's heads (``_on_heads``), or replicated
over the model ranks where they do not divide the heads.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init, freeze_dead_slots, matmul, rms_norm, silu
from repro_torch.sharding import tensor_parallel as tp

CONV_K = 4  # depthwise causal conv kernel width


def dims(d_model: int, d_state: int, head_dim: int = 64, expand: int = 2):
    """(d_inner, n_heads, conv_dim): the conv runs over [x, B, C]."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    return d_inner, n_heads, conv_dim


def init_mamba2(d_model: int, d_state: int, head_dim: int, dtype, generator) -> dict:
    """The reference's parameters and laws; ``a_log``, ``dt_bias`` and
    ``d_skip`` stay float32 at any dtype."""
    d_inner, n_heads, conv_dim = dims(d_model, d_state, head_dim)
    dev = generator.device

    def f32(fill):
        return torch.full((n_heads,), fill, dtype=torch.float32, device=dev)

    return {
        # in_proj -> [z (d_inner), x (d_inner), B (ds), C (ds), dt (nh)]
        "w_in": dense_init((d_model, 2 * d_inner + 2 * d_state + n_heads), generator,
                           dtype=dtype),
        "conv_w": dense_init((CONV_K, conv_dim), generator, dtype=dtype),
        "a_log": f32(0.0),  # A = -exp(a_log) = -1
        "dt_bias": f32(0.0),
        "d_skip": f32(1.0),
        "norm_gain": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_out": dense_init((d_inner, d_model), generator, dtype=dtype),
    }


def _split_proj(proj, d_state, head_dim):
    """[z, x, B, C, dt] of a projection over n heads (its width is 2 n hd
    + 2 ds + n): z (.., n hd), [x, B, C] (.., n hd + 2 ds), dt (.., n),
    the width of x and n."""
    nh = (proj.shape[-1] - 2 * d_state) // (2 * head_dim + 1)
    d_inner = nh * head_dim
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner : 2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state :]
    return z, xbc, dt, d_inner, nh


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor, prefix: torch.Tensor):
    """Depthwise causal conv over time, then SiLU. xbc: (B, S, C); prefix:
    the (B, K-1, C) window carried in from earlier tokens."""
    pad = torch.cat([prefix, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(pad[:, k : k + s, :] * conv_w[k][None, None, :] for k in range(CONV_K))
    return silu(out)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0), without
    ``F.softplus``'s linear cut-off above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd(proj, conv_w, vecs, state, *, d_state: int, head_dim: int, chunk: int, dtype,
         valid=None):
    """The chunked SSD of ``mamba2_full`` between its two products, on the
    heads ``proj`` holds (its layout: ``_split_proj``): conv_w (K, [x, B,
    C] of those heads), vecs = (a_log, dt_bias, d_skip) of those heads,
    state their (conv_tail, ssm) or None. Returns (y * silu(z) in
    ``dtype``, (conv_tail, ssm))."""
    a_log, dt_bias, d_skip = vecs
    bsz, s = proj.shape[:2]
    z, xbc, dt, d_inner, nh = _split_proj(proj, d_state, head_dim)
    if state is None:
        conv_prefix = torch.zeros((bsz, CONV_K - 1, xbc.shape[-1]), dtype=xbc.dtype,
                                  device=proj.device)
    else:
        conv_prefix = state[0].to(xbc.dtype)
    # raw (pre-conv) window, indexed by tokens consumed: after n valid tokens
    # the carried-out tail is window[n : n + K-1]
    window = torch.cat([conv_prefix, xbc], dim=1)  # (B, K-1+S, conv)
    if valid is None:
        conv_tail = window[:, s : s + CONV_K - 1, :]
    else:
        n_valid = valid.sum(dim=1)  # (B,) in [0, S]: idx <= S + K - 2 is in bounds
        idx = n_valid[:, None] + torch.arange(CONV_K - 1, device=proj.device)[None, :]
        conv_tail = torch.gather(window, 1, idx[:, :, None].expand(-1, -1, window.shape[-1]))
    xbc = _causal_conv(xbc, conv_w, conv_prefix)
    xs = xbc[..., :d_inner].reshape(bsz, s, nh, head_dim)
    b_in = xbc[..., d_inner : d_inner + d_state]  # (B, S, ds)
    c_in = xbc[..., d_inner + d_state :]  # (B, S, ds)

    dt = _softplus(dt.float() + dt_bias)  # (B, S, nh)
    if valid is not None:
        # dt == 0 makes a token a no-op on the recurrence: zero decay and
        # zero input contribution
        dt = torch.where(valid[:, :, None], dt, 0.0)
    a = -torch.exp(a_log)  # (nh,)
    da = dt * a[None, None, :]  # log-decay per step, (B, S, nh)

    if s % chunk != 0:
        chunk = s
    nc = s // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=proj.device))

    def r(t):  # (B, S, ...) -> (nc, B, c, ...)
        return t.float().reshape((bsz, nc, chunk) + t.shape[2:]).transpose(0, 1)

    xs_c, b_c, c_c, dt_c, da_c = map(r, (xs, b_in, c_in, dt, da))
    s_prev = (torch.zeros((bsz, nh, head_dim, d_state), dtype=torch.float32,
                          device=proj.device)
              if state is None else state[1].float())
    ys = []
    for i in range(nc):
        xs_i, b_i, c_i, dt_i, da_i = xs_c[i], b_c[i], c_c[i], dt_c[i], da_c[i]
        cum = torch.cumsum(da_i, dim=1)  # (B, c, nh)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s', nh)
        # masked before the exp: above the diagonal diff > 0, and a chunk of
        # 128 steps of dt ~ 0.7 overflows exp there; the reference's
        # where(tri, exp(diff), 0) gives the same values but 0 * inf = NaN in
        # the backward (a deliberate divergence: its gradient where finite)
        l_mat = torch.exp(torch.where(tri[None, :, :, None], diff, -torch.inf))
        # analysis: ignore[R005] -- r() casts every chunk operand to float32
        cb = torch.einsum("btn,bsn->bts", c_i, b_i)  # one B/C group
        w_mat = cb[..., None] * l_mat * dt_i[:, None, :, :]  # (B, t, s', nh)
        # analysis: ignore[R005] -- float32: w_mat and xs_i come from r()'s float32 operands
        y_intra = torch.einsum("btsh,bshd->bthd", w_mat, xs_i)
        # analysis: ignore[R005] -- r() casts every chunk operand to float32; s_prev is float32
        y_inter = torch.einsum("btn,bth,bhdn->bthd", c_i, torch.exp(cum), s_prev)
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)  # (B, c, nh)
        # analysis: ignore[R005] -- r() casts every chunk operand to float32
        st = torch.einsum("bsh,bsn,bshd->bhdn", decay_to_end * dt_i, b_i, xs_i)
        s_prev = s_prev * torch.exp(cum[:, -1, :])[:, :, None, None] + st
        ys.append(y_intra + y_inter)
    y = torch.stack(ys).transpose(0, 1).reshape(bsz, s, nh, head_dim)
    y = y + d_skip[None, None, :, None] * xs.float()
    y = y.reshape(bsz, s, d_inner).to(dtype)
    return y * silu(z), (conv_tail, s_prev)


def _recur(proj, conv_w, vecs, state, *, d_state: int, head_dim: int, dtype):
    """One token of the recurrence (``mamba2_step``) on the heads ``proj``
    holds, as ``_ssd``'s arguments. Returns (y * silu(z), (new_tail, new
    ssm)); the given state is not written."""
    a_log, dt_bias, d_skip = vecs
    bsz = proj.shape[0]
    conv_tail, ssm = state  # (B, K-1, conv_dim), (B, nh, hd, ds)
    z, xbc, dt, d_inner, nh = _split_proj(proj, d_state, head_dim)
    window = torch.cat([conv_tail, xbc], dim=1)  # (B, K, conv_dim)
    # analysis: ignore[R005] -- the reference's conv contracts at this dtype too (CONV_K terms)
    conv_out = silu(torch.einsum("bkc,kc->bc", window, conv_w))[:, None, :]
    new_tail = window[:, 1:, :]
    xs = conv_out[..., :d_inner].reshape(bsz, nh, head_dim)
    b_in = conv_out[:, 0, d_inner : d_inner + d_state]  # (B, ds)
    c_in = conv_out[:, 0, d_inner + d_state :]

    dt = _softplus(dt[:, 0].float() + dt_bias)  # (B, nh)
    a = -torch.exp(a_log)
    dec = torch.exp(dt * a[None, :])  # (B, nh)
    # analysis: ignore[R005] -- dt is float32 (_softplus of a float32 sum), b_in and xs are cast
    ssm_new = ssm * dec[:, :, None, None] + torch.einsum(
        "bh,bn,bhd->bhdn", dt, b_in.float(), xs.float()
    )
    y = torch.einsum("bn,bhdn->bhd", c_in.float(), ssm_new)
    y = y + d_skip[None, :, None] * xs.float()
    y = y.reshape(bsz, 1, d_inner).to(dtype)
    return y * silu(z), (new_tail, ssm_new)


def _vecs(params):
    return params["a_log"], params["dt_bias"], params["d_skip"]


def mamba2_full(params, x, *, d_state: int, head_dim: int, chunk: int = 256,
                state=None, valid: torch.Tensor | None = None):
    """Full-sequence chunked SSD. x: (B, S, d_model) -> (y, (conv_tail, ssm)).

    state: optional incoming (conv_tail, ssm) — serving prefill continues a
    slot mid-sequence (None: a zero conv window and SSM state). valid:
    optional (B, S) bool marking real tokens, each row a contiguous PREFIX.
    Invalid tokens are exact no-ops on the state (their dt is forced to 0,
    so they neither decay nor feed the recurrence), and the returned
    conv_tail is the window ending at each row's LAST VALID token: a row
    with no valid token gets its incoming state back bit for bit. On
    DTensors the SSD runs over each model rank's heads (``_on_heads``);
    without an incoming state the final state is then not returned
    (None)."""
    proj = matmul(x, params["w_in"])
    kw = {"d_state": d_state, "head_dim": head_dim, "chunk": chunk, "dtype": x.dtype}
    if tp.is_dtensor(proj):
        y, state = _on_heads(_ssd, proj, params, state, valid, kw)
    else:
        y, state = _ssd(proj, params["conv_w"], _vecs(params), state, valid=valid, **kw)
    y = rms_norm(y, params["norm_gain"])
    return matmul(y, params["w_out"]), state


def mamba2_step(params, x, state, *, d_state: int, head_dim: int, live=None):
    """Single-token decode. x: (B, 1, d_model); state = (conv_tail, ssm),
    updated IN PLACE and returned; live: optional (B,) bool — a dead slot's
    output is garbage and its state is left untouched. Returns (y, state)."""
    proj = matmul(x, params["w_in"])
    kw = {"d_state": d_state, "head_dim": head_dim, "dtype": x.dtype}
    if tp.is_dtensor(proj):
        y, new = _on_heads(_recur, proj, params, state, None, kw)
    else:
        y, new = _recur(proj, params["conv_w"], _vecs(params), state, **kw)
    freeze_dead_slots(new, state, live)
    y = rms_norm(y, params["norm_gain"])
    return matmul(y, params["w_out"]), state


def _on_heads(core, proj, params, state, valid, kw):
    """``core`` (``_ssd``, or ``_recur`` with ``valid`` None) tensor-parallel over the model
    ranks' heads, from a DTensor ``proj`` split over them as the
    column-parallel ``w_in`` leaves it: columns that fit neither the heads
    nor the [z, x, B, C, dt] segments (Zamba2-7B: 911 of 14576 a rank, the
    last rank holding x's tail and all of B, C and dt).

    Each rank's z, x and dt columns of its heads (nh / M of them, in the
    SSM cache's head split), and B and C whole, reach it in one
    ``tp.exchange`` of the activation, never of ``w_in``: ~1/16 of the
    projection a rank at 16 model ranks, where gathering it whole would
    move 15/16. The SSD then runs per head with no collective inside its
    chunk loop; B and C feed every head, so the C·B products and the conv
    of B and C run on every model rank (the stated replicated work).

    The conv: route (b): ``conv_w`` (K, 7296) is read whole on each rank
    (``tp.whole``: 58 KB a layer in bfloat16 against w_in's 104 MB; the
    one model-split weight gathered over the model axis), and only the
    conv tail cache, split 456 channels a rank by the cache rules while
    the heads take 448, is moved to the heads' channels at entry and back
    at exit (``tp.exchange``; (B, 3, 7296) at decode). Returns (y * silu(z)
    split over the model ranks by head, as ``w_out``'s rows are, and the
    new state in the caches' placements, or None without a state). Heads
    that the model ranks do not divide run replicated (``_replicated``)."""
    mesh = proj.device_mesh
    ax = tp.model_axis(mesh)
    a_log = params["a_log"]
    nh, hd, ds = a_log.shape[0], kw["head_dim"], kw["d_state"]
    if nh % ax.size:
        return _replicated(core, proj, params, state, valid, kw, ax)
    hpr, d_inner = nh // ax.size, nh * hd
    heads = [(r * hpr * hd, (r + 1) * hpr * hd) for r in range(ax.size)]
    bc = (d_inner, d_inner + 2 * ds)
    dt0 = 2 * d_inner + 2 * ds
    want = tuple(((lo, hi), (d_inner + lo, d_inner + hi), (2 * d_inner, dt0),
                  (dt0 + r * hpr, dt0 + (r + 1) * hpr)) for r, (lo, hi) in enumerate(heads))
    conv_want = tuple(((lo, hi), bc) for lo, hi in heads)
    have = tp.held(proj, -1, ax)
    conv_w = tp.whole(params["conv_w"], -1)
    vecs = [tp.whole(v, 0) for v in _vecs(params)]
    varying = tp.batch_dims(proj) | {ax.dim}
    args = [proj, conv_w, *vecs]
    grads = [proj.placements] + [tp.weight_grad(w, varying) for w in args[1:]]
    if valid is not None:
        args.append(tp.as_rows(valid, proj))
        grads.append(args[-1].placements)
    if state is not None:
        args += list(state)
        grads += [t.placements for t in state]
        tail_have = tp.held(state[0], -1, ax)
    y_pl = tp.columns_like(proj, ax)
    me = ax.rank

    def local(p_l, w_l, *rest):
        vec_l = [v[me * hpr:(me + 1) * hpr] for v in rest[:3]]
        rest = rest[3:]
        v_l = rest[0] if valid is not None else None
        st = rest[-2:] if state is not None else None
        lo, hi = heads[me]
        w_h = torch.cat([w_l[:, lo:hi], w_l[:, bc[0]:bc[1]]], dim=1)
        p_h = tp.exchange(p_l, -1, have, want, ax)
        if st is not None:
            st = (tp.exchange(st[0], -1, tail_have, conv_want, ax), st[1])
        y, new = core(p_h, w_h, vec_l, st, **(kw if v_l is None else dict(kw, valid=v_l)))
        if st is None:
            return (y,)
        return y, tp.exchange(new[0], -1, conv_want, tail_have, ax), new[1]

    outs = [y_pl] + ([t.placements for t in state] if state is not None else [])
    y, *new = tp.on_ranks(local, args, outs, grads)
    return y, (tuple(new) if state is not None else None)


def _replicated(core, proj, params, state, valid, kw, ax):
    """``_on_heads``'s layer where the model ranks do not divide the heads
    (Zamba2's smoke size on 3 ranks: 8 heads), REPLICATED over them: the
    projection's columns and a carried state are gathered whole over the
    model ranks (``tp.unsplit``), every model rank runs the whole SSD on
    its batch shard, and y comes out whole there (the row-parallel
    ``w_out`` then takes each rank's rows of it with no communication); the
    new state returns in the caches' placements. The layer's SSD FLOPs run
    M times; ``tp.note_replicated`` tells the dry run's recorder. Returns
    as ``_on_heads``."""
    tp.note_replicated("mamba2")
    proj = tp.unsplit(proj, ax)
    args = [proj, tp.unsplit(params["conv_w"], ax), *(tp.unsplit(v, ax) for v in _vecs(params))]
    grads = [proj.placements] + [tp.weight_grad(w, tp.batch_dims(proj)) for w in args[1:]]
    if valid is not None:
        args.append(tp.as_rows(valid, proj))
        grads.append(args[-1].placements)
    if state is not None:
        whole = [tp.unsplit(t, ax) for t in state]
        args += whole
        grads += [t.placements for t in whole]

    def local(p_l, w_l, *rest):
        v_l = rest[3] if valid is not None else None
        st = tuple(rest[-2:]) if state is not None else None
        y, new = core(p_l, w_l, list(rest[:3]), st,
                      **(kw if v_l is None else dict(kw, valid=v_l)))
        return (y,) if st is None else (y, *new)

    outs = [tp.rows_like(proj)] + ([t.placements for t in whole] if state is not None else [])
    y, *new = tp.on_ranks(local, args, outs, grads)
    if state is None:
        return y, None
    return y, tuple(tp.placed(t, old.placements) for t, old in zip(new, state))
