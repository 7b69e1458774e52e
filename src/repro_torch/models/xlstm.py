"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory) and sLSTM (scalar
memory with recurrent weights), the counterpart of ``repro.models.xlstm``,
in plain torch as the reference is plain ``jnp``.

Both are exact stabilized recurrences, one step per token, written as a
Python loop over time (the reference's ``lax.scan``); the same cell serves
training, prefill and decode. ``mlstm_chunkwise`` is the same mLSTM
computed chunkwise-parallel (the reference's ``xlstm_parallel`` lever):
the training forward takes it under ``cfg.xlstm_parallel``; serving keeps
the sequential cell whatever the flag says, as the reference's does.

``xlstm_chunk`` is a rematerialization boundary and changes no value: with
chunk > 1 dividing T (and T > chunk) each chunk of the loop runs under
``torch.utils.checkpoint``, so only chunk-boundary states are kept for the
backward; otherwise the loop is plain, as the reference's rule says.

Parameters are float32 whatever the model's dtype (the reference's
``init_mlstm`` / ``init_slstm`` take none); the recurrences compute in
float32 and cast the mixer's hidden states to x's dtype before the norm.

State layouts (float32):
  mLSTM: C (B, nh, hd, hd), n (B, nh, hd), m (B, nh), m starting at -1e30
  sLSTM: c, n, h (B, nh, hd), m (B, nh), all starting at 0

An invalid prefill token (``valid``) is an exact no-op on the state: mLSTM
masks its gates (input -inf, forget +inf, so the input scale is exactly 0
and the forget scale exactly 1), sLSTM keeps each lane's old state per step.
``*_step`` writes the new state INTO the given state tensors (dead lanes
keep theirs, ``layers.freeze_dead_slots``), since the serving steps are
captured as CUDA graphs over the cache storage.

On DTensors (the tensor-parallel steps of ``repro_torch.sharding``) the
mLSTM splits its value dim over the model ranks (``_mlstm_tp``; a decode
token on the cache rules' key-split state: ``_mlstm_decode_tp``) and the
sLSTM recurrence runs replicated on them (``_slstm_tp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dense_init, freeze_dead_slots, matmul, rms_norm, silu
from repro_torch.sharding import tensor_parallel as tp

M_INIT = -1e30  # the mLSTM stabilizer of a fresh state


def mlstm_dims(d_model: int, n_heads: int, proj_factor: float = 2.0) -> tuple[int, int]:
    """(d_inner, head width) of an mLSTM block: the heads split the
    up-projected width, not d_model."""
    d_inner = int(d_model * proj_factor)
    return d_inner, d_inner // n_heads


# ------------------------------------------------------------------- mLSTM
def init_mlstm(d_model: int, n_heads: int, generator: torch.Generator,
               proj_factor: float = 2.0) -> dict:
    d_inner, _ = mlstm_dims(d_model, n_heads, proj_factor)
    return {
        "w_up": dense_init((d_model, 2 * d_inner), generator),  # [x_in, gate z]
        "wq": dense_init((d_inner, d_inner), generator),
        "wk": dense_init((d_inner, d_inner), generator),
        "wv": dense_init((d_inner, d_inner), generator),
        "w_if": dense_init((d_inner, 2 * n_heads), generator),  # input/forget gates
        "norm_gain": torch.zeros((d_inner,), device=generator.device),
        "w_down": dense_init((d_inner, d_model), generator),
    }


def _mlstm_update(state, k, v, i_pre, f_pre):
    """The stabilized mLSTM state update: (C, n, m) after one step."""
    c, n, m = state  # (B,nh,hd,e), (B,nh,hd), (B,nh)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    f_sc = torch.exp(log_f + m - m_new)[..., None]
    i_sc = torch.exp(i_pre - m_new)[..., None]
    c_new = c * f_sc[..., None] + i_sc[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = n * f_sc + i_sc * k
    return c_new, n_new, m_new


def _mlstm_readout(num, qn, m):
    """The hidden state from q C (num) and q . n (qn)."""
    # a fresh state's m is -1e30: exp(-m) is +inf and h is an exact 0
    return num / torch.maximum(qn.abs(), torch.exp(-m))[..., None]


def _mlstm_cell(state, inputs):
    """One step of the stabilized mLSTM recurrence."""
    q, k, v, i_pre, f_pre = inputs  # (B,nh,hd), (B,nh,hd), (B,nh,e), (B,nh) x2
    c_new, n_new, m_new = _mlstm_update(state, k, v, i_pre, f_pre)
    # analysis: ignore[R005] -- mlstm_full casts q, k, v to float32; the state is float32
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    # analysis: ignore[R005] -- mlstm_full casts q, k, v to float32; the state is float32
    qn = torch.einsum("bhd,bhd->bh", q, n_new)
    return (c_new, n_new, m_new), _mlstm_readout(num, qn, m_new)


def _root(hd: int, dtype) -> float:
    """sqrt(hd) rounded to ``dtype``, as the reference casts it (a host
    number: no device copy inside a captured step)."""
    # analysis: ignore[R004] -- a CPU scalar made from a host int: no device tensor, no sync
    return float(torch.tensor(float(hd)).sqrt().to(dtype))


def _mlstm_qkvif(params, up, n_heads, dtype):
    """up = x @ w_up (B, T, 2 d_inner) -> q, k, v (B, T, nh, hd) in x's
    dtype, the gate pre-activations (B, T, nh) in float32, the gate z,
    d_inner."""
    b, t, _ = up.shape
    d_inner = up.shape[-1] // 2
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    hd = d_inner // n_heads
    root = _root(hd, dtype)
    q = matmul(x_in, params["wq"]).reshape(b, t, n_heads, hd)
    k = matmul(x_in, params["wk"]).reshape(b, t, n_heads, hd) / root
    v = matmul(x_in, params["wv"]).reshape(b, t, n_heads, hd)
    gates = matmul(x_in, params["w_if"]).float()
    return q, k, v, gates[..., :n_heads], gates[..., n_heads:], z, d_inner


def mlstm_init_state(b: int, n_heads: int, hd: int, device=None):
    return (
        torch.zeros((b, n_heads, hd, hd), device=device),
        torch.zeros((b, n_heads, hd), device=device),
        torch.full((b, n_heads), M_INIT, device=device),
    )


def _scan(step, state, xs):
    """The recurrence over the time axis (1) of every tensor of ``xs``:
    (final state, the per-step outputs stacked on axis 1)."""
    hs = []
    # unbind, not x[:, t]: each slice's backward would build a zero tensor
    # of the whole sequence, T of them
    for inputs in zip(*(x.unbind(1) for x in xs)):
        state, h = step(state, inputs)
        hs.append(h)
    return state, torch.stack(hs, dim=1)


def _chunked_scan(step, state, xs, chunk: int):
    """``_scan`` in rematerialized chunks: each chunk of ``chunk`` steps runs
    under ``torch.utils.checkpoint``, so the backward keeps only the
    chunk-boundary states and recomputes each chunk's interior. chunk <= 1,
    T % chunk != 0 or T <= chunk is the plain loop (the reference's rule)."""
    t = xs[0].shape[1]
    if chunk <= 1 or t % chunk != 0 or t <= chunk:
        return _scan(step, state, xs)
    k = len(state)

    def one_chunk(*args):
        st, h = _scan(step, args[:k], args[k:])
        return (*st, h)

    hs = []
    for parts in zip(*(x.split(chunk, dim=1) for x in xs)):
        out = checkpoint(one_chunk, *state, *parts, use_reentrant=False)
        state = tuple(out[:k])
        hs.append(out[k])
    return state, torch.cat(hs, dim=1)


def _mask_if_gates(i_pre, f_pre, valid):
    """Invalid tokens as exact no-ops on the mLSTM state: i -> -inf makes
    the input scale exactly 0, f -> +inf makes log_f exactly 0, so the
    forget scale is exactly 1 and the stabilizer m carries through. valid:
    (B, T) bool against (B, T, nh) gate pre-activations."""
    if valid is None:
        return i_pre, f_pre
    keep = valid[:, :, None]
    return (torch.where(keep, i_pre, -torch.inf), torch.where(keep, f_pre, torch.inf))


def _steps(q, k, v, i_pre, f_pre, state, chunk):
    """The sequential cell over the sequence (``_chunked_scan``'s chunks):
    (hs (B, T, nh, e), final state)."""
    state, hs = _chunked_scan(_mlstm_cell, tuple(state), (q, k, v, i_pre, f_pre), chunk)
    return hs, state


def _chunks(q, k, v, i_pre, f_pre, state, chunk):
    """The chunkwise-parallel recurrence (see ``mlstm_chunkwise``) over
    float32 q, k (B, T, nh, hd), v (B, T, nh, e) and gates (B, T, nh):
    (hs (B, T, nh, e), final state)."""
    t = q.shape[1]
    if t % chunk:
        chunk = t
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    c_st, n_st, m_st = state  # (B,nh,hd,e), (B,nh,hd), (B,nh)
    hs = []
    for qi, ki, vi, ii, fi in zip(*(a.split(chunk, dim=1) for a in (q, k, v, i_pre, f_pre))):
        # qi, ki (B,c,nh,hd), vi (B,c,nh,e), ii, fi (B,c,nh)
        cum = torch.cumsum(F.logsigmoid(fi), dim=1)
        d_mat = cum[:, :, None, :] - cum[:, None, :, :] + ii[:, None, :, :]  # (B,t,s,nh)
        d_mat = torch.where(tril[None, :, :, None], d_mat, -torch.inf)
        state_exp = cum + m_st[:, None, :]  # (B,c,nh)
        m_loc = torch.maximum(state_exp, d_mat.max(dim=2).values)
        # analysis: ignore[R005] -- the callers cast q, k, v to float32; the gates are float32
        w = torch.exp(d_mat - m_loc[:, :, None, :]) * torch.einsum("bthd,bshd->btsh", qi, ki)
        sc = torch.exp(state_exp - m_loc)
        # analysis: ignore[R005] -- qi, vi are float32 (the callers cast), as are w and the states
        num = sc[..., None] * torch.einsum("bthd,bhde->bthe", qi, c_st) + torch.einsum(
            "btsh,bshd->bthd", w, vi)
        # analysis: ignore[R005] -- qi is float32 (the callers cast), as is the state n_st
        den_raw = sc * torch.einsum("bthd,bhd->bth", qi, n_st) + w.sum(dim=2)
        den = torch.maximum(den_raw.abs(), torch.exp(-m_loc))
        hs.append(num / den[..., None])
        # the chunk-boundary state
        tail = cum[:, -1:, :] - cum + ii  # (B,c,nh)
        m_out = torch.maximum(cum[:, -1, :] + m_st, tail.max(dim=1).values)
        decay = torch.exp(tail - m_out[:, None, :])
        carry = torch.exp(cum[:, -1, :] + m_st - m_out)
        # analysis: ignore[R005] -- ki, vi are float32 (the callers cast), as are the decays
        c_st = carry[..., None, None] * c_st + torch.einsum("bsh,bshd,bshe->bhde", decay, ki, vi)
        # analysis: ignore[R005] -- ki is float32 (the callers cast), as are the decays
        n_st = carry[..., None] * n_st + torch.einsum("bsh,bshd->bhd", decay, ki)
        m_st = m_out
    return torch.cat(hs, dim=1), (c_st, n_st, m_st)


def _mlstm(params, x, n_heads, state, valid, recur, chunk):
    """The mLSTM block over a sequence through ``recur`` (``_steps`` or
    ``_chunks``); on DTensors tensor-parallel (``_mlstm_tp``)."""
    b, t, _ = x.shape
    up = matmul(x, params["w_up"])
    if tp.is_dtensor(up):
        h, z, state = _mlstm_tp(params, up, n_heads, state, valid, recur, chunk, x.dtype)
    else:
        q, k, v, i_pre, f_pre, z, d_inner = _mlstm_qkvif(params, up, n_heads, x.dtype)
        i_pre, f_pre = _mask_if_gates(i_pre, f_pre, valid)
        if state is None:
            state = mlstm_init_state(b, n_heads, d_inner // n_heads, x.device)
        hs, state = recur(q.float(), k.float(), v.float(), i_pre, f_pre, tuple(state), chunk)
        h = hs.reshape(b, t, d_inner).to(x.dtype)
    h = rms_norm(h, params["norm_gain"]) * silu(z)
    return matmul(h, params["w_down"]), state


def mlstm_full(params, x, *, n_heads: int, state=None, chunk: int = 0, valid=None):
    """The mLSTM block over a sequence. x: (B, T, d_model); state: the
    (C, n, m) to start from (a fresh one if None); valid: optional (B, T)
    bool — invalid tokens leave the state untouched. Returns (y (B, T,
    d_model), final state); the given state tensors are not written. On
    DTensors without a state the final state is not returned (None)."""
    return _mlstm(params, x, n_heads, state, valid, _steps, chunk)


def mlstm_step(params, x, state, *, n_heads: int, live=None):
    """One token per slot: x (B, 1, d_model). The new state is written into
    ``state`` IN PLACE; dead lanes (``live`` False) keep theirs. Returns
    (y, state)."""
    if tp.is_dtensor(state[0]) and _key_split(state[0]):
        return _mlstm_decode_tp(params, x, state, n_heads, live), state
    y, new_state = mlstm_full(params, x, n_heads=n_heads, state=state)
    return y, freeze_dead_slots(new_state, state, live)


# ----------------------------------------------- chunkwise-parallel mLSTM
def mlstm_chunkwise(params, x, *, n_heads: int, chunk: int = 64, state=None, valid=None):
    """The exact stabilized mLSTM computed chunkwise-parallel, the
    reference's ``mlstm_chunkwise``: inside a chunk of c tokens every term
    is a (c x c) product, and one step per chunk carries (C, n, m):

      num_t = e^{cum_t + m_in - m_t} q_t C_in
              + sum_{s<=t} e^{cum_t - cum_s + i_s - m_t} (q_t . k_s) v_s
      den_t = max(|e^{cum_t + m_in - m_t} q_t . n_in + sum_s w_ts|, e^{-m_t})

    with cum the within-chunk cumulative log forget gate and m_t the running
    stabilizer, all in float32. A T that ``chunk`` does not divide is one
    chunk. Arguments and result as ``mlstm_full``'s."""
    return _mlstm(params, x, n_heads, state, valid, _chunks, chunk)


# ------------------------------------------------ tensor-parallel mLSTM
def _value_block(r: int, w: int, hd: int) -> tuple[int, int, int, int]:
    """(first head, heads, first value column, value columns) of model
    rank r's block [r w, (r + 1) w) of the (heads, value) columns."""
    lo = r * w
    if w <= hd:
        return lo // hd, 1, lo % hd, w
    return lo // hd, w // hd, 0, hd


def _key_split(c) -> bool:
    """Whether DTensor C (B, nh, hd, hd) splits its key dim over more than
    one model rank (the cache rules' layout where the heads do not
    divide the ranks)."""
    ax = tp.model_axis(c.device_mesh)
    return ax.size > 1 and tp.is_split(c.placements[ax.dim], 2)


def _mlstm_tp(params, up, n_heads, state, valid, recur, chunk, dtype):
    """The mLSTM of ``_mlstm`` tensor-parallel over the model ranks, for T
    > 1 (training, prefill; and decode where the cache splits whole
    heads): the VALUE split. up = x @ w_up arrives column-parallel
    (xLSTM-350M: 256 of 4096 columns a rank, ranks 0-7 x_in, 8-15 z). One
    ``tp.exchange`` gives each rank x_in whole (the input of the
    column-parallel wq / wk / wv) and z's block [r w, (r + 1) w) of w =
    d_inner / M columns, the block of v that its wv shard computes and of
    h that ``w_down``'s rows take: a quarter of one head's value columns
    at 4 heads over 16 ranks. A second exchange gives it q and k whole for
    the heads of that block; C is then split over its value dim like v,
    and q C, q . n, the state update and (chunkwise) q . k need no
    collective inside the time loop. n, m and q . n (and the chunkwise's q
    . k and n update) are computed whole for the rank's heads on each of
    the M / nh ranks sharing them, and the gate product for those heads'
    two columns of ``w_if`` (whole: 8 does not divide 16; a split ``w_if``
    gives each rank its columns' gates, regrouped by one exchange): the
    stated replicated work. A carried state (prefill) moves from the cache rules'
    key split to the value split at entry and back at exit
    (``tp.swap_split``: one all-to-all each way; n and m all-gathered);
    a fresh one moves nothing. Returns (h (B, T, d_inner) in x's dtype and
    z, both split as ``w_down``'s rows; the state in the caches'
    placements, or None without one)."""
    ax = tp.model_axis(up.device_mesh)
    m, me = ax.size, ax.rank
    d_inner = up.shape[-1] // 2
    hd = d_inner // n_heads
    w = d_inner // m
    wq, wk, wv, w_if = (params[k] for k in ("wq", "wk", "wv", "w_if"))
    if d_inner % m or (hd % w and w % hd) or any(
            tp.held(t, 1, ax) != tuple(((r * w, (r + 1) * w),) for r in range(m))
            for t in (wq, wk, wv)):
        return _mlstm_replicated(params, up, n_heads, state, valid, recur, chunk, dtype, ax)
    h0, nh_r, e0, e_r = _value_block(me, w, hd)
    up_want = tuple(((0, d_inner), (d_inner + r * w, d_inner + (r + 1) * w))
                    for r in range(m))
    qk_have = tuple(((r * w, (r + 1) * w), (d_inner + r * w, d_inner + (r + 1) * w))
                    for r in range(m))
    heads = [_value_block(r, w, hd)[:2] for r in range(m)]
    qk_want = tuple(((a * hd, (a + n) * hd), (d_inner + a * hd, d_inner + (a + n) * hd))
                    for a, n in heads)
    up_have = tp.held(up, -1, ax)
    if_have = tp.held(w_if, 1, ax) if tp.is_split(w_if.placements[ax.dim], 1) else None
    if_want = tuple(((a, a + n), (n_heads + a, n_heads + a + n)) for a, n in heads)
    root = _root(hd, dtype)
    varying = tp.batch_dims(up) | {ax.dim}
    args = [up, wq, wk, wv, w_if]
    grads = [up.placements] + [tp.weight_grad(t, varying) for t in args[1:]]
    if valid is not None:
        args.append(tp.as_rows(valid, up))
        grads.append(args[-1].placements)
    if state is not None:
        # C's layout: split over its key dim (the cache rules' where hd
        # divides the ranks), over the heads in the value split's blocks
        # (nh divides them), or any other, read whole ("own": each rank
        # slices its block, and the blocks are gathered back at exit)
        c_mode = ("key" if _key_split(state[0]) else "heads" if m == 1 or tp.held(
            state[0], 1, ax) == tuple(((a, a + n),) for a, n in heads) else "own")
        c_in = tp.unsplit(state[0], ax) if c_mode == "own" else state[0]
        args += [c_in, *state[1:]]
        grads += [c_in.placements] + [t.placements for t in state[1:]]
        n_split = tp.is_split(state[1].placements[ax.dim], 2)
    out_pl = tp.columns_like(up, ax)

    def _to_value_split(c, n, mm):
        b = c.shape[0]
        if c_mode == "key":  # (B, nh, hd / M, hd) -> (B, nh_r, hd, e_r)
            c = tp.swap_split(c.permute(0, 2, 1, 3).reshape(b, c.shape[2], -1), 1, 2, ax)
            c = c.reshape(b, hd, nh_r, e_r).permute(0, 2, 1, 3)
        elif c_mode == "own":
            c = c[:, h0:h0 + nh_r, :, e0:e0 + e_r]
        if n_split:
            n = tp.all_gather(n, 2, ax)
        return c, n[:, h0:h0 + nh_r], mm[:, h0:h0 + nh_r]

    def _from_value_split(c, n, mm):
        b = c.shape[0]
        if c_mode == "key":
            c = tp.swap_split(c.permute(0, 2, 1, 3).reshape(b, hd, w), 2, 1, ax)
            c = c.reshape(b, -1, n_heads, hd).permute(0, 2, 1, 3)
        elif c_mode == "own":  # the (head, value) blocks of every rank, in rank order
            c = tp.all_gather(c.permute(0, 2, 1, 3).reshape(b, hd, w), 2, ax)
            c = c.reshape(b, hd, n_heads, hd).permute(0, 2, 1, 3)
        # n and m of every head, from the first rank holding it
        pick = [h * hd // w * nh_r + h - heads[h * hd // w][0] for h in range(n_heads)]
        n = tp.all_gather(n, 1, ax)[:, pick]
        mm = tp.all_gather(mm, 1, ax)[:, pick]
        if n_split:
            lo, hi = tp.shard_ranges(hd, m)[me]
            n = n[..., lo:hi]
        return c.contiguous(), n.contiguous(), mm

    def local(up_l, wq_l, wk_l, wv_l, wif_l, *rest):
        b, t = up_l.shape[:2]
        xz = tp.exchange(up_l, -1, up_have, up_want, ax)
        x_in, z = xz[..., :d_inner], xz[..., d_inner:]
        q, k = matmul(x_in, wq_l), matmul(x_in, wk_l) / root
        qk = tp.exchange(torch.cat([q, k], dim=-1), -1, qk_have, qk_want, ax)
        q = qk[..., :nh_r * hd].reshape(b, t, nh_r, hd)
        k = qk[..., nh_r * hd:].reshape(b, t, nh_r, hd)
        v = matmul(x_in, wv_l).reshape(b, t, nh_r, e_r)
        if if_have is None:  # w_if whole here: the product of the heads' columns
            wif = torch.cat([wif_l[:, h0:h0 + nh_r], wif_l[:, n_heads + h0:n_heads + h0 + nh_r]],
                            1)
            gates = matmul(x_in, wif).float()
        else:  # split: each rank's columns, the heads' gates regrouped
            gates = tp.exchange(matmul(x_in, wif_l), -1, if_have, if_want, ax).float()
        v_l = rest[0] if valid is not None else None
        i_pre, f_pre = _mask_if_gates(gates[..., :nh_r], gates[..., nh_r:], v_l)
        if state is None:
            st = (torch.zeros((b, nh_r, hd, e_r), device=up_l.device),
                  torch.zeros((b, nh_r, hd), device=up_l.device),
                  torch.full((b, nh_r), M_INIT, device=up_l.device))
        else:
            st = _to_value_split(*rest[-3:])
        hs, st = recur(q.float(), k.float(), v.float(), i_pre, f_pre, st, chunk)
        h = hs.reshape(b, t, w).to(dtype)
        if state is None:
            return h, z
        return (h, z) + _from_value_split(*st)

    outs = [out_pl, out_pl]
    if state is not None:
        outs += [c_in.placements] + [t.placements for t in state[1:]]
    h, z, *st = tp.on_ranks(local, args, outs, grads)
    if state is None:
        return h, z, None
    return h, z, (tp.placed(st[0], state[0].placements), *st[1:])


def _mlstm_replicated(params, up, n_heads, state, valid, recur, chunk, dtype, ax):
    """The mLSTM of ``_mlstm_tp`` where its head width fits neither the
    value split's column blocks nor their multiples (d_inner / M neither
    divides nor is divided by the head width, or d_inner not a multiple of
    M: xLSTM's smoke size on 3 ranks), REPLICATED over the model ranks:
    ``up`` is gathered whole over them (x_in and z), the column-parallel
    q, k, v and gate products run on each rank's weight columns and their
    outputs are gathered whole (the activations move, never the weights),
    and every model rank runs the whole recurrence on its batch shard; a
    carried state is read whole and returns in the caches' placements.
    The recurrence's FLOPs run M times; ``tp.note_replicated`` tells the
    dry run's recorder. Returns (h and z whole over the model ranks, the
    state or None)."""
    tp.note_replicated("mlstm")
    up = tp.unsplit(up, ax)
    d_inner = up.shape[-1] // 2
    hd = d_inner // n_heads
    root = _root(hd, dtype)
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    args = [tp.unsplit(matmul(x_in, params[k]), ax) for k in ("wq", "wk", "wv", "w_if")]
    grads = [t.placements for t in args]
    if valid is not None:
        args.append(tp.as_rows(valid, up))
        grads.append(args[-1].placements)
    whole = [tp.unsplit(t, ax) for t in state] if state is not None else []
    args += whole
    grads += [t.placements for t in whole]

    def local(q, k, v, gates, *rest):
        b, t = q.shape[:2]
        heads = (b, t, n_heads, hd)
        gates = gates.float()
        i_pre, f_pre = _mask_if_gates(gates[..., :n_heads], gates[..., n_heads:],
                                      rest[0] if valid is not None else None)
        st = tuple(rest[-3:]) if state is not None else mlstm_init_state(b, n_heads, hd,
                                                                           q.device)
        hs, st = recur(q.reshape(heads).float(), (k.reshape(heads) / root).float(),
                       v.reshape(heads).float(), i_pre, f_pre, st, chunk)
        h = hs.reshape(b, t, d_inner).to(dtype)
        return (h, *st) if state is not None else (h,)

    outs = [tp.rows_like(up)] + [t.placements for t in whole]
    h, *st = tp.on_ranks(local, args, outs, grads)
    if state is None:
        return h, z, None
    return h, z, tuple(tp.placed(s, old.placements) for s, old in zip(st, state))


def _mlstm_decode_tp(params, x, state, n_heads, live):
    """One decode token of the mLSTM on DTensor caches whose C (B, nh, hd,
    hd) and n split the KEY dim over the model ranks (the cache rules'
    layout at 4 heads over 16 ranks: 32 key rows of every head), written
    IN PLACE: each rank takes q and k's rows of its keys and v whole (the
    token's q, k, v all-gathered: (B, 3 d_inner), small at T = 1), updates
    its C and n rows, and one all-reduce of its partial q C and q . n
    ((B, nh, hd) + (B, nh) float32) gives every rank the whole h; m is
    computed whole on every rank. Returns y."""
    ax = tp.model_axis(x.device_mesh)
    m, me = ax.size, ax.rank
    up = matmul(x, params["w_up"])
    d_inner = up.shape[-1] // 2
    hd = d_inner // n_heads
    w = d_inner // m
    wq, wk, wv, w_if = (params[k] for k in ("wq", "wk", "wv", "w_if"))
    up_have = tp.held(up, -1, ax)
    up_want = tuple(((0, d_inner), (d_inner + r * w, d_inner + (r + 1) * w))
                    for r in range(m))
    root = _root(hd, x.dtype)
    lo, hi = tp.shard_ranges(hd, m)[me]
    live = torch.ones(x.shape[0], dtype=torch.bool, device=x.device) if live is None else live
    out_pl = tp.columns_like(up, ax)

    def local(up_l, wq_l, wk_l, wv_l, wif_l, live_l, c, n, mm):
        b = up_l.shape[0]
        xz = tp.exchange(up_l, -1, up_have, up_want, ax)
        x_in, z = xz[..., :d_inner], xz[..., d_inner:]
        qkv = torch.cat([matmul(x_in, wq_l), matmul(x_in, wk_l) / root, matmul(x_in, wv_l)], -1)
        qkv = tp.all_gather(qkv[:, 0], 1, ax).reshape(b, m, 3, w).float()
        q, k, v = (qkv[:, :, j].reshape(b, n_heads, hd) for j in range(3))
        gates = matmul(x_in, wif_l).float()[:, 0]
        q, k = q[..., lo:hi], k[..., lo:hi]
        c_new, n_new, m_new = _mlstm_update((c, n, mm), k, v, gates[:, :n_heads],
                                            gates[:, n_heads:])
        # analysis: ignore[R005] -- q, k, v are cast to float32 above; the state is float32
        num = torch.einsum("bhd,bhde->bhe", q, c_new)
        # analysis: ignore[R005] -- q is float32 (cast above), as is the state n
        qn = torch.einsum("bhd,bhd->bh", q, n_new)
        red = tp.all_reduce(torch.cat([num.reshape(b, -1), qn], 1), ax)
        h = _mlstm_readout(red[:, :-n_heads].reshape(b, n_heads, hd), red[:, -n_heads:], m_new)
        freeze_dead_slots((c_new, n_new, m_new), (c, n, mm), live_l)
        return h.reshape(b, 1, d_inner)[..., me * w:(me + 1) * w].to(x.dtype), z

    args = [up, wq, wk, wv, w_if, tp.as_rows(live, up), *state]
    h, z = tp.on_ranks(local, args, [out_pl, out_pl], None)
    h = rms_norm(h, params["norm_gain"]) * silu(z)
    return matmul(h, params["w_down"])


# ------------------------------------------------------------------- sLSTM
def init_slstm(d_model: int, n_heads: int, generator: torch.Generator) -> dict:
    hd = d_model // n_heads
    return {
        # input projections for gates z, i, f, o
        "w_in": dense_init((d_model, 4 * d_model), generator),
        # block-diagonal recurrent weights per head, per gate
        "r": dense_init((4, n_heads, hd, hd), generator, in_axis=2),
        "norm_gain": torch.zeros((d_model,), device=generator.device),
        "w_out": dense_init((d_model, d_model), generator),
    }


def slstm_init_state(b: int, n_heads: int, hd: int, device=None):
    def z():
        return torch.zeros((b, n_heads, hd), device=device)

    return (z(), z(), z(), torch.zeros((b, n_heads), device=device))  # c, n, h, m


def _slstm_scan(pre, r, state, valid, chunk):
    """The sLSTM recurrence over pre-activations (B, T, 4, nh, hd) with the
    block-diagonal ``r``: (hs (B, T, nh, hd) float32, final state)."""
    b, t, _, n_heads, hd = pre.shape
    if state is None:
        state = slstm_init_state(b, n_heads, hd, pre.device)
    r = r.float()

    def step(st, inputs):
        c, n, h, m = st
        p, keep = inputs
        p = p.float()  # (B, 4, nh, hd)
        # analysis: ignore[R005] -- h is the float32 sLSTM state; r is cast above
        rec = torch.einsum("bhd,ghde->bghe", h, r)  # (B, 4, nh, hd)
        z_pre, i_pre, f_pre, o_pre = (p[:, g] + rec[:, g] for g in range(4))
        i_gate = i_pre.mean(dim=-1)  # scalar gates per head
        f_gate = f_pre.mean(dim=-1)
        log_f = F.logsigmoid(f_gate)
        m_new = torch.maximum(log_f + m, i_gate)
        f_sc = torch.exp(log_f + m - m_new)[..., None]
        i_sc = torch.exp(i_gate - m_new)[..., None]
        c_new = f_sc * c + i_sc * torch.tanh(z_pre)
        n_new = f_sc * n + i_sc
        h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
        new = tuple(
            torch.where(keep.reshape((-1,) + (1,) * (nv.ndim - 1)), nv, ov)
            for nv, ov in zip((c_new, n_new, h_new, m_new), st)
        )
        return new, new[2]

    keep = (torch.ones((b, t), dtype=torch.bool, device=pre.device) if valid is None
            else valid)
    state, hs = _chunked_scan(step, tuple(state), (pre, keep), chunk)
    return hs, state


def slstm_full(params, x, *, n_heads: int, state=None, chunk: int = 0, valid=None):
    """Sequential sLSTM with exponential gating and its stabilizer. x: (B,
    T, d); valid: optional (B, T) bool — the state (c, n, h, m) of an
    invalid token's lane is kept per step (h feeds the recurrent weights,
    so a gate mask cannot express the freeze). Returns (y, final state);
    the given state tensors are not written. On DTensors the recurrence
    runs replicated over the model ranks (``_slstm_tp``)."""
    b, t, d_model = x.shape
    pre = matmul(x, params["w_in"])
    if tp.is_dtensor(pre):
        hs, state = _slstm_tp(pre, params["r"], state, valid, chunk)
    else:
        hs, state = _slstm_scan(pre.reshape(b, t, 4, n_heads, d_model // n_heads),
                                params["r"], state, valid, chunk)
    h = hs.reshape(b, t, d_model).to(x.dtype)
    h = rms_norm(h, params["norm_gain"])
    return matmul(h, params["w_out"]), state


def _slstm_tp(pre, r, state, valid, chunk):
    """The sLSTM recurrence on DTensors, REPLICATED over the model ranks:
    each step reads a head's whole h (``r`` is block-diagonal over (hd,
    hd)) and its gates take means over hd, while the column-parallel
    ``w_in`` leaves each rank one gate of one head (xLSTM-350M: 256 of
    4096 columns). So the pre-activations are gathered whole once a call
    (``tp.whole``), a carried state's (c, n, h) too (from the cache rules'
    split of hd), and every model rank runs the whole recurrence on its
    batch shard: its products, 2 B T 4 nh hd^2 FLOPs a layer's forward,
    run M times (3 of xLSTM-350M's 24 layers). The hidden states come out
    whole over the model ranks, and the row-parallel ``w_out`` takes each
    rank's slice of them; the new state returns in the caches'
    placements, sliced with no communication. Returns (hs (B, T, nh, hd),
    state or None without one)."""
    pre = tp.whole(pre, -1)
    b, t, width = pre.shape
    n_heads, hd = r.shape[1], r.shape[2]
    args, grads = [pre, r], [pre.placements, tp.weight_grad(r, tp.batch_dims(pre))]
    if valid is not None:
        args.append(tp.as_rows(valid, pre))
        grads.append(args[-1].placements)
    if state is not None:
        args += [tp.whole(s, -1) for s in state]
        grads += [s.placements for s in args[-4:]]
    out_pl = [tp.rows_like(pre)] + ([s.placements for s in args[-4:]] if state else [])

    def local(pre_l, r_l, *rest):
        pre_l = pre_l.reshape(pre_l.shape[0], t, 4, n_heads, hd)
        v_l = rest[0] if valid is not None else None
        hs, st = _slstm_scan(pre_l, r_l, tuple(rest[-4:]) if state else None, v_l, chunk)
        return (hs, *st) if state is not None else (hs,)

    hs, *st = tp.on_ranks(local, args, out_pl, grads)
    if state is None:
        return hs, None
    return hs, tuple(tp.placed(s, old.placements) for s, old in zip(st, state))


def slstm_step(params, x, state, *, n_heads: int, live=None):
    """One token per slot, the state written IN PLACE as ``mlstm_step``."""
    y, new_state = slstm_full(params, x, n_heads=n_heads, state=state)
    return y, freeze_dead_slots(new_state, state, live)
