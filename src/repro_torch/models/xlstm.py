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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dense_init, freeze_dead_slots, matmul, rms_norm, silu

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


def _mlstm_cell(state, inputs):
    """One step of the stabilized mLSTM recurrence."""
    c, n, m = state  # (B,nh,hd,hd), (B,nh,hd), (B,nh)
    q, k, v, i_pre, f_pre = inputs  # (B,nh,hd) x3, (B,nh) x2
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    f_sc = torch.exp(log_f + m - m_new)[..., None]
    i_sc = torch.exp(i_pre - m_new)[..., None]
    c_new = c * f_sc[..., None] + i_sc[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = n * f_sc + i_sc * k
    # analysis: ignore[R005] -- mlstm_full casts q, k, v to float32; the state is float32
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    # a fresh state's m is -1e30: exp(-m) is +inf and h is an exact 0
    # analysis: ignore[R005] -- mlstm_full casts q, k, v to float32; the state is float32
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n_new).abs(), torch.exp(-m_new))
    return (c_new, n_new, m_new), num / den[..., None]


def _mlstm_qkvif(params, x, n_heads):
    """x: (B, T, d_model) -> q, k, v (B, T, nh, hd) in x's dtype, the gate
    pre-activations (B, T, nh) in float32, the gate z, d_inner."""
    b, t, _ = x.shape
    up = matmul(x, params["w_up"])
    d_inner = up.shape[-1] // 2
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    hd = d_inner // n_heads
    # sqrt(hd) rounded to x's dtype, as the reference casts it (a host
    # number: no device copy inside a captured step)
    # analysis: ignore[R004] -- a CPU scalar made from a host int: no device tensor, no sync
    root = float(torch.tensor(float(hd)).sqrt().to(x.dtype))
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
    for t in range(xs[0].shape[1]):
        state, h = step(state, tuple(x[:, t] for x in xs))
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
    for lo in range(0, t, chunk):
        out = checkpoint(one_chunk, *state, *(x[:, lo:lo + chunk] for x in xs),
                         use_reentrant=False)
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


def mlstm_full(params, x, *, n_heads: int, state=None, chunk: int = 0, valid=None):
    """The mLSTM block over a sequence. x: (B, T, d_model); state: the
    (C, n, m) to start from (a fresh one if None); valid: optional (B, T)
    bool — invalid tokens leave the state untouched. Returns (y (B, T,
    d_model), final state); the given state tensors are not written."""
    b, t, _ = x.shape
    q, k, v, i_pre, f_pre, z, d_inner = _mlstm_qkvif(params, x, n_heads)
    i_pre, f_pre = _mask_if_gates(i_pre, f_pre, valid)
    if state is None:
        state = mlstm_init_state(b, n_heads, d_inner // n_heads, x.device)
    xs = (q.float(), k.float(), v.float(), i_pre, f_pre)
    state, hs = _chunked_scan(_mlstm_cell, tuple(state), xs, chunk)
    h = hs.reshape(b, t, d_inner).to(x.dtype)
    h = rms_norm(h, params["norm_gain"]) * silu(z)
    return matmul(h, params["w_down"]), state


def mlstm_step(params, x, state, *, n_heads: int, live=None):
    """One token per slot: x (B, 1, d_model). The new state is written into
    ``state`` IN PLACE; dead lanes (``live`` False) keep theirs. Returns
    (y, state)."""
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
    b, t, _ = x.shape
    q, k, v, i_pre, f_pre, z, d_inner = _mlstm_qkvif(params, x, n_heads)
    i_pre, f_pre = _mask_if_gates(i_pre, f_pre, valid)
    if state is None:
        state = mlstm_init_state(b, n_heads, d_inner // n_heads, x.device)
    if t % chunk:
        chunk = t
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    c_st, n_st, m_st = state  # (B,nh,hd,hd), (B,nh,hd), (B,nh)
    hs = []
    for lo in range(0, t, chunk):
        qi, ki, vi = (a[:, lo:lo + chunk].float() for a in (q, k, v))  # (B,c,nh,hd)
        ii, fi = i_pre[:, lo:lo + chunk], f_pre[:, lo:lo + chunk]  # (B,c,nh)
        cum = torch.cumsum(F.logsigmoid(fi), dim=1)
        d_mat = cum[:, :, None, :] - cum[:, None, :, :] + ii[:, None, :, :]  # (B,t,s,nh)
        d_mat = torch.where(tril[None, :, :, None], d_mat, -torch.inf)
        state_exp = cum + m_st[:, None, :]  # (B,c,nh)
        m_loc = torch.maximum(state_exp, d_mat.max(dim=2).values)
        # analysis: ignore[R005] -- qi, ki, vi are cast to float32 above; the gates are float32
        w = torch.exp(d_mat - m_loc[:, :, None, :]) * torch.einsum("bthd,bshd->btsh", qi, ki)
        sc = torch.exp(state_exp - m_loc)
        # analysis: ignore[R005] -- qi, vi are float32 (cast above), as are w and the states
        num = sc[..., None] * torch.einsum("bthd,bhde->bthe", qi, c_st) + torch.einsum(
            "btsh,bshd->bthd", w, vi)
        # analysis: ignore[R005] -- qi is float32 (cast above), as is the state n_st
        den_raw = sc * torch.einsum("bthd,bhd->bth", qi, n_st) + w.sum(dim=2)
        den = torch.maximum(den_raw.abs(), torch.exp(-m_loc))
        hs.append(num / den[..., None])
        # the chunk-boundary state
        tail = cum[:, -1:, :] - cum + ii  # (B,c,nh)
        m_out = torch.maximum(cum[:, -1, :] + m_st, tail.max(dim=1).values)
        decay = torch.exp(tail - m_out[:, None, :])
        carry = torch.exp(cum[:, -1, :] + m_st - m_out)
        # analysis: ignore[R005] -- ki, vi are float32 (cast above), as are the decays
        c_st = carry[..., None, None] * c_st + torch.einsum("bsh,bshd,bshe->bhde", decay, ki, vi)
        # analysis: ignore[R005] -- ki is float32 (cast above), as are the decays
        n_st = carry[..., None] * n_st + torch.einsum("bsh,bshd->bhd", decay, ki)
        m_st = m_out
    h = torch.cat(hs, dim=1).reshape(b, t, d_inner).to(x.dtype)
    h = rms_norm(h, params["norm_gain"]) * silu(z)
    return matmul(h, params["w_down"]), (c_st, n_st, m_st)


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


def slstm_full(params, x, *, n_heads: int, state=None, chunk: int = 0, valid=None):
    """Sequential sLSTM with exponential gating and its stabilizer. x: (B,
    T, d); valid: optional (B, T) bool — the state (c, n, h, m) of an
    invalid token's lane is kept per step (h feeds the recurrent weights,
    so a gate mask cannot express the freeze). Returns (y, final state);
    the given state tensors are not written."""
    b, t, d_model = x.shape
    hd = d_model // n_heads
    pre = matmul(x, params["w_in"]).reshape(b, t, 4, n_heads, hd)
    if state is None:
        state = slstm_init_state(b, n_heads, hd, x.device)
    r = params["r"].float()

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

    keep = (torch.ones((b, t), dtype=torch.bool, device=x.device) if valid is None
            else valid)
    state, hs = _chunked_scan(step, tuple(state), (pre, keep), chunk)
    h = hs.reshape(b, t, d_model).to(x.dtype)
    h = rms_norm(h, params["norm_gain"])
    return matmul(h, params["w_out"]), state


def slstm_step(params, x, state, *, n_heads: int, live=None):
    """One token per slot, the state written IN PLACE as ``mlstm_step``."""
    y, new_state = slstm_full(params, x, n_heads=n_heads, state=state)
    return y, freeze_dead_slots(new_state, state, live)
