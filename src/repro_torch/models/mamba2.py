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
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init, freeze_dead_slots, matmul, rms_norm, silu

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


def _split_proj(params, x, d_model, d_state, head_dim):
    d_inner, n_heads, conv_dim = dims(d_model, d_state, head_dim)
    proj = matmul(x, params["w_in"])
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner : d_inner + conv_dim]
    dt = proj[..., d_inner + conv_dim :]  # (.., nh)
    return z, xbc, dt, d_inner, n_heads


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


def mamba2_full(params, x, *, d_state: int, head_dim: int, chunk: int = 256,
                state=None, valid: torch.Tensor | None = None):
    """Full-sequence chunked SSD. x: (B, S, d_model) -> (y, (conv_tail, ssm)).

    state: optional incoming (conv_tail, ssm) — serving prefill continues a
    slot mid-sequence (None: a zero conv window and SSM state). valid:
    optional (B, S) bool marking real tokens, each row a contiguous PREFIX.
    Invalid tokens are exact no-ops on the state (their dt is forced to 0,
    so they neither decay nor feed the recurrence), and the returned
    conv_tail is the window ending at each row's LAST VALID token: a row
    with no valid token gets its incoming state back bit for bit."""
    bsz, s, d_model = x.shape
    z, xbc, dt, d_inner, nh = _split_proj(params, x, d_model, d_state, head_dim)
    if state is None:
        conv_prefix = torch.zeros((bsz, CONV_K - 1, xbc.shape[-1]), dtype=xbc.dtype,
                                  device=x.device)
    else:
        conv_prefix = state[0].to(xbc.dtype)
    # raw (pre-conv) window, indexed by tokens consumed: after n valid tokens
    # the carried-out tail is window[n : n + K-1]
    window = torch.cat([conv_prefix, xbc], dim=1)  # (B, K-1+S, conv)
    if valid is None:
        conv_tail = window[:, s : s + CONV_K - 1, :]
    else:
        n_valid = valid.sum(dim=1)  # (B,) in [0, S]: idx <= S + K - 2 is in bounds
        idx = n_valid[:, None] + torch.arange(CONV_K - 1, device=x.device)[None, :]
        conv_tail = torch.gather(window, 1, idx[:, :, None].expand(-1, -1, window.shape[-1]))
    xbc = _causal_conv(xbc, params["conv_w"], conv_prefix)
    xs = xbc[..., :d_inner].reshape(bsz, s, nh, head_dim)
    b_in = xbc[..., d_inner : d_inner + d_state]  # (B, S, ds)
    c_in = xbc[..., d_inner + d_state :]  # (B, S, ds)

    dt = _softplus(dt.float() + params["dt_bias"])  # (B, S, nh)
    if valid is not None:
        # dt == 0 makes a token a no-op on the recurrence: zero decay and
        # zero input contribution
        dt = torch.where(valid[:, :, None], dt, 0.0)
    a = -torch.exp(params["a_log"])  # (nh,)
    da = dt * a[None, None, :]  # log-decay per step, (B, S, nh)

    if s % chunk != 0:
        chunk = s
    nc = s // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))

    def r(t):  # (B, S, ...) -> (nc, B, c, ...)
        return t.float().reshape((bsz, nc, chunk) + t.shape[2:]).transpose(0, 1)

    xs_c, b_c, c_c, dt_c, da_c = map(r, (xs, b_in, c_in, dt, da))
    s_prev = (torch.zeros((bsz, nh, head_dim, d_state), dtype=torch.float32, device=x.device)
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
    y = y + params["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = rms_norm(y * silu(z), params["norm_gain"])
    return matmul(y, params["w_out"]), (conv_tail, s_prev)


def mamba2_step(params, x, state, *, d_state: int, head_dim: int, live=None):
    """Single-token decode. x: (B, 1, d_model); state = (conv_tail, ssm),
    updated IN PLACE and returned; live: optional (B,) bool — a dead slot's
    output is garbage and its state is left untouched. Returns (y, state)."""
    bsz, _, d_model = x.shape
    conv_tail, ssm = state  # (B, K-1, conv_dim), (B, nh, hd, ds)
    z, xbc, dt, d_inner, nh = _split_proj(params, x, d_model, d_state, head_dim)
    window = torch.cat([conv_tail, xbc], dim=1)  # (B, K, conv_dim)
    # analysis: ignore[R005] -- the reference's conv contracts at this dtype too (CONV_K terms)
    conv_out = silu(torch.einsum("bkc,kc->bc", window, params["conv_w"]))[:, None, :]
    new_tail = window[:, 1:, :]
    xs = conv_out[..., :d_inner].reshape(bsz, nh, head_dim)
    b_in = conv_out[:, 0, d_inner : d_inner + d_state]  # (B, ds)
    c_in = conv_out[:, 0, d_inner + d_state :]

    dt = _softplus(dt[:, 0].float() + params["dt_bias"])  # (B, nh)
    a = -torch.exp(params["a_log"])
    dec = torch.exp(dt * a[None, :])  # (B, nh)
    # analysis: ignore[R005] -- dt is float32 (_softplus of a float32 sum), b_in and xs are cast
    ssm_new = ssm * dec[:, :, None, None] + torch.einsum(
        "bh,bn,bhd->bhdn", dt, b_in.float(), xs.float()
    )
    y = torch.einsum("bn,bhdn->bhd", c_in.float(), ssm_new)
    y = y + params["d_skip"][None, :, None] * xs.float()
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = rms_norm(y * silu(z), params["norm_gain"])
    freeze_dead_slots((new_tail, ssm_new), state, live)
    return matmul(y, params["w_out"]), state
