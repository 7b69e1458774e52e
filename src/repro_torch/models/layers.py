"""Shared building blocks: norms, RoPE, MLPs, initializers, per-task
low-rank adapters.

Counterpart of ``repro.models.layers``. Parameters are plain dicts of
tensors (the model wraps them in ``nn.ParameterDict``s); functions are free
functions on tensors. Every matmul accumulates in float32 and casts back to
the input dtype, as the JAX package's ``preferred_element_type`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.tensor_parallel import contiguous_grad, mean_last, settle, tp_input


def dense_init(shape, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """normal * 1/sqrt(fan_in), drawn in float32 on the generator's device."""
    fan_in = shape[in_axis]
    x = torch.randn(
        shape, generator=generator, dtype=torch.float32, device=generator.device
    )
    return (x * (1.0 / fan_in**0.5)).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over x's last axis, accumulated in float32, cast to x.dtype.
    On DTensors ``x`` first takes the layout the weight's placements ask
    for (``tp_input``: tensor-parallel, the weight never gathered)."""
    x = tp_input(x, w)
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        # analysis: ignore[R005] -- both operands are float32 (the guard above)
        return contiguous_grad(settle(torch.matmul(x, w)))
    return contiguous_grad(settle(torch.matmul(x.float(), w.float())).to(x.dtype))


# -------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, gain: torch.Tensor | None, eps: float = 1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(mean_last(xf.square()) + eps)
    if gain is not None:
        out = out * (1.0 + gain.float())  # gain stored as (1 + gain)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gain: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5):
    xf = x.float()
    mu = mean_last(xf)
    var = mean_last((xf - mu).square())  # biased, like jnp.var
    out = (xf - mu) * torch.rsqrt(var + eps)
    if gain is not None:
        out = out * gain.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm: no gain, no bias [arXiv:2402.00838]."""
    return layer_norm(x, None, None, eps)


def apply_norm(kind: str, x: torch.Tensor, params) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["gain"] if params else None)
    if kind == "layernorm":
        return layer_norm(
            x,
            params.get("gain") if params else None,
            params.get("bias") if params else None,
        )
    if kind == "nonparam_ln":
        return nonparam_layer_norm(x)
    raise ValueError(kind)


def init_norm(kind: str, d: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"gain": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {
            "gain": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device),
        }
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


# --------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split-halves
    convention with float32 angles."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- MLPs
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: ``F.silu`` at float32, and at
    lower precision ``x * (1 / (1 + exp(-x)))`` with one rounding to the
    input dtype after each op (``F.silu`` rounds once, and at bfloat16
    ~40 % of its outputs then differ from the reference's by one ulp). The
    dense SwiGLU and the MoE experts (``repro_torch.models.moe``) both
    take their SiLU here."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) as XLA
    evaluates it: ``F.gelu(approximate="tanh")`` at float32, and at lower
    precision the reference's op chain ``x * (0.5 * (1 + tanh(c * (x + k *
    x * x * x))))`` with its constants c = sqrt(2 / pi) and k = 0.044715
    rounded to the input dtype and one rounding after each op (``F.gelu``
    rounds once, and at bfloat16 more than a tenth of its outputs then
    differ from the reference's by an ulp: tests/test_torch_bf16.py). The
    GELU MLP (MusicGen) takes it."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def init_mlp(d: int, d_ff: int, kind: str, dtype, generator) -> dict:
    if kind == "swiglu":
        return {
            "wg": dense_init((d, d_ff), generator, dtype=dtype),
            "wi": dense_init((d, d_ff), generator, dtype=dtype),
            "wo": dense_init((d_ff, d), generator, dtype=dtype),
        }
    if kind == "gelu":
        return {
            "wi": dense_init((d, d_ff), generator, dtype=dtype),
            "wo": dense_init((d_ff, d), generator, dtype=dtype),
        }
    raise ValueError(kind)


def apply_mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    x = tp_input(x, params["wi"])  # once for both input products
    if kind == "swiglu":
        gate = silu(matmul(x, params["wg"]))
        return matmul(gate * matmul(x, params["wi"]), params["wo"])
    if kind == "gelu":
        return matmul(gelu(matmul(x, params["wi"])), params["wo"])
    raise ValueError(kind)


# ----------------------------------------------------------- serving state
def freeze_dead_slots(new_state, state, live):
    """Slot-masked recurrent-state update, IN PLACE: each (B, ...) tensor
    of ``state`` takes its ``new_state`` rows where ``live`` (a (B,) bool
    tensor, or None for every slot) and keeps its own elsewhere, so a dead
    lane does not absorb the padding token a batched decode tick feeds it.
    The JAX model returns the masked state; here it is written into the
    old storage (a masked ``copy_``, never a rebinding), because a captured
    CUDA graph keeps reading and writing the tensors it was captured with.
    Returns ``state``."""
    for old, new in zip(state, new_state):
        if live is None:
            old.copy_(new)
        else:
            mask = live.reshape((-1,) + (1,) * (old.ndim - 1))
            old.copy_(torch.where(mask, new.to(old.dtype), old))
    return state


# ------------------------------------------------------- per-task adapters
def apply_task_lora(x: torch.Tensor, ad: dict) -> torch.Tensor:
    """Batched low-rank per-task delta: ``x @ a @ b`` with per-ROW factors.

    x: (B, C, d) block activations; ad["a"]: (B, d, r), ad["b"]: (B, r, d) —
    one factor pair per batch row, gathered by task id (multi-LoRA). Two
    batched products accumulated in float32, cast to x's dtype. Zero
    factors add an exact zero, so the result leaves the adapter-free path's
    values unchanged."""
    h = torch.bmm(x.float(), ad["a"].float())  # (B, C, r)
    return torch.bmm(h, ad["b"].float()).to(x.dtype)
