"""Shared building blocks: norms, RoPE, MLPs, initializers.

Counterpart of ``repro.models.layers``. Parameters are plain dicts of
tensors (the model wraps them in ``nn.ParameterDict``s); functions are free
functions on tensors. Every matmul accumulates in float32 and casts back to
the input dtype, as the JAX package's ``preferred_element_type`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(shape, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """normal * 1/sqrt(fan_in), drawn in float32 on the generator's device."""
    fan_in = shape[in_axis]
    x = torch.randn(
        shape, generator=generator, dtype=torch.float32, device=generator.device
    )
    return (x * (1.0 / fan_in**0.5)).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over x's last axis, accumulated in float32, cast to x.dtype."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


# -------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, gain: torch.Tensor | None, eps: float = 1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if gain is not None:
        out = out * (1.0 + gain.float())  # gain stored as (1 + gain)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gain: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)  # biased, like jnp.var
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
    if kind == "swiglu":
        gate = F.silu(matmul(x, params["wg"]))
        return matmul(gate * matmul(x, params["wi"]), params["wo"])
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return matmul(F.gelu(matmul(x, params["wi"]), approximate="tanh"), params["wo"])
    raise ValueError(kind)
