"""The plain reference of both configurations: a dense GQA decoder in float32
plain PyTorch, written from the published description and nothing of the
program.

- OLMo-1B [arXiv:2402.00838]: non-parametric LayerNorm (no gain, no bias,
  eps 1e-5), multi-head attention, SwiGLU MLP, rotary embeddings on the
  split halves of each head (theta 1e4), the head tied to the embedding.
- multitask-LM [arXiv:1802.03830's m-task setting on a decoder]: RMSNorm
  with a stored (1 + gain) and eps 1e-6, grouped-query attention (query head
  h reads key/value head h // G), SwiGLU, an untied head, and per-task
  rows: a final-norm gain (x * (1 + gain_t)) and a head bias.

Per-position low-rank adapters (the serving store's deltas, each position
under the adapter state that served it) add ``h @ a @ b`` to the attention
and MLP branches off the same normed input ``h``, and their gain and
head-bias rows to the task's.

``tf32=True`` is the control: every product's operands are rounded to
TF32's 10-bit mantissa first (what cuBLAS does with TF32 on), in software,
so the control reads the same on any device. It keeps gradients straight
through the rounding.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


def mm(a, b, tf32=False):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def norm(kind: str, x, gain=None):
    if kind == "rmsnorm":
        out = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)
        return out * (1.0 + gain) if gain is not None else out
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def rope(x, positions, theta: float):
    """x: (B, S, heads, hd); positions: (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, tf32=False, q_block=1024):
    """Causal attention. q: (B, S, H, hd); k, v: (B, S, KVH, hd)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = float(torch.tensor(hd, dtype=torch.float32).rsqrt())
    qg = q.reshape(b, s, kvh, g, hd)
    kt = k.permute(0, 2, 3, 1)  # (B, KVH, hd, S)
    vt = v.permute(0, 2, 1, 3)  # (B, KVH, S, hd)
    outs = []
    for q0 in range(0, s, q_block):
        qs = qg[:, q0:q0 + q_block].permute(0, 2, 3, 1, 4)  # (B, KVH, G, qb, hd)
        sc = mm(qs, kt[:, :, None], tf32) * scale  # (B, KVH, G, qb, S)
        qpos = torch.arange(q0, q0 + qs.shape[3], device=q.device)
        mask = torch.arange(s, device=q.device)[None, :] <= qpos[:, None]
        p = torch.softmax(torch.where(mask, sc, NEG_INF), dim=-1)
        o = mm(p, vt[:, :, None], tf32)  # (B, KVH, G, qb, hd)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, qs.shape[3], h * hd))
    return torch.cat(outs, dim=1)


def block(c: dict, w: dict, i: int, x, positions, tf32=False, lora=None):
    """Layer ``i`` over x (B, S, d). ``lora(branch, i, h)`` returns the
    adapter delta of a branch, or None."""
    p = f"layers.{i}."
    b, s, _ = x.shape
    h_, kvh, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    h = norm(c["norm_kind"], x, w.get(p + "norm1.gain"))
    q = rope(mm(h, w[p + "attn.wq"], tf32).view(b, s, h_, hd), positions, c["rope_theta"])
    k = rope(mm(h, w[p + "attn.wk"], tf32).view(b, s, kvh, hd), positions, c["rope_theta"])
    v = mm(h, w[p + "attn.wv"], tf32).view(b, s, kvh, hd)
    out = mm(attend(q, k, v, tf32), w[p + "attn.wo"], tf32)
    if lora is not None:
        out = out + lora("attn", i, h)
    x = x + out
    h = norm(c["norm_kind"], x, w.get(p + "norm2.gain"))
    gate = mm(h, w[p + "mlp.wg"], tf32)
    ff = mm(gate * torch.sigmoid(gate) * mm(h, w[p + "mlp.wi"], tf32), w[p + "mlp.wo"], tf32)
    if lora is not None:
        ff = ff + lora("mlp", i, h)
    return x + ff


def logits(c: dict, top: dict, x, task_ids, tf32=False, gain_delta=None, bias_delta=None):
    """The head over x (B, S, d): final norm, the task's gain (plus its
    adapter delta, (B, S, d) or None), the head, the task's bias (plus its
    delta, (B, S, V) or None)."""
    x = norm(c["norm_kind"], x, top.get("final_norm.gain"))
    if "task.final_gain" in top:
        gain = top["task.final_gain"][task_ids][:, None, :]
        if gain_delta is not None:
            gain = gain + gain_delta
        x = x * (1.0 + gain)
    head = top["embed"].t() if c["tie_embeddings"] else top["head"]
    out = mm(x, head, tf32) + top["task.head_bias"][task_ids][:, None, :]
    return out + bias_delta if bias_delta is not None else out
