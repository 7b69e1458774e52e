"""Dense decoder LM for serving: the ``pattern == ("attn",)`` part of
``repro.models.model.TransformerLM``.

The JAX model keeps period-stacked (P, ...) params and ``lax.scan``s over
them; here each layer is its own ``_Block`` module and the stack is a
Python loop. Weights come from a seeded ``torch.Generator`` on the model's
device (the JAX package's ``dense_init`` law, other random numbers) or from
the JAX params through ``repro_torch.convert``.

Serving entry points, counterparts of the JAX ones:
  * ``init_cache`` / ``reset_slot_state`` — dense per-slot K/V stripes,
    one (k, v) pair of (B, max_seq, KVH, hd) tensors per layer.
  * ``decode_step``  — one token per slot against the caches at ``pos``.
  * ``prefill_step`` — a (B, C) prompt chunk, all C tokens in parallel.

Both steps update the caches IN PLACE (and return them, as the JAX
functions return new ones). Multi-task personalization lives in
``self.task``: per-task final-norm gain (parametric norms only) and lm-head
bias, gathered by each row's task id.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import pos_vector, require_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    dense_init,
    init_mlp,
    init_norm,
    matmul,
)


def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()}
    )


class _Block(nn.Module):
    """One attention + MLP layer (the JAX model's "attn" block)."""

    def __init__(self, cfg: ArchConfig, dtype, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.norm1 = _frozen(init_norm(cfg.norm_kind, cfg.d_model, dtype, dev))
        self.attn = _frozen(attn_lib.init_gqa(
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.qkv_bias, dtype, generator,
        ))
        self.norm2 = _frozen(init_norm(cfg.norm_kind, cfg.d_model, dtype, dev))
        self.mlp = _frozen(init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, generator))


class TransformerLM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        if tuple(cfg.pattern) != ("attn",):
            raise NotImplementedError(
                f"{cfg.name}: block pattern {cfg.pattern} is not ported yet; "
                "the port serves dense attention-only decoders (pattern ('attn',))"
            )
        cfg.validate()
        self.cfg = cfg
        self.dtype = dtype
        self.device = require_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        c = cfg
        self.embed = nn.Parameter(
            dense_init((c.vocab_size, c.d_model), gen, in_axis=1, dtype=dtype),
            requires_grad=False,
        )
        self.layers = nn.ModuleList(_Block(c, dtype, gen) for _ in range(c.num_layers))
        self.final_norm = _frozen(init_norm(c.norm_kind, c.d_model, dtype, self.device))
        if not c.tie_embeddings:
            self.head = nn.Parameter(
                dense_init((c.d_model, c.vocab_size), gen, dtype=dtype),
                requires_grad=False,
            )
        task = {"head_bias": torch.zeros((c.num_tasks, c.vocab_size), dtype=dtype,
                                         device=self.device)}
        if c.norm_kind != "nonparam_ln":
            task["final_gain"] = torch.zeros((c.num_tasks, c.d_model), dtype=dtype,
                                             device=self.device)
        self.task = _frozen(task)

    # ----------------------------------------------------------------- embed
    def _embed(self, batch) -> torch.Tensor:
        # token ids come from untrusted callers: clamp an out-of-vocab id to
        # the nearest embedding row, as the JAX model's mode="clip" does
        # (torch indexing would raise, or read stray memory on CUDA)
        ids = batch["tokens"].clamp(0, self.cfg.vocab_size - 1)
        return F.embedding(ids, self.embed)

    def _task_rows(self, table: torch.Tensor, task_ids: torch.Tensor):
        # dead serving lanes carry the null task id num_tasks, one past the
        # table: clamp like the JAX model's _TAKE_MODE = "clip" (the gathered
        # rows only feed discarded dead-lane outputs)
        return table[task_ids.clamp(0, table.shape[0] - 1)]

    def _logits(self, x, batch) -> torch.Tensor:
        c = self.cfg
        x = apply_norm(c.norm_kind, x, self.final_norm or None)
        if "final_gain" in self.task and "task_ids" in batch:
            gain = self._task_rows(self.task["final_gain"], batch["task_ids"])
            x = x * (1.0 + gain[:, None, :].to(x.dtype))
        head = self.embed.t() if c.tie_embeddings else self.head
        logits = torch.matmul(x.float(), head.float())  # f32 logits, any dtype
        if "task_ids" in batch:
            hb = self._task_rows(self.task["head_bias"], batch["task_ids"])
            logits = logits + hb[:, None, :].float()
        return logits

    # ------------------------------------------------------------- caches
    def init_cache(self, batch_size: int, max_seq: int) -> list:
        """One (k, v) pair of zero (B, max_seq, KVH, hd) stripes per layer."""
        c = self.cfg
        shape = (batch_size, max_seq, c.num_kv_heads, c.head_dim)
        return [
            (torch.zeros(shape, dtype=self.dtype, device=self.device),
             torch.zeros(shape, dtype=self.dtype, device=self.device))
            for _ in range(c.num_layers)
        ]

    @torch.no_grad()
    def reset_slot_state(self, caches, reset):
        """Zero the K/V stripes of (re)admitted slots, in place, as the JAX
        model restores them to the ``init_cache`` value. reset: (B,) bool
        (host array or tensor). Only the reset rows are touched."""
        rows = np.flatnonzero(torch.as_tensor(reset).cpu().numpy())
        if rows.size == 0:
            return caches
        idx = torch.as_tensor(rows, device=self.device)
        for k_cache, v_cache in caches:
            k_cache.index_fill_(0, idx, 0)
            v_cache.index_fill_(0, idx, 0)
        return caches

    @staticmethod
    def _cache_write_slab(cache, new, pos, valid):
        """Write a (B, C) slab into the cache IN PLACE: chunk token i of slot
        b lands at row ``pos[b] + i`` when ``valid[b, i]`` and that row
        exists (0 <= pos[b] + i < S); every other lane writes nothing — a
        position past the cache is dropped, not clamped onto its last row.

        One gather + one ``index_put_``, no host sync: each lane targets row
        ``(pos[b] + i) mod S`` — C <= S consecutive integers, so the
        targets of one slot are distinct and the scatter has no collisions —
        and a lane that must not write stores the row's old value back.
        cache: (B, S, ...); new: (B, C, ...); pos: (B,); valid: (B, C)."""
        b, s = cache.shape[:2]
        c = new.shape[1]
        if c > s:
            raise ValueError(f"chunk of {c} tokens is wider than the cache ({s} rows)")
        tgt = pos[:, None].long() + torch.arange(c, device=cache.device)
        ok = valid & (tgt >= 0) & (tgt < s)
        rows = torch.arange(b, device=cache.device)[:, None].expand(b, c)
        idx = torch.remainder(tgt, s)
        old = cache[rows, idx]
        ok = ok.reshape(ok.shape + (1,) * (cache.ndim - 2))
        cache.index_put_((rows, idx), torch.where(ok, new.to(cache.dtype), old))
        return cache

    @classmethod
    def _cache_write(cls, cache, new, pos, live=None):
        """One token per slot, IN PLACE, at ``pos[b]``: the C == 1 case of
        ``_cache_write_slab``. Dead slots (``live == False``) write nothing."""
        if live is None:
            live = torch.ones(cache.shape[0], dtype=torch.bool, device=cache.device)
        return cls._cache_write_slab(cache, new, pos, live[:, None])

    # -------------------------------------------------------------- blocks
    def _make_attend(self, pos):
        c = self.cfg
        return lambda q, kc, vc: attn_lib.cached_attend(
            q, kc, vc, pos, sliding_window=c.sliding_window, backend=c.attn_backend,
        )

    def _attn_block(self, p: _Block, x, cache, pos, write, attend):
        """Project the chunk, write its K/V through ``write``, attend with
        per-query positions ``pos + i``, then the MLP. x: (B, C, d)."""
        c = self.cfg
        b, cl = x.shape[:2]
        q_pos = pos[:, None] + torch.arange(cl, device=x.device)[None, :]  # (B, C)
        h = apply_norm(c.norm_kind, x, p.norm1 or None)
        q, k, v = attn_lib.gqa_project(p.attn, h, c.num_heads, c.num_kv_heads, c.head_dim)
        q = apply_rope(q, q_pos, c.rope_theta)
        k = apply_rope(k, q_pos, c.rope_theta)
        k_cache, v_cache = cache
        write(k_cache, k)
        write(v_cache, v)
        o = attend(q, k_cache, v_cache)
        x = x + matmul(o.reshape(b, cl, c.num_heads * c.head_dim), p.attn["wo"])
        h = apply_norm(c.norm_kind, x, p.norm2 or None)
        return x + apply_mlp(p.mlp, h, c.mlp_kind)

    # ------------------------------------------------------------- serving
    @torch.no_grad()
    def decode_step(self, batch, caches, pos, live=None):
        """One-token decode. batch: {'tokens': (B, 1) [, 'task_ids': (B,)]};
        pos: () or (B,) per-slot positions; live: optional (B,) bool — dead
        slots run through the math on their padding token but their cache
        rows are left untouched. Returns (logits (B, 1, V) f32, caches)."""
        x = self._embed(batch)
        pos = pos_vector(pos, x.shape[0], x.device)
        attend = self._make_attend(pos)
        for p, cache in zip(self.layers, caches):
            x = self._attn_block(
                p, x, cache, pos,
                lambda cc, new: self._cache_write(cc, new, pos, live), attend,
            )
        return self._logits(x, batch), caches

    @torch.no_grad()
    def prefill_step(self, batch, caches, positions, valid):
        """Multi-token prefill: a whole (B, C) prompt chunk, all C tokens in
        parallel, against the caches at per-slot offsets. positions: (B,)
        position of each slot's first chunk token; valid: (B, C)
        contiguous-prefix mask of real prompt tokens (all-False rows ride
        along untouched). Returns (logits (B, 1, V) after each slot's LAST
        valid token, caches) — the lm head runs on one hidden state per slot
        (all-False rows give logits the caller discards)."""
        x = self._embed(batch)
        b = x.shape[0]
        pos = pos_vector(positions, b, x.device)
        attend = self._make_attend(pos)
        for p, cache in zip(self.layers, caches):
            x = self._attn_block(
                p, x, cache, pos,
                lambda cc, new: self._cache_write_slab(cc, new, pos, valid), attend,
            )
        idx = (valid.sum(dim=1) - 1).clamp(min=0)  # in [0, C-1]
        x_last = x[torch.arange(b, device=x.device), idx][:, None, :]  # (B, 1, d)
        return self._logits(x_last, batch), caches
