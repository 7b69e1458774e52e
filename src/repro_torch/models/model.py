"""Decoder LM for training and serving: ``repro.models.model.TransformerLM``
over any block pattern of its six kinds (``cfg.pattern``, cycled over the
depth: ``cfg.layer_kinds()``), over every input mode. A kind is a layer:
"attn" (attention + MLP), "attn_moe" (attention + mixture of experts), the
attention GQA or, with ``cfg.use_mla``, DeepSeek-V2's MLA; "shared_attn"
(the model's ONE shared attention + MLP block, Zamba2's); "mamba"
(Mamba2), "mlstm" and "slstm" (xLSTM). The shipped configs are dense
(``("attn",)``), MoE (``("attn_moe",)``), the Mamba2 hybrid (mamba layers
closed by "shared_attn") and xLSTM; a mixed stack (``("attn",
"attn_moe")``, ``("mamba", "attn", "shared_attn")``, ...) runs the same
per-kind blocks layer by layer.

Input modes (``cfg.input_mode``), as the reference's:
  * ``"tokens"`` — ``batch["tokens"]`` (B, S) ids.
  * ``"vlm"`` (Pixtral) — (B, S) ids, and ``batch["vision_embeds"]`` (B, S,
    d_model) with ``batch["vision_mask"]`` (B, S) bool: a masked position
    takes its vision embedding (cast to the model's dtype) in place of its
    token's. A batch without them is text only (a decode step past the
    prompt, or a text-only request).
  * ``"audio"`` (MusicGen) — (B, S, K) ids of K = ``num_codebooks``
    codebooks; ``embed`` is (K, V, d) and a position's input is the sum of
    its K codebook embeddings; ``head`` is (d, V * K) and the logits come
    out as (B, S, K, V); ``task.head_bias`` is (num_tasks, V * K). On
    DTensors (the tensor-parallel steps) they stay (B, S, K * V), their
    vocab split over the model ranks, and ``loss_fn`` reduces each
    codebook's columns where they lie.

The JAX model keeps period-stacked (P, ...) params and ``lax.scan``s over
them; here each layer is its own module and the stack is a Python loop over
``cfg.layer_kinds()``. A hybrid's "shared_attn" positions hold no weights of
their own: every one of them runs the ONE ``shared_attn`` block (attention
+ MLP), as the reference closes over ``params["shared_attn"]``. Weights
come from a seeded ``torch.Generator`` on the model's device (the JAX
package's ``dense_init`` law, other random numbers) or from the JAX params
through ``repro_torch.convert``. On ``device="meta"`` every weight (and
``init_cache``'s and an optimizer's state) is a shape and a dtype with no
storage and nothing drawn: the sharding rules read full-size models so.

Every weight is a trainable ``nn.Parameter``. Training entry points,
counterparts of the JAX ones:
  * ``forward``  — full-sequence logits (B, S, V) float32 ((B, S, K, V)
    for audio) and the MoE aux loss (summed over the layers; 0 for a dense
    model), each layer rematerialized in the backward when ``cfg.remat``
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``); an
    mLSTM layer runs the chunkwise-parallel form under
    ``cfg.xlstm_parallel``.
  * ``loss_fn``  — softmax cross-entropy (+ ``aux_weight`` * aux) and its
    metrics; audio labels are (B, S, K).

Serving entry points, counterparts of the JAX ones, all under
``torch.no_grad()``:
  * ``init_cache`` / ``reset_slot_state`` — one entry per layer: for an
    attention layer (each shared-attention invocation has its own) a (k, v)
    pair of dense per-slot stripes (B, max_seq, KVH, hd), or, given a
    ``PagingSpec``, shared pools (num_blocks, block_size, KVH, hd) that
    slots address through a (B, max_blocks) block table (MLA: a (c_kv,
    k_rope) pair of (…, kv_lora) and (…, qk_rope) stripes or pools); for a
    recurrent layer its state, dense per slot under paging too: mamba
    (conv_tail, ssm), mLSTM (C, n, m), sLSTM (c, n, h, m).
  * ``decode_step``  — one token per slot against the caches at ``pos``.
  * ``prefill_step`` — a (B, C) prompt chunk, all C tokens in parallel.
  Both take ``block_tables=`` for the paged pools.

Both steps update the caches IN PLACE (and return them, as the JAX
functions return new ones): K/V rows by masked scatters, recurrent states
by masked copies into their own storage. Dead decode lanes (``live``) and
invalid prefill lanes (``valid``) leave their cache rows and recurrent
states untouched, and in an MoE layer take no expert capacity. Multi-task
personalization lives in ``self.task``: per-task final-norm gain
(parametric norms only), lm-head bias and, for MoE models, router bias,
gathered by each row's task id. Both steps also take ``adapters=``,
the graph-mixed serving tree of ``repro_torch.serve.adapters.
TaskAdapterStore``: each row's low-rank deltas are gathered by task id and
added to the attention and MLP (or MoE) branches of every attention layer
(each shared-attention invocation has its own) and after the mixer of
every recurrent layer, and its per-task gain, head-bias and router-bias
deltas to ``self.task``'s.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import (
    gather_pages,
    pos_vector,
    require_device,
    resolve_attn_backend,
)
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    apply_task_lora,
    dense_init,
    freeze_dead_slots,
    init_mlp,
    init_norm,
    matmul,
)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.sharding import tensor_parallel as tp


ATTN_KINDS = ("attn", "attn_moe", "shared_attn")
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _params(v) if isinstance(v, dict) else nn.Parameter(v) for k, v in tensors.items()
    })


def _mla_dims(cfg: ArchConfig) -> attn_lib.MLADims:
    return attn_lib.MLADims(cfg.num_heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head_dim,
                            cfg.kv_lora)


class _Block(nn.Module):
    """One attention layer of ``kind``, as the reference's ``_init_block``
    builds it: attention + MoE for "attn_moe", attention + MLP for "attn"
    and "shared_attn" (the shared block has an MLP in an MoE model too);
    the attention is GQA, or MLA with ``cfg.use_mla``."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype, generator: torch.Generator):
        super().__init__()
        self.kind = kind
        dev = generator.device
        self.norm1 = _params(init_norm(cfg.norm_kind, cfg.d_model, dtype, dev))
        if cfg.use_mla:
            attn = attn_lib.init_mla(cfg.d_model, _mla_dims(cfg), dtype, generator)
        else:
            attn = attn_lib.init_gqa(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.head_dim, cfg.qkv_bias, dtype, generator)
        self.attn = _params(attn)
        self.norm2 = _params(init_norm(cfg.norm_kind, cfg.d_model, dtype, dev))
        if kind == "attn_moe":
            self.moe = _params(init_moe(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                        cfg.num_shared_experts, dtype, generator))
        else:
            self.mlp = _params(init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, generator))


class _RecurrentBlock(nn.Module):
    """One recurrent layer (the JAX model's "mamba", "mlstm" and "slstm"
    blocks): a norm, then the mixer, added to the residual. The mixer's
    weights sit under the kind's name ("layers.3.mlstm.wq"); xLSTM's are
    float32 whatever the model's dtype, as the reference's."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype, generator: torch.Generator):
        super().__init__()
        self.norm = _params(init_norm(cfg.norm_kind, cfg.d_model, dtype, generator.device))
        if kind == "mamba":
            mixer = mamba_lib.init_mamba2(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                                          dtype, generator)
        elif kind == "mlstm":
            mixer = xlstm_lib.init_mlstm(cfg.d_model, cfg.num_heads, generator)
        else:
            mixer = xlstm_lib.init_slstm(cfg.d_model, cfg.num_heads, generator)
        setattr(self, kind, _params(mixer))


class _FactoriesOnMeta(TorchFunctionMode):
    """Every tensor factory called inside puts its tensor on ``meta``: a
    shape and a dtype, no storage and no random draw (the model's meta
    path, the counterpart of ``jax.eval_shape(model.init)``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


class _Shared(nn.Module):
    """A shared-attention position of the stack: no weights of its own (the
    model's one ``shared_attn`` block serves it)."""


class TransformerLM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.dtype = dtype
        self.device = require_device(device)
        meta = self.device.type == "meta"
        gen = torch.Generator(device="cpu" if meta else self.device).manual_seed(seed)
        with _FactoriesOnMeta() if meta else contextlib.nullcontext():
            self._init_weights(gen)

    def _init_weights(self, gen: torch.Generator):
        c, dtype = self.cfg, self.dtype
        v_total = c.vocab_size * c.num_codebooks
        if c.input_mode == "audio":  # one table per codebook
            embed = dense_init((c.num_codebooks, c.vocab_size, c.d_model), gen, in_axis=2,
                               dtype=dtype)
        else:
            embed = dense_init((c.vocab_size, c.d_model), gen, in_axis=1, dtype=dtype)
        self.embed = nn.Parameter(embed)
        self.kinds = c.layer_kinds()

        def block(kind):
            if kind in RECURRENT_KINDS:
                return _RecurrentBlock(c, kind, dtype, gen)
            return _Shared() if kind == "shared_attn" else _Block(c, kind, dtype, gen)

        self.layers = nn.ModuleList(block(kind) for kind in self.kinds)
        if "shared_attn" in self.kinds:
            self.shared_attn = _Block(c, "shared_attn", dtype, gen)
        self.final_norm = _params(init_norm(c.norm_kind, c.d_model, dtype, self.device))
        if not c.tie_embeddings:
            self.head = nn.Parameter(dense_init((c.d_model, v_total), gen, dtype=dtype))
        task = {"head_bias": torch.zeros((c.num_tasks, v_total), dtype=dtype,
                                         device=self.device)}
        if c.norm_kind != "nonparam_ln":
            task["final_gain"] = torch.zeros((c.num_tasks, c.d_model), dtype=dtype,
                                             device=self.device)
        if c.uses_moe:
            task["router_bias"] = torch.zeros((c.num_tasks, c.num_experts), dtype=dtype,
                                              device=self.device)
        self.task = _params(task)

    # ----------------------------------------------------------------- embed
    def _embed(self, batch) -> torch.Tensor:
        """The input embeddings (B, S, d) of the batch's input mode (see
        the module docstring)."""
        c = self.cfg
        # token ids come from untrusted callers: clamp an out-of-vocab id to
        # the nearest embedding row, as the JAX model's mode="clip" does
        # (torch indexing would raise, or read stray memory on CUDA)
        ids = batch["tokens"].clamp(0, c.vocab_size - 1)
        # audio: (B, S, K) ids into the (K, V, d) tables, the codebooks'
        # embeddings summed
        x = tp.embedding(ids, self.embed)
        if c.input_mode == "vlm" and "vision_mask" in batch:
            # on DTensors the lookup's partial sums are reduce-scattered
            # over d first, and the vision rows take that layout: the
            # select then runs on each rank's own columns
            x = tp.settle(x)
            x = torch.where(tp.match(batch["vision_mask"], x)[..., None],
                            tp.match(batch["vision_embeds"].to(x.dtype), x), x)
        return x

    def _task_rows(self, table: torch.Tensor, task_ids: torch.Tensor):
        # dead serving lanes carry the null task id num_tasks, one past the
        # table: clamp like the JAX model's _TAKE_MODE = "clip" (the gathered
        # rows only feed discarded dead-lane outputs)
        idx = task_ids.clamp(0, table.shape[0] - 1)
        return tp.embedding(idx, table) if tp.is_dtensor(table) else table[idx]

    def _router_bias(self, batch, seq: int, task_ad=None):
        """Each row's per-task router bias (plus its adapter delta),
        broadcast over ``seq`` tokens: (B, seq, E), or None for a dense
        model or a batch without task ids."""
        if not self.cfg.uses_moe or "task_ids" not in batch:
            return None
        bias = self._task_rows(self.task["router_bias"], batch["task_ids"])
        if task_ad is not None and "router_bias" in task_ad:
            bias = bias + task_ad["router_bias"].to(bias.dtype)
        return bias[:, None, :].expand(bias.shape[0], seq, bias.shape[1])

    def _ffn(self, p: _Block, h, router_bias, live=None):
        """The layer's feed-forward branch by its kind: (out, aux) — an
        "attn_moe" layer's MoE with its load-balance loss (the router bias
        and the live mask go to it alone), or the MLP and a zero aux."""
        c = self.cfg
        if p.kind == "attn_moe":
            return apply_moe(p.moe, h, top_k=c.top_k, capacity_factor=c.capacity_factor,
                             router_bias=router_bias, groups=c.moe_groups,
                             fsdp_gather=c.fsdp_gather_moe, live=live)
        return apply_mlp(p.mlp, h, c.mlp_kind), torch.zeros((), device=h.device)

    def _logits(self, x, batch, task_ad=None) -> torch.Tensor:
        """task_ad: optional per-row adapter deltas (``_gather_adapters``),
        added to the gathered final-norm gain and head bias."""
        c = self.cfg
        x = apply_norm(c.norm_kind, x, self.final_norm or None)
        if "final_gain" in self.task and "task_ids" in batch:
            gain = self._task_rows(self.task["final_gain"], batch["task_ids"])
            if task_ad is not None and "final_gain" in task_ad:
                gain = gain + task_ad["final_gain"].to(gain.dtype)
            x = x * (1.0 + gain[:, None, :].to(x.dtype))
        head = self.embed.t() if c.tie_embeddings else self.head
        # f32 logits, any dtype
        logits = torch.matmul(tp.tp_input(x, head).float(), head.float())
        if "task_ids" in batch:
            hb = self._task_rows(self.task["head_bias"], batch["task_ids"])
            if task_ad is not None and "head_bias" in task_ad:
                hb = hb + task_ad["head_bias"].to(hb.dtype)
            logits = logits + hb[:, None, :].float()
        logits = tp.constrain(logits, c.logits_sharding)
        # (B, S, K * V) -> (B, S, K, V); a DTensor's stay flat: a vocab
        # split over model ranks that K does not divide cannot follow the
        # reshape without a gather (the loss reduces each codebook's
        # columns where they lie, ``tp.logsumexp``)
        if c.num_codebooks > 1 and not tp.is_dtensor(logits):
            logits = logits.reshape(logits.shape[:2] + (c.num_codebooks, c.vocab_size))
        return logits

    def _gather_adapters(self, adapters, task_ids):
        """Per-row multi-LoRA gather for one dispatch: each batch row's
        adapters from the serving tree (stage leaves (num_tasks + 1, P, ...),
        the last row the zero null row that dead lanes carry). Ids are
        clamped to the tree, as the JAX model's mode="clip" does, so a
        corrupted id reads some task's adapters and never stray memory.
        Returns (one dict of (B, ...) factors per layer — {"attn", "mlp"}
        for an attention position, {"out"} for a recurrent one — the (B,
        ...) task deltas)."""
        stages = adapters["stages"]
        layout = self.cfg.stages()
        want = [sorted(f"slot{j}" for j in range(len(kinds))) for kinds, _, _ in layout]
        if [sorted(stage) for stage in stages] != want:
            raise ValueError(
                f"adapters: want the model's stage layout {want} "
                "({'stages': [{'slot0': ...}, ...], 'task': ...})"
            )

        def take(t):
            return t[task_ids.long().clamp(0, t.shape[0] - 1)]

        gathered = [tree_lib.map_(take, stage) for stage in stages]  # leaves (B, P, ...)
        # layer order: stage by stage, repetition i, slot j (cfg.stages())
        layers = [tree_lib.map_(lambda t, i=i: t[:, i], stage[f"slot{j}"])
                  for stage, (kinds, reps, _) in zip(gathered, layout)
                  for i in range(reps) for j in range(len(kinds))]
        return layers, tree_lib.map_(take, adapters["task"])

    # ------------------------------------------------------------ training
    def _block_full(self, p: _Block, x, positions, router_bias):
        """One layer over the whole sequence: the reference's
        ``_block_full`` "attn" / "attn_moe" branch, causal attention
        through ``causal_attend`` (MLA: ``mla_full``). x: (B, S, d);
        positions: (B, S); router_bias: (B, S, E) or None. Returns (x,
        aux)."""
        c = self.cfg
        b, s = x.shape[:2]
        h = apply_norm(c.norm_kind, x, p.norm1 or None)
        if c.use_mla:
            out, _ = attn_lib.mla_full(p.attn, h, _mla_dims(c), positions, c.rope_theta,
                                       q_chunk=c.q_chunk)
        else:
            q, k, v = attn_lib.gqa_project(p.attn, h, c.num_heads, c.num_kv_heads,
                                           c.head_dim)
            q = apply_rope(q, positions, c.rope_theta)
            k = apply_rope(k, positions, c.rope_theta)
            o = tp.attention(lambda q, k, v, start: attn_lib.causal_attend(
                q, k, v, sliding_window=c.sliding_window, q_chunk=c.q_chunk, q_start=start),
                q, k, v)
            out = matmul(o.reshape(b, s, c.num_heads * c.head_dim), p.attn["wo"])
        x = x + out
        h = apply_norm(c.norm_kind, x, p.norm2 or None)
        ff, aux = self._ffn(p, h, router_bias)
        return x + ff, aux

    def _recurrent_full(self, kind: str, p: _RecurrentBlock, x):
        """One recurrent layer over the whole sequence from a fresh state
        (the reference's ``_block_full`` "mamba" / "mlstm" / "slstm"
        branches; the xLSTM time loop rematerialized in ``xlstm_chunk``
        chunks, or the mLSTM chunkwise-parallel under ``xlstm_parallel``).
        Returns (x, 0 aux)."""
        c = self.cfg
        h = apply_norm(c.norm_kind, x, p.norm or None)
        if kind == "mamba":
            out, _ = mamba_lib.mamba2_full(p.mamba, h, d_state=c.ssm_state,
                                           head_dim=c.ssm_head_dim, chunk=c.mamba_chunk)
        elif kind == "mlstm" and c.xlstm_parallel:
            out, _ = xlstm_lib.mlstm_chunkwise(p.mlstm, h, n_heads=c.num_heads,
                                               chunk=c.xlstm_chunk or 64)
        elif kind == "mlstm":
            out, _ = xlstm_lib.mlstm_full(p.mlstm, h, n_heads=c.num_heads,
                                          chunk=c.xlstm_chunk)
        else:
            out, _ = xlstm_lib.slstm_full(p.slstm, h, n_heads=c.num_heads,
                                          chunk=c.xlstm_chunk)
        return x + out, torch.zeros((), device=x.device)

    def _constrain(self, x):
        """The reference's ``_constrain``: the residual stream in the
        placements of ``cfg.activation_sharding`` (``tp.constrain``; a
        no-op on plain tensors)."""
        return tp.constrain(x, self.cfg.activation_sharding)

    def _period_ends(self) -> set[int]:
        """The layers that close a period of their stage, where the
        reference's scanned body ends and constrains its carry."""
        return {first + len(kinds) * (r + 1) - 1
                for kinds, reps, first in self.cfg.stages() for r in range(reps)}

    def forward(self, batch):
        """Training/eval forward. batch: {'tokens': (B, S) ((B, S, K) for
        audio) [, 'task_ids': (B,)] [, 'vision_embeds', 'vision_mask' for a
        VLM]}. Returns (logits (B, S, V) ((B, S, K, V) for audio) float32,
        aux loss () float32: the MoE layers' load-balance losses summed, 0
        for a dense model). With
        ``cfg.remat`` and grad enabled each layer keeps only its input for
        the backward and recomputes the rest. The residual stream is
        constrained after the embedding and at each period's end, as in the
        reference."""
        x = self._constrain(self._embed(batch))
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        rb = self._router_bias(batch, s)
        remat = self.cfg.remat and torch.is_grad_enabled()
        ends = self._period_ends()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (kind, p) in enumerate(zip(self.kinds, self.layers)):
            if kind in RECURRENT_KINDS:
                fn, args = self._recurrent_full, (kind, p, x)
            else:
                p = self.shared_attn if kind == "shared_attn" else p
                fn, args = self._block_full, (p, x, positions, rb)
            if remat:
                x, a = checkpoint(fn, *args, use_reentrant=False)
            else:
                x, a = fn(*args)
            if i in ends:
                x = self._constrain(x)
            aux = aux + a
        return self._logits(x, batch), aux

    def loss_fn(self, batch, aux_weight: float = 0.01):
        """Mean softmax cross-entropy of ``batch['labels']`` (B, S) ((B, S,
        K) for audio: the mean over every codebook's label), plus
        ``aux_weight`` * aux. The label logit is the reference's masked
        reduction over the vocab (``tp.label_logits``), never a gather, so
        vocab-sharded logits stay sharded: a label outside [0, V) matches no
        entry and contributes 0 (it is not clamped). Returns (loss, {'nll',
        'aux'})."""
        logits, aux = self.forward(batch)
        labels = batch["labels"].long()
        groups = self.cfg.num_codebooks if logits.ndim == labels.ndim else 1  # flat (B, S, K V)
        nll = tp.reduced((tp.logsumexp(logits, groups)
                          - tp.label_logits(logits, labels, groups)).mean())
        aux = tp.reduced(aux)
        return nll + aux_weight * aux, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------- caches
    def _cache_spec(self, kind: str, batch_size: int, max_seq: int, paging=None):
        """(shape, dtype, init value) of each tensor of one layer's cache
        entry: ``init_cache`` fills them and ``reset_slot_state`` restores
        the value. Attention: (k, v) — MLA: (c_kv, k_rope) — dense stripes
        or, with ``paging``, shared pools. Recurrent states are dense per
        slot always: mamba (conv_tail, ssm) with the SSM state in float32;
        mLSTM (C, n, m) and sLSTM (c, n, h, m) in float32, the mLSTM
        stabilizer m starting at -1e30."""
        c = self.cfg
        b = batch_size
        if kind in ATTN_KINDS:
            lead = ((paging.num_blocks, paging.block_size) if paging is not None
                    else (b, max_seq))
            if c.use_mla:
                return [(lead + (c.kv_lora,), self.dtype, 0.0),
                        (lead + (c.qk_rope,), self.dtype, 0.0)]
            shape = lead + (c.num_kv_heads, c.head_dim)
            return [(shape, self.dtype, 0.0)] * 2
        nh, f32 = c.num_heads, torch.float32
        if kind == "mlstm":
            _, hd = xlstm_lib.mlstm_dims(c.d_model, nh)
            return [((b, nh, hd, hd), f32, 0.0), ((b, nh, hd), f32, 0.0),
                    ((b, nh), f32, xlstm_lib.M_INIT)]
        if kind == "slstm":
            hd = c.d_model // nh
            return [((b, nh, hd), f32, 0.0)] * 3 + [((b, nh), f32, 0.0)]
        _, mnh, conv_dim = mamba_lib.dims(c.d_model, c.ssm_state, c.ssm_head_dim)
        return [((b, mamba_lib.CONV_K - 1, conv_dim), self.dtype, 0.0),
                ((b, mnh, c.ssm_head_dim, c.ssm_state), f32, 0.0)]

    def init_cache(self, batch_size: int, max_seq: int, paging=None) -> list:
        """One entry per layer, filled with its init value: a (k, v) pair of
        dense (B, max_seq, KVH, hd) stripes, or with ``paging`` (a
        ``repro_torch.serve.paging.PagingSpec``) of shared (num_blocks,
        block_size, KVH, hd) pools, per attention layer (MLA: (c_kv,
        k_rope), (…, kv_lora) and (…, qk_rope)); the recurrent state of
        each mamba, mLSTM or sLSTM layer (``_cache_spec``)."""
        return [
            tuple(torch.full(shape, fill, dtype=dtype, device=self.device)
                  for shape, dtype, fill in self._cache_spec(kind, batch_size, max_seq, paging))
            for kind in self.kinds
        ]

    @torch.no_grad()
    def reset_slot_state(self, caches, reset, paging=None):
        """Restore the per-slot cache entries of (re)admitted slots to their
        ``init_cache`` value, in place, as the JAX model does: recurrent
        states are cumulative and must be cleared on slot reuse, and dense
        K/V stripes are cleared too. reset: (B,) bool (host array or
        tensor). Only the reset rows are touched.

        It reads ``reset`` on the host and uploads the row ids, so it runs
        eagerly, never inside a captured CUDA graph: the serving executor
        (``repro_torch.serve.step.StepExecutor``) calls it before a prefill
        replay, only on dispatches that admit a slot.

        Paged attention pools (``paging`` given) are skipped, as in JAX: a
        new request rewrites every position it can read and reads are masked
        by ``kv_idx <= pos``, so stale bytes in recycled blocks are never
        seen. A hybrid's recurrent states stay per slot under paging and are
        reset all the same."""
        rows = np.flatnonzero(torch.as_tensor(reset).cpu().numpy())
        per_slot = [(kind, entry) for kind, entry in zip(self.kinds, caches)
                    if paging is None or kind not in ATTN_KINDS]
        if rows.size == 0 or not per_slot:
            return caches
        idx = torch.as_tensor(rows, device=self.device)
        for kind, entry in per_slot:
            for t, (_, _, fill) in zip(entry, self._cache_spec(kind, 1, 1)):
                # analysis: ignore[R001] -- rows of the (B,) reset mask: in [0, B) by construction
                t.index_fill_(0, idx, fill)
        return caches

    @staticmethod
    def _cache_write_slab(cache, new, pos, valid):
        """Write a (B, C) slab into the cache IN PLACE: chunk token i of slot
        b lands at row ``pos[b] + i`` when ``valid[b, i]`` and that row
        exists (0 <= pos[b] + i < S); every other lane writes nothing — a
        position past the cache is dropped, not clamped onto its last row. A
        DTensor cache is written on each rank's own rows (``tp.cache_write``).

        One gather + one ``index_put_``, no host sync: each lane targets row
        ``(pos[b] + i) mod S`` — C <= S consecutive integers, so the
        targets of one slot are distinct and the scatter has no collisions —
        and a lane that must not write stores the row's old value back.
        cache: (B, S, ...); new: (B, C, ...); pos: (B,); valid: (B, C)."""
        if tp.is_dtensor(cache):
            return tp.cache_write(TransformerLM._cache_write_slab, cache, new, pos, valid)
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
    def _make_attend(self, pos, block_tables=None):
        """The GQA attention of one dispatch, on the backend that
        ``resolve_attn_backend`` gives the configured one (MLA layers never
        call it: they attend in ``_attn_block`` over the latent caches)."""
        c = self.cfg
        backend = resolve_attn_backend(c.attn_backend, mla=c.use_mla)
        return lambda q, kc, vc: attn_lib.cached_attend(
            q, kc, vc, pos, sliding_window=c.sliding_window, backend=backend,
            block_tables=block_tables,
        )

    def _attn_block(self, p: _Block, x, cache, pos, write, attend, router_bias, moe_live,
                    ad=None, view=None):
        """Project the chunk, write its K/V through ``write``, attend with
        per-query positions ``pos + i``, then the MLP or MoE. x: (B, C, d);
        router_bias: (B, C, E) or None; moe_live: the (B,) live or (B, C)
        valid mask that keeps dead lanes out of the experts' capacity; ad:
        optional per-row adapter factors of this layer, whose deltas are
        added to both branches off the same normed inputs. An MLA layer
        writes the chunk's latent and roped shared key, and runs
        ``mla_decode`` over ``view`` of its caches (a paged pool's
        ``gather_pages`` view)."""
        c = self.cfg
        b, cl = x.shape[:2]
        q_pos = pos[:, None] + torch.arange(cl, device=x.device)[None, :]  # (B, C)
        h = apply_norm(c.norm_kind, x, p.norm1 or None)
        if c.use_mla:
            c_cache, r_cache = cache
            c_kv = matmul(h, p.attn["w_dkv"])  # (B, C, r)
            k_rope = apply_rope(tp.whole(matmul(h, p.attn["w_krope"]), -1)[:, :, None, :],
                                q_pos, c.rope_theta)[:, :, 0, :]  # rotated whole
            write(c_cache, c_kv)
            write(r_cache, k_rope)
            out = attn_lib.mla_decode(p.attn, h, _mla_dims(c), view(c_cache), view(r_cache),
                                      pos, c.rope_theta)
        else:
            q, k, v = attn_lib.gqa_project(p.attn, h, c.num_heads, c.num_kv_heads,
                                           c.head_dim)
            q = apply_rope(q, q_pos, c.rope_theta)
            k = apply_rope(k, q_pos, c.rope_theta)
            k_cache, v_cache = cache
            write(k_cache, k)
            write(v_cache, v)
            o = attend(q, k_cache, v_cache)
            out = matmul(o.reshape(b, cl, c.num_heads * c.head_dim), p.attn["wo"])
        if ad is not None:
            out = out + apply_task_lora(h, ad["attn"])
        x = x + out
        h = apply_norm(c.norm_kind, x, p.norm2 or None)
        ff, _ = self._ffn(p, h, router_bias, moe_live)
        if ad is not None:
            ff = ff + apply_task_lora(h, ad["mlp"])
        return x + ff

    def _run_layers(self, x, caches, pos, write, view, attend, batch, adapters, moe_live,
                    recurrent):
        """The layer loop of both steps, with each layer's adapters when
        given: attention layers through ``_attn_block`` (shared positions
        with the shared block), recurrent layers through ``recurrent(kind,
        params, h, cache)``, which returns the mixer's output and updates
        the cache entry in place; the layer's "out" adapter delta is added
        after the mixer, off the same normed input. Returns (x, per-row
        task deltas or None)."""
        if adapters is None:
            layer_ads, task_ad = [None] * len(self.layers), None
        else:
            layer_ads, task_ad = self._gather_adapters(adapters, batch["task_ids"])
        rb = self._router_bias(batch, x.shape[1], task_ad)
        c = self.cfg
        for kind, p, cache, ad in zip(self.kinds, self.layers, caches, layer_ads):
            if kind in RECURRENT_KINDS:
                h = apply_norm(c.norm_kind, x, p.norm or None)
                out = recurrent(kind, getattr(p, kind), h, cache)
                if ad is not None:
                    out = out + apply_task_lora(h, ad["out"])
                x = x + out
                continue
            p = self.shared_attn if kind == "shared_attn" else p
            x = self._attn_block(p, x, cache, pos, write, attend, rb, moe_live, ad, view)
        return x, task_ad

    @staticmethod
    def _view(block_tables):
        """How an MLA layer reads its caches: as they are (dense), or each
        slot's ``gather_pages`` view of a pool."""
        if block_tables is None:
            return lambda cc: cc
        return lambda cc: gather_pages(cc, block_tables)

    # ------------------------------------------------------------- serving
    @torch.no_grad()
    def decode_step(self, batch, caches, pos, live=None, block_tables=None,
                    adapters=None):
        """One-token decode. batch: {'tokens': (B, 1) ((B, 1, K) for audio)
        [, 'task_ids': (B,)] [, a VLM's 'vision_embeds' (B, 1, d) and
        'vision_mask' (B, 1): without them the step is text only]};
        pos: () or (B,) per-slot positions; live: optional (B,) bool — dead
        slots run through the math on their padding token but their cache
        rows are left untouched (paged: their write goes to the null block
        0; a recurrent layer's state keeps its rows). block_tables: optional
        (B, max_blocks) int32 — the attention caches are then the shared
        pools of ``init_cache(..., paging=spec)`` (recurrent states stay
        dense and ignore the table). adapters: optional serving tree of a
        ``TaskAdapterStore`` (needs ``batch['task_ids']``). Returns (logits
        (B, 1, V) f32 ((B, 1, K, V) for audio), caches)."""
        x = self._constrain(self._embed(batch))
        pos = pos_vector(pos, x.shape[0], x.device)
        attend = self._make_attend(pos, block_tables)
        if block_tables is None:
            def write(cc, new):
                self._cache_write(cc, new, pos, live)
        else:
            def write(cc, new):
                attn_lib.paged_cache_write(cc, new, pos, block_tables, live)
        c = self.cfg

        def recurrent(kind, p, h, cache):
            if kind == "mamba":
                return mamba_lib.mamba2_step(p, h, cache, d_state=c.ssm_state,
                                             head_dim=c.ssm_head_dim, live=live)[0]
            step = xlstm_lib.mlstm_step if kind == "mlstm" else xlstm_lib.slstm_step
            return step(p, h, cache, n_heads=c.num_heads, live=live)[0]

        x, task_ad = self._run_layers(x, caches, pos, write, self._view(block_tables),
                                      attend, batch, adapters, live, recurrent)
        return self._logits(x, batch, task_ad), caches

    @torch.no_grad()
    def prefill_step(self, batch, caches, positions, valid, block_tables=None,
                     adapters=None):
        """Multi-token prefill: a whole (B, C) prompt chunk ((B, C, K) for
        audio; a VLM chunk may carry its (B, C, d) 'vision_embeds' and (B,
        C) 'vision_mask'), all C tokens in parallel, against the caches at
        per-slot offsets. positions: (B,)
        position of each slot's first chunk token; valid: (B, C)
        contiguous-prefix mask of real prompt tokens (all-False rows ride
        along untouched; paged, their lanes write the null block 0); a
        recurrent layer runs with the slot's state threaded in.
        block_tables: optional (B, max_blocks) int32 for paged pools.
        adapters: optional serving tree, as in ``decode_step``. Returns
        (logits (B, 1, V) ((B, 1, K, V) for audio) after each slot's LAST
        valid token, caches) — the
        lm head runs on one hidden state per slot (all-False rows give
        logits the caller discards)."""
        x = self._constrain(self._embed(batch))
        b = x.shape[0]
        pos = pos_vector(positions, b, x.device)
        attend = self._make_attend(pos, block_tables)
        if block_tables is None:
            def write(cc, new):
                self._cache_write_slab(cc, new, pos, valid)
        else:
            def write(cc, new):
                attn_lib.paged_cache_write_slab(cc, new, pos, block_tables, valid)
        c = self.cfg

        def recurrent(kind, p, h, cache):
            # the state threaded in; a row with no valid token gets its state
            # back bit for bit, so the copy leaves it untouched. xLSTM runs
            # the exact sequential cell, as the reference's prefill does
            # whatever cfg.xlstm_parallel says
            if kind == "mamba":
                out, state = mamba_lib.mamba2_full(p, h, d_state=c.ssm_state,
                                                   head_dim=c.ssm_head_dim,
                                                   chunk=c.mamba_chunk, state=cache,
                                                   valid=valid)
            else:
                full = xlstm_lib.mlstm_full if kind == "mlstm" else xlstm_lib.slstm_full
                out, state = full(p, h, n_heads=c.num_heads, chunk=c.xlstm_chunk,
                                  state=cache, valid=valid)
            freeze_dead_slots(state, cache, None)
            return out

        x, task_ad = self._run_layers(x, caches, pos, write, self._view(block_tables),
                                      attend, batch, adapters, valid, recurrent)
        idx = (valid.sum(dim=1) - 1).clamp(min=0)  # in [0, C-1]
        x_last = x[torch.arange(b, device=x.device), idx][:, None, :]  # (B, 1, d)
        return self._logits(x_last, batch, task_ad), caches
