"""Architecture config schema + registry of the port.

The port's own copy of the fields of ``repro.configs.base.ArchConfig`` that
its serving and training paths read, with the same values per architecture:
every block kind (dense and mixture-of-experts attention, GQA or MLA,
Mamba2, mLSTM, sLSTM), the input modes (token ids; a VLM's token ids with
precomputed vision embeddings; an audio model's codebook tokens), the
chunkwise-parallel mLSTM, and ``num_tasks``, ``adapter_rank``, ``q_chunk``
and ``remat``, and the sharding fields: ``mla_replicate_cache`` and
``mla_cache_seq_shard``, which the sharding rules
(``repro_torch.sharding.rules.cache_specs``) read, and the reference's
in-forward constraints ``fsdp_gather_moe``, ``activation_sharding`` and
``logits_sharding``, which the model reads when its tensors are DTensors
(``repro_torch.sharding.dtensor.sharded_step``): the residual stream and
the logits are redistributed to the given ``Spec`` entries, and the MoE's
expert weights are regathered with only their ff dim on the model axis.
On plain tensors, and when left at None / False (the reference's
defaults), they do nothing. ``unroll`` and ``long_context_ok`` are left
out: no port path reads them. The backend
flag ``attn_backend`` is the port's, and it selects every hand-written
kernel, not only attention's: ``"kernel"`` serves attention from the CUDA
attention kernels and mixes task adapters (``repro_torch.serve.adapters``)
with the CUDA graph-mix kernel; ``"plain"`` runs the plain PyTorch version
of each (the masked-softmax attention that plays the role of the JAX
package's ``"jnp"``, and the einsum graph mix). ``get(name, smoke=)``
resolves either variant of all twelve of the reference's architectures;
``multitask_linreg`` resolves to the paper's own workload, a
``LinRegConfig`` (``repro_torch.configs.multitask_linreg``).
"""
from __future__ import annotations

import dataclasses
import importlib

ATTN_BACKENDS = ("kernel", "plain")
BLOCK_KINDS = ("attn", "attn_moe", "shared_attn", "mamba", "mlstm", "slstm")
INPUT_MODES = ("tokens", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    pattern: tuple[str, ...] = ("attn",)
    mlp_kind: str = "swiglu"
    norm_kind: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int | None = None
    tie_embeddings: bool = False
    # MLA (DeepSeek-V2; repro_torch.models.attention): the latent K/V width,
    # the per-head non-rotary and the shared rotary query/key widths, the
    # value head width
    use_mla: bool = False
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head_dim: int = 128
    # Mamba2 (pattern kind "mamba"; repro_torch.models.mamba2): SSM state
    # width and head dim of its heads
    ssm_state: int = 0
    ssm_head_dim: int = 64
    # mixture of experts (pattern "attn_moe"; repro_torch.models.moe)
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # dispatch groups: the tokens of a dispatch are routed in this many
    # equal groups, each with its own capacity
    moe_groups: int = 1
    # inputs: "tokens" (B, S) ids; "vlm" ids plus (B, S, d_model)
    # vision_embeds that replace the embedding where (B, S) vision_mask is
    # True; "audio" (B, S, num_codebooks) ids, one embedding table and one
    # head block per codebook, logits (B, S, num_codebooks, vocab_size)
    input_mode: str = "tokens"
    num_codebooks: int = 1
    num_tasks: int = 16
    # default low-rank width of the serving-time per-task adapters
    # (repro_torch.serve.adapters.TaskAdapterStore); 0 = the store's caller
    # must pass an explicit rank
    adapter_rank: int = 0
    q_chunk: int = 1024
    # chunk length of the Mamba2 SSD scan over a full sequence
    mamba_chunk: int = 128
    # xLSTM (pattern kinds "mlstm" / "slstm"; repro_torch.models.xlstm):
    # the time loop's rematerialization chunk in training (0 = none; it
    # changes no value), and the chunkwise-parallel mLSTM of the training
    # forward (chunk xlstm_chunk, or 64 when that is 0)
    xlstm_chunk: int = 0
    xlstm_parallel: bool = False
    # rematerialize each layer's activations in the backward of ``forward``
    # (the JAX package's jax.checkpoint of its layer scan)
    remat: bool = True
    # sharding rules of an MLA decode cache (B, S, kv_lora): replicate it
    # over the model axis, or shard its sequence dim over model
    # (flash-decode layout); neither set: its latent dim on model
    mla_replicate_cache: bool = False
    mla_cache_seq_shard: bool = False
    # the reference's in-forward sharding constraints (read on DTensors
    # only): regather the MoE expert weights with only their ff dim on the
    # model axis before the expert products; the placements of the residual
    # stream at each period boundary (and after the embedding) and of the
    # logits, as Spec entries, e.g. ("data", None, "model"); None: no
    # constraint
    fsdp_gather_moe: bool = False
    activation_sharding: tuple | None = None
    logits_sharding: tuple | None = None
    attn_backend: str = "kernel"
    source: str = ""

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def remainder(self) -> tuple[str, ...]:
        """Kinds of the layers past the last whole period: the pattern's
        prefix (Zamba2-7B: 81 = 13 periods of 6, then 3 mamba layers)."""
        return self.pattern[: self.num_layers % self.period]

    def layer_kinds(self) -> tuple[str, ...]:
        """The kind of every layer, in order: the pattern cycled over the
        depth."""
        return tuple(self.pattern) * self.num_periods + self.remainder

    def stages(self) -> list[tuple[tuple[str, ...], int, int]]:
        """(kinds, repetitions, first layer) of each stage of the JAX
        model's layout, which its params, caches and adapter store follow:
        the stacked periods, then the remainder (the reference's
        ``_stage_patterns``). Slot ``j`` of repetition ``i`` is layer
        ``first + len(kinds) * i + j``."""
        out = [(tuple(self.pattern), self.num_periods, 0)] if self.num_periods > 0 else []
        if self.remainder:
            out.append((self.remainder, 1, self.num_periods * self.period))
        return out

    @property
    def uses_moe(self) -> bool:
        return any(k == "attn_moe" for k in self.pattern)

    def validate(self) -> None:
        if self.uses_moe and not self.num_experts >= self.top_k > 0:
            raise ValueError(
                f"an MoE pattern needs num_experts >= top_k > 0, got num_experts "
                f"{self.num_experts}, top_k {self.top_k}"
            )
        if self.num_kv_heads < 1 or self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads {self.num_heads} is not a multiple of "
                f"num_kv_heads {self.num_kv_heads}"
            )
        if self.mlp_kind not in ("swiglu", "gelu"):
            raise ValueError(f"unknown mlp_kind {self.mlp_kind!r}")
        if self.norm_kind not in ("rmsnorm", "layernorm", "nonparam_ln"):
            raise ValueError(f"unknown norm_kind {self.norm_kind!r}")
        for kind in self.pattern:
            if kind not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {kind!r}; want one of {BLOCK_KINDS}")
        if self.input_mode not in INPUT_MODES:
            raise ValueError(f"input_mode must be one of {INPUT_MODES}, got {self.input_mode!r}")
        if self.num_codebooks < 1 or (self.num_codebooks > 1 and self.input_mode != "audio"):
            raise ValueError(
                f"num_codebooks {self.num_codebooks}: want 1, or more for input_mode "
                f"'audio' (got input_mode {self.input_mode!r})"
            )
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(
                f"attn_backend must be one of {ATTN_BACKENDS}, got "
                f"{self.attn_backend!r}"
            )


_ARCHS = ["deepseek_v2_236b", "mixtral_8x22b", "multitask_linreg", "multitask_lm",
          "musicgen_large", "olmo_1b", "phi4_mini_3_8b", "pixtral_12b", "qwen1_5_110b",
          "qwen2_5_14b", "xlstm_350m", "zamba2_7b"]


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def list_archs() -> list[str]:
    return list(_ARCHS)


def get(name: str, smoke: bool = False):
    if canonical(name) not in _ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port has {_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg = mod.smoke() if smoke else mod.CONFIG
    cfg.validate()
    return cfg
