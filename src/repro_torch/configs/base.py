"""Architecture config schema + registry of the port.

The port's own copy of the fields of ``repro.configs.base.ArchConfig`` that
the dense serving and training paths read (plus ``num_tasks``,
``adapter_rank``, ``q_chunk`` and ``remat``), with the same values per
architecture. The backend flag ``attn_backend`` is the port's, and it
selects every hand-written kernel, not only attention's: ``"kernel"``
serves attention from the CUDA attention kernels and mixes task adapters
(``repro_torch.serve.adapters``) with the CUDA graph-mix kernel; ``"plain"`` runs the plain PyTorch version of each
(the masked-softmax attention that plays the role of the JAX package's
``"jnp"``, and the einsum graph mix). ``get(name, smoke=)`` resolves either
variant; ``multitask_linreg`` resolves to the paper's own workload, a
``LinRegConfig`` (``repro_torch.configs.multitask_linreg``).
"""
from __future__ import annotations

import dataclasses
import importlib

ATTN_BACKENDS = ("kernel", "plain")


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
    num_tasks: int = 16
    # default low-rank width of the serving-time per-task adapters
    # (repro_torch.serve.adapters.TaskAdapterStore); 0 = the store's caller
    # must pass an explicit rank
    adapter_rank: int = 0
    q_chunk: int = 1024
    # rematerialize each layer's activations in the backward of ``forward``
    # (the JAX package's jax.checkpoint of its layer scan)
    remat: bool = True
    attn_backend: str = "kernel"
    source: str = ""

    def validate(self) -> None:
        if self.num_kv_heads < 1 or self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads {self.num_heads} is not a multiple of "
                f"num_kv_heads {self.num_kv_heads}"
            )
        if self.mlp_kind not in ("swiglu", "gelu"):
            raise ValueError(f"unknown mlp_kind {self.mlp_kind!r}")
        if self.norm_kind not in ("rmsnorm", "layernorm", "nonparam_ln"):
            raise ValueError(f"unknown norm_kind {self.norm_kind!r}")
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(
                f"attn_backend must be one of {ATTN_BACKENDS}, got "
                f"{self.attn_backend!r}"
            )


_ARCHS = ["multitask_linreg", "multitask_lm", "olmo_1b", "qwen2_5_14b"]


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str, smoke: bool = False):
    if canonical(name) not in _ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port has {_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg = mod.smoke() if smoke else mod.CONFIG
    cfg.validate()
    return cfg
