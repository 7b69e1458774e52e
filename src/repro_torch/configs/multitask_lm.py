"""The paper's m-related-tasks setting lifted onto a dense GQA transformer
served with per-task low-rank adapters: each of the ``num_tasks`` tenants
owns a rank-``adapter_rank`` delta per block branch plus per-task head
biases, graph-mixed over the task-relatedness graph at serving time (see
``repro_torch.serve.adapters``). Same values as the JAX package's
``multitask_lm``."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="multitask-lm",
    family="dense",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=4,
    head_dim=64,
    d_ff=4096,
    vocab_size=32000,
    pattern=("attn",),
    num_tasks=256,
    adapter_rank=8,
    source="arXiv:1802.03830 (serving-scale extension)",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=128,
        num_tasks=8,
        adapter_rank=2,
        q_chunk=64,
    )
