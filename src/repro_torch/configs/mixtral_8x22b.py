"""Mixtral 8x22B [arXiv:2401.04088]: 8 experts top-2, GQA kv=8, sliding-window
attention (window 4096)."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=("attn_moe",),
    sliding_window=4096,
    num_experts=8,
    num_shared_experts=0,
    top_k=2,
    long_context_ok=True,  # sliding window: a bounded attention span
    source="arXiv:2401.04088",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        sliding_window=32,
        num_experts=4,
        top_k=2,
        num_tasks=4,
        q_chunk=64,
    )
