"""Phi-4-mini 3.8B [arXiv:2412.08905]: RoPE + SwiGLU + GQA (24H, kv=8),
200k vocab, tied embeddings."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    pattern=("attn",),
    tie_embeddings=True,
    source="arXiv:2412.08905",
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
        num_tasks=4,
        q_chunk=64,
    )
