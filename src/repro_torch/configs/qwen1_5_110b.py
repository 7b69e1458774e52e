"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family card]: dense GQA (kv=8) with the
Qwen QKV bias."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    pattern=("attn",),
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
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
