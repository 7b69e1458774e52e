"""Zamba2-7B [arXiv:2411.15242]: a Mamba2 backbone with ONE shared attention
block interleaved (applied every 6th layer; 81 = 13 periods of 6 plus a
3-layer Mamba remainder)."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,  # 3584 / 32
    d_ff=14336,
    vocab_size=32000,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm_state=64,
    ssm_head_dim=64,
    long_context_ok=True,  # SSM state O(1); only the shared-attention caches grow
    source="arXiv:2411.15242",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        pattern=("mamba", "shared_attn"),
        num_tasks=4,
        mamba_chunk=32,
        q_chunk=64,
    )
