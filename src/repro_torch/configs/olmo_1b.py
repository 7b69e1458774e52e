"""OLMo-1B [arXiv:2402.00838]: dense MHA, NON-PARAMETRIC LayerNorm (no gain/
bias anywhere), tied embeddings."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    pattern=("attn",),
    norm_kind="nonparam_ln",
    tie_embeddings=True,
    source="arXiv:2402.00838",
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
        num_tasks=4,
        q_chunk=64,
    )
