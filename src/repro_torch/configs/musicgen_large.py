"""MusicGen-large [arXiv:2306.05284]: decoder-only transformer over EnCodec
tokens, 4 codebooks (delay pattern), vocab 2048 per codebook, MHA (kv=32),
GELU MLP. The EnCodec codec is a stub, as in the reference: the LM reads and
predicts the codebook tokens directly, (B, S, K) in and (B, S, K, V) out."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=("attn",),
    mlp_kind="gelu",
    norm_kind="layernorm",
    input_mode="audio",
    num_codebooks=4,
    source="arXiv:2306.05284",
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
        vocab_size=256,
        num_codebooks=2,
        num_tasks=4,
        q_chunk=64,
    )
