"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: multimodal decoder
(mistral-nemo-style) consuming interleaved text tokens and patch embeddings.
The Pixtral-ViT vision tower is a stub, as in the reference: the batch
carries precomputed patch embeddings (``vision_embeds``) and the mask of
the positions they replace (``vision_mask``)."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,  # 5120 / 32
    d_ff=14336,
    vocab_size=131072,
    pattern=("attn",),
    input_mode="vlm",
    rope_theta=1e6,
    source="hf:mistralai/Pixtral-12B-2409",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        num_tasks=4,
        q_chunk=64,
    )
