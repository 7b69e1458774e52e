"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA (kv_lora=512, decoupled RoPE 64)
+ MoE with 2 shared and 160 routed experts, top-6.

As in the reference config, DeepSeek-V2's first dense layer is folded into
the homogeneous MoE stack."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,  # per routed expert
    vocab_size=102400,
    pattern=("attn_moe",),
    use_mla=True,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    source="arXiv:2405.04434",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        kv_lora=64,
        qk_nope=32,
        qk_rope=16,
        v_head_dim=32,
        num_experts=4,
        num_shared_experts=1,
        top_k=2,
        num_tasks=4,
        q_chunk=64,
    )
