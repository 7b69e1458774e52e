"""xLSTM-350M [arXiv:2405.04517]: mLSTM + sLSTM blocks (7:1 ratio, i.e. one
sLSTM per 8-block period), 4 heads, d_ff=0 (blocks own their projections)."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    long_context_ok=True,  # recurrent state O(1) in the sequence
    source="arXiv:2405.04517",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=128,
        num_heads=2,
        num_kv_heads=2,
        head_dim=64,
        vocab_size=512,
        pattern=("mlstm", "slstm"),
        num_tasks=4,
    )
