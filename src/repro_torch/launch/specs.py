"""Stand-ins for every model input on the ``meta`` device — shapes and
dtypes, no storage: the port of ``repro.launch.specs`` (whose
``ShapeDtypeStruct``s play this part). The sharding rules read them
(``repro_torch.sharding.rules.batch_specs``).

Input shapes:
  train_4k     seq=4096,   global_batch=256   -> train step
  prefill_32k  seq=32768,  global_batch=32    -> prefill (serve)
  decode_32k   seq=32768,  global_batch=128   -> decode step (serve, 1 token)
  long_500k    seq=524288, global_batch=1     -> decode step, sub-quadratic
                                                 archs only
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The model inputs of one (arch, shape) pair as ``meta`` tensors."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    batch: dict = {"task_ids": _meta((b,), torch.int32)}
    if cfg.input_mode == "audio":
        batch["tokens"] = _meta((b, s, cfg.num_codebooks), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s, cfg.num_codebooks), torch.int32)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), torch.int32)
        if cfg.input_mode == "vlm":
            batch["vision_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
            batch["vision_mask"] = _meta((b, s), torch.bool)
    return batch
