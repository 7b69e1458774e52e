"""Analytic cost model of the dry run, and the H100's constants.

``param_counts`` and ``model_flops`` are the classic MODEL_FLOPS accounting
(6 N D for a train step, 2 N D for inference, N the parameters a token
activates: an MoE layer's top-k and shared experts) plus the attention
context FLOPs, over the port's ``ArchConfig`` and ``InputShape``; the
counts equal the reference's ``benchmarks/costmodel.py`` for every
architecture and input shape. All counts are GLOBAL (the whole batch, every
device); divide by the device count for a per-device term.

There is no scan correction here. XLA's cost analysis visits a scanned loop
body once, so the reference adds the FLOPs of the sequential inner scans
(the SSD's chunks, xLSTM's time steps) analytically. The port's dry run is
an eager program: its recorder (``launch.dryrun.Recorder``) counts every
step of every loop, and xLSTM's sequence shapes are carried exactly to
their length by ``launch.dryrun.account_in_time``, so nothing is missing.

``H100`` is the card ``launch.roofline`` prices a record on; each constant
names its source (NVIDIA H100 Tensor Core GPU datasheet, the SXM5 form
factor: "NVIDIA H100 80GB HBM3", 700 W).

  python -m repro_torch.launch.costmodel [--arch ARCH] [--shape SHAPE]

prints the counts of one architecture (or all) at each input shape.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs import get, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.specs import INPUT_SHAPES, InputShape

ATTN_KINDS = ("attn", "attn_moe", "shared_attn")


def _layers(cfg: ArchConfig) -> list[str]:
    return list(cfg.pattern) * cfg.num_periods + list(cfg.remainder)


def param_counts(cfg: ArchConfig) -> tuple[float, float]:
    """(total parameters, parameters active per token), embeddings counted
    once (tied or not), the lm head's product in the active count; the one
    shared attention block counted once in the total, at every use in the
    active count."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def attn():
        if cfg.use_mla:
            r, dn, dr, dv = cfg.kv_lora, cfg.qk_nope, cfg.qk_rope, cfg.v_head_dim
            return d * h * (dn + dr) + d * r + d * dr + r * h * dn + r * h * dv + h * dv * d
        return d * h * hd + 2 * d * kvh * hd + h * hd * d

    def mlp():
        return (3 if cfg.mlp_kind == "swiglu" else 2) * d * ff

    def moe():
        total = cfg.num_experts * 3 * d * ff + d * cfg.num_experts
        total += cfg.num_shared_experts * 3 * d * ff
        active = (cfg.top_k + cfg.num_shared_experts) * 3 * d * ff + d * cfg.num_experts
        return total, active

    def mamba():
        di = 2 * d
        nh = di // cfg.ssm_head_dim
        return d * (2 * di + 2 * cfg.ssm_state + nh) + di * d + 4 * (di + 2 * cfg.ssm_state)

    def mlstm():
        di = 2 * d
        return d * 2 * di + 3 * di * di + di * 2 * (di // 256 + 1) + di * d

    def slstm():
        hd_s = d // cfg.num_heads
        return d * 4 * d + 4 * cfg.num_heads * hd_s * hd_s + d * d

    per_kind = {}
    for kind in set(cfg.pattern):
        if kind in ("attn", "shared_attn"):
            per_kind[kind] = (attn() + mlp(),) * 2
        elif kind == "attn_moe":
            tot, act = moe()
            per_kind[kind] = (attn() + tot, attn() + act)
        else:
            per_kind[kind] = ({"mamba": mamba, "mlstm": mlstm, "slstm": slstm}[kind](),) * 2
    total = active = 0.0
    seen_shared = False
    for kind in _layers(cfg):
        t, a = per_kind[kind]
        active += a
        if kind != "shared_attn" or not seen_shared:
            total += t
        seen_shared = seen_shared or kind == "shared_attn"
    codebooks = cfg.num_codebooks
    total += v * d * (codebooks if cfg.input_mode == "audio" else 1)
    total += 0 if cfg.tie_embeddings else d * v * codebooks
    active += d * v * codebooks  # the head's product, per token
    return total, active


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """6 N D (train) or 2 N D (prefill, decode) over the active parameters,
    plus the attention context FLOPs (a causal train or prefill row reads
    half the sequence on average, a decode token all of it; a sliding
    window caps both); GLOBAL."""
    _, n_active = param_counts(cfg)
    b, s = shape.global_batch, shape.seq_len
    n_attn = sum(1 for k in _layers(cfg) if k in ATTN_KINDS)
    if cfg.use_mla:
        qk_dim, v_dim = cfg.qk_nope + cfg.qk_rope, cfg.v_head_dim
    else:
        qk_dim = v_dim = cfg.head_dim
    width = cfg.num_heads * (qk_dim + v_dim) * n_attn
    if shape.kind in ("train", "prefill"):
        mult = 6 if shape.kind == "train" else 2
        ctx = s / 2 if cfg.sliding_window is None else min(cfg.sliding_window, s / 2)
        return mult * n_active * b * s + mult * b * s * ctx * width
    ctx = s if cfg.sliding_window is None else min(cfg.sliding_window, s)
    return 2.0 * n_active * b + 2 * b * ctx * width


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "NVIDIA H100 80GB HBM3 (SXM5, 700 W)"
    # dense BF16 Tensor Core FLOP/s: the datasheet's 1,979 TFLOPS for H100
    # SXM5 is with 2:4 sparsity, half of it dense
    peak_flops: float = 989.4e12
    # FP32 FLOP/s (CUDA cores), H100 SXM5 datasheet: the peak of a float32 run
    peak_flops_f32: float = 67e12
    # HBM3 bandwidth, H100 SXM5 datasheet: 3.35 TB/s
    hbm_bw: float = 3.35e12
    # NVLink 4, H100 SXM5 datasheet: 900 GB/s a GPU in all, 450 GB/s each way,
    # all to all among the 8 GPUs of one HGX H100 node
    nvlink_bw: float = 450e9
    nvlink_ranks: int = 8
    # between nodes: one 400 Gb/s NDR InfiniBand port (ConnectX-7) a GPU,
    # 50 GB/s each way
    network_bw: float = 50e9


H100 = Hardware()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one architecture (default: every one)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else [a for a in list_archs() if a != "multitask_linreg"]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    print("| arch | params total | active a token | " + " | ".join(
        f"{s} MODEL_FLOPS" for s in shapes) + " |")
    print("|" + "---|" * (3 + len(shapes)))
    for arch in archs:
        cfg = get(arch)
        total, active = param_counts(cfg)
        flops = " | ".join(f"{model_flops(cfg, INPUT_SHAPES[s]):.4e}" for s in shapes)
        print(f"| {arch} | {total:.4e} | {active:.4e} | {flops} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
