"""Beyond-paper ablation: does the paper's graph-regularized per-task
personalization actually help an LM when tasks (user groups) have different
token distributions? The counterpart of the reference's
``benchmarks/ablation_mtl_lm.py``.

Three configurations of the SAME model on the same multi-task token stream
(8 tasks, per-task unigram tilts):
  * local        — personalization, NO graph mixing (eta=tau=0: each task's
                   adapter learns alone);
  * graph (ours) — the paper's mixed update on a ring relatedness graph;
  * consensus    — uniform complete-graph mixing with large tau (all task
                   adapters forced together == no personalization).

Reports final train loss; personalization should win, and graph mixing
should match/beat local when neighboring tasks are actually related
(TokenPipeline gives each task a perturbation of a shared base).

Each variant starts from the same weights, as the reference's (one init
key for all three): the model's own seeded init, or ``params``, a JAX
params tree with numpy leaves (``repro_torch.convert``).

    python -m repro_torch.experiments.ablation_mtl_lm [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import load_numpy_params
from repro_torch.core import GraphMultiTask, band_graph, complete_graph
from repro_torch.data.tokens import TokenPipeline
from repro_torch.experiments.common import Timer, add_device_arg, full_f32, write_csv
from repro_torch.kernels.runtime import require_device
from repro_torch.models import TransformerLM
from repro_torch.optim import adamw
from repro_torch.train import train_loop

SEQ, BATCH = 64, 16


def ablation_config(tasks: int) -> ArchConfig:
    return ArchConfig(
        name="ablation", family="dense", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        num_tasks=tasks, q_chunk=64,
    )


def main(argv=None, params=None, timings: dict | None = None):
    """``timings``, when given, maps each variant to the synchronized wall
    seconds of its training loop."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--tasks", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()
    dev = require_device(args.device)

    cfg = ablation_config(args.tasks)
    variants = {
        "local": GraphMultiTask(band_graph(args.tasks, 1), eta=0.0, tau=0.0,
                                alpha=1.0),
        # alpha matched to the optimizer timescale: with Adam providing the
        # gradient step, the mixing stepsize must be of the same order as the
        # learning rate or it drowns the personalization signal
        "graph": GraphMultiTask(band_graph(args.tasks, 1), eta=0.05, tau=2.0,
                                alpha=0.01),
        "consensus": GraphMultiTask(complete_graph(args.tasks), eta=0.05,
                                    tau=50.0),
    }
    rows = []
    for name, gmt in variants.items():
        model = TransformerLM(cfg, device=dev, seed=0)
        if params is not None:
            load_numpy_params(model, params)
        # neighbor-correlated tilts: ring neighbors share most of their
        # distribution shift — the regime the paper's coupling targets
        pipe = TokenPipeline(cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                             num_tasks=args.tasks, seed=0, tilt=3.0,
                             neighbor_corr=2)
        with Timer(dev) as t:
            state, hist = train_loop(
                model, adamw(3e-3), iter(pipe), num_steps=args.steps,
                multitask=gmt, log_every=args.steps - 1,
            )
        if timings is not None:
            timings[name] = t.seconds
        # adapter spread across tasks = personalization evidence
        spread = float(torch.std(state.params["task.head_bias"].detach(), dim=0,
                                 correction=0).mean())
        rows.append([name, hist[-1]["loss"], spread])
        print(f"{name:10s} final_loss={hist[-1]['loss']:.4f} "
              f"adapter_spread={spread:.5f}")
    path = write_csv("ablation_mtl_lm.csv", ["variant", "final_loss", "spread"], rows)
    print(f"wrote {path}")
    return rows


if __name__ == "__main__":
    main()
