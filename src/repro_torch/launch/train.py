"""Training launcher: pick an architecture config, build the model and the
train step (AdamW under a cosine schedule + the graph multi-task mixed
update over a band graph), and run; the port of ``repro.launch.train``.

Runs on CUDA unless ``--device cpu`` is given, and raises without a GPU
otherwise. Smoke-size configs are the default; ``--no-smoke`` trains the
full-width config. Every language-model architecture trains; an audio or
VLM model takes the synthetic token batches as ``model_inputs`` makes them.

  PYTHONPATH=src python -m repro_torch.launch.train --arch multitask_lm --no-smoke
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --steps 20 \\
      --device cpu --ckpt /tmp/ckpt.npz

``--ckpt`` saves the trained weights in the JAX model's tree
(``repro_torch.convert.params_to_numpy``) with ``save_pytree``, so either
package loads them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ArchConfig, get
from repro_torch.convert import params_to_numpy
from repro_torch.core import GraphMultiTask, band_graph
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.runtime import require_device
from repro_torch.models import TransformerLM
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import batch_to_device, init_state, make_train_step


def model_inputs(cfg: ArchConfig, batch: dict) -> dict:
    """A token pipeline's host batch as ``cfg``'s input mode takes it, as
    the reference launcher builds it: an audio model's tokens and labels
    repeated over its codebooks (mod the vocabulary), (B, S, K); a VLM's
    zero (B, S, d_model) vision embeddings under an all-False mask (text
    only). A text model's batch is returned as it is."""
    batch = dict(batch)
    if cfg.input_mode == "audio":
        for key in ("tokens", "labels"):
            batch[key] = np.repeat(np.asarray(batch[key])[..., None], cfg.num_codebooks,
                                   -1) % cfg.vocab_size
    if cfg.input_mode == "vlm":
        b, s = np.shape(batch["tokens"])
        batch["vision_embeds"] = np.zeros((b, s, cfg.d_model), np.float32)
        batch["vision_mask"] = np.zeros((b, s), bool)
    return batch


def main(argv=None) -> TransformerLM:
    """Parse ``argv`` (the command line when None), train, print a line
    per logged step, save the checkpoint if asked; returns the model."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = get(args.arch, smoke=args.smoke)
    if not isinstance(cfg, ArchConfig):
        raise ValueError(f"{args.arch} is not a language model; the launcher trains LMs")
    if args.batch % cfg.num_tasks != 0:
        cfg = dataclasses.replace(cfg, num_tasks=max(1, args.batch // 2))
    model = TransformerLM(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, {cfg.num_tasks} tasks, {device}")

    gmt = GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=args.eta, tau=args.tau)
    opt = adamw(cosine_schedule(args.lr, warmup=max(args.steps // 10, 1),
                                total=args.steps))
    step_fn = make_train_step(model, opt, multitask=gmt, microbatches=args.microbatch)
    state = init_state(model, opt)
    pipe = TokenPipeline(cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, num_tasks=cfg.num_tasks)

    t0 = time.perf_counter()
    for i, batch in enumerate(pipe):
        if i >= args.steps:
            break
        state, metrics = step_fn(state, batch_to_device(model_inputs(cfg, batch), device))
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])  # waits for the step
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"({(time.perf_counter() - t0) / (i + 1) * 1e3:.1f} ms/step)")
    if args.ckpt:
        save_pytree(args.ckpt, params_to_numpy(model), step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")
    return model


if __name__ == "__main__":
    main()
