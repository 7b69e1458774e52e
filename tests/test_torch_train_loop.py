"""The port's ``train_loop`` (repro_torch.train) over 30 AdamW steps of
the olmo_1b smoke config with the graph-mixed update, CPU: the reference's
tests/test_train_serve.py loss-decrease test ported (a history entry per
step with loss, nll, aux and step; the last loss below the first, finite).
Split out of test_torch_train.py, whose other tests hold the trainer to
JAX, so that the test runner's per-file workers spread the two files."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import numpy as np  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402


def test_train_loop_loss_decreases():
    cfg = get("olmo_1b", smoke=True)
    model = TransformerLM(cfg, device="cpu", seed=0)
    pipe = TokenPipeline(cfg.vocab_size, seq_len=32, global_batch=8,
                         num_tasks=cfg.num_tasks, seed=0)
    gmt = GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    _, hist = train_loop(model, adamw(1e-3), iter(pipe), num_steps=30, multitask=gmt,
                         log_every=1)
    assert len(hist) == 30 and [h["step"] for h in hist] == list(range(30))
    assert set(hist[0]) == {"loss", "nll", "aux", "step"}
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert np.isfinite(hist[-1]["loss"])
