"""The port's training step on the card against the same step on the CPU,
at smoke width (multitask_lm, f32, TF32 off, the same weights): 3 steps
with the graph-mixed update, 2 microbatches and the graph penalty give the
CPU's losses (rtol 1e-5) and parameters (SGD with momentum: atol 1e-5;
AdamW: each leaf's norm, rtol 1e-5, since Adam turns a near-zero gradient
that summation order perturbs into a step of up to lr), and every
parameter keeps its storage. Needs a CUDA device and skips without one;
imports no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.train import batch_to_device, init_state, make_train_step  # noqa: E402

STEPS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(device, make_opt):
    cfg = get("multitask_lm", smoke=True)
    model = TransformerLM(cfg, device=device)
    model.load_state_dict(TransformerLM(cfg, device="cpu", seed=0).state_dict())
    ptrs = [p.data_ptr() for p in model.parameters()]
    opt = make_opt()
    gmt = GraphMultiTask(band_graph(cfg.num_tasks, 1), eta=0.1, tau=1.0)
    step = make_train_step(model, opt, gmt, microbatches=2, graph_penalty_weight=0.1)
    state = init_state(model, opt)
    losses = []
    pipe = TokenPipeline(cfg.vocab_size, seq_len=32, global_batch=8,
                         num_tasks=cfg.num_tasks, seed=0)
    for _, batch in zip(range(STEPS), pipe):
        state, metrics = step(state, batch_to_device(batch, device))
        losses.append(metrics["loss"])
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    return [float(v) for v in losses], {n: p.detach().cpu() for n, p in model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_train_steps_on_the_card_match_the_cpu(cuda, opt_name):
    make_opt = (lambda: sgd(0.05, 0.9)) if opt_name == "sgd" else (lambda: adamw(1e-3))
    card_losses, card = _run(cuda, make_opt)
    cpu_losses, host = _run("cpu", make_opt)
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-5)
    for name in host:
        if opt_name == "sgd":
            torch.testing.assert_close(card[name], host[name], atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(float(card[name].norm()), float(host[name].norm()),
                                       rtol=1e-5, err_msg=name)
