"""The distributed layer on the card (chip_smoke.py phase 19 at smoke
size): W = torch.cuda.device_count() ranks over NCCL, one per card.
mix_all_gather / mix_ring at m = W against mu^T theta, bol_sharded (ring
and all-gather) and bsr_sharded against the single-device bol / bsr on the
card, and the sharded DTensor train step (multitask_lm smoke, AdamW, a (W,
1) mesh) against the plain step: losses within 1e-5 relative, parameters
elementwise at W = 1 and by leaf norm over more ranks (AdamW turns the
data-parallel sum's rounding of a near-zero gradient into a step of up to
lr), the task leaves DTensors in the rules' placements; and the
tensor-parallel step (the residual stream and the logits constrained to
("data", None, "model")) on both mesh orientations, (W, 1) and (1, W), of
the multitask_lm and mixtral_8x22b smoke configs, against the plain step
under the same rule. Needs a CUDA
device and skips without one; imports no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_distributed.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_dist import run_ranks  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


def _close(got, want):
    return bool(((got - want).abs() <= TOL + TOL * want.abs()).all())


def solvers_on_the_card(rank, world):
    from repro_torch import core
    from repro_torch.core.distributed import mix_all_gather, mix_ring, mixing_spec_for_band_graph
    from repro_torch.core.runners import bol_sharded, bsr_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    g = core.band_graph(world, max(1, min(2, world // 2)))
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((world, 256)).astype(np.float32)
    mu = g.bol_mixing(0.5, 2.0, 0.04)
    want = torch.as_tensor((mu.T @ theta.astype(np.float64))[rank:rank + 1], device=dev)
    local = torch.as_tensor(theta[rank:rank + 1], device=dev)
    col = torch.as_tensor(mu[:, rank], dtype=torch.float32, device=dev)
    self_w, nbr = mixing_spec_for_band_graph(g, 0.5, 2.0, 0.04)
    out = {"mix_all_gather": _close(mix_all_gather(local, col).double(), want),
           "mix_ring": _close(mix_ring(local, self_w, nbr).double(), want)}
    x = rng.standard_normal((world, 40, 6)).astype(np.float32)
    y = rng.standard_normal((world, 40)).astype(np.float32)
    p = core.MultiTaskProblem(g, core.SQUARED, 0.5, 1.5)
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    bol = core.bol(p, xd, yd, 60, accelerated=False).w
    out["bol_ring"] = _close(bol_sharded(p, x, y, 60, use_ring=True), bol)
    out["bol_all_gather"] = _close(bol_sharded(p, x, y, 60, use_ring=False), bol)
    out["bsr"] = _close(bsr_sharded(p, x, y, 80), core.bsr(p, xd, yd, 80, accelerated=False).w)
    return out


def train_on_the_card(rank, world, arch="multitask_lm", spec=None, orientation="data"):
    """The plain step and the sharded one on a (W, 1) mesh (``orientation``
    "data") or a (1, W) mesh ("model"), with ``spec`` as the residual
    stream's and the logits' constraint."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get
    from repro_torch.core import GraphMultiTask, band_graph
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import axes_of, make_mesh
    from repro_torch.models import TransformerLM
    from repro_torch.optim import adamw
    from repro_torch.sharding import full_params, shard_batch, shard_state, sharded_step
    from repro_torch.train import batch_to_device, init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    cfg = dataclasses.replace(get(arch, smoke=True), activation_sharding=spec,
                              logits_sharding=spec)
    if cfg.uses_moe:  # one dispatch group per data rank, on both sides
        cfg = dataclasses.replace(cfg, moe_groups=world if orientation == "data" else 1)
    pipe = TokenPipeline(cfg.vocab_size, seq_len=32, global_batch=8, num_tasks=cfg.num_tasks,
                         seed=0)
    batches = [batch_to_device(b, dev) for _, b in zip(range(3), pipe)]

    def run(model, shard=None):
        opt = adamw(1e-3)
        step = make_train_step(model, opt, GraphMultiTask(band_graph(cfg.num_tasks, 1),
                                                          eta=0.1, tau=1.0))
        state = init_state(model, opt)
        if shard is not None:
            state = shard_state(model, state, *shard)
            step = sharded_step(model, step)
        losses = []
        for b in batches:
            state, m = step(state, b if shard is None else shard_batch(b, *shard))
            losses.append(float(m["loss"]))
        return losses, state

    plain_losses, state = run(TransformerLM(cfg, device=dev, seed=0))
    want = {k: v.detach().clone() for k, v in state.params.items()}
    mesh = make_mesh(*((world, 1) if orientation == "data" else (1, world)), device="cuda")
    losses, state = run(TransformerLM(cfg, device=dev, seed=0), (mesh, axes_of(mesh)))
    got = full_params(state.params)
    if world == 1:
        params_ok = all(_close(got[k], v) for k, v in want.items())
    else:
        params_ok = all(abs(got[k].norm() / v.norm() - 1) <= TOL for k, v in want.items())
    return {"losses": np.allclose(losses, plain_losses, rtol=TOL, atol=0), "params": params_ok,
            "dtensor": all(isinstance(p, DTensor) for p in state.params.values())}


def test_solvers_over_nccl_match_single_device(world, tmp_path):
    for r in run_ranks(solvers_on_the_card, world, tmp_path, device="cuda"):
        assert all(r.values()), r


def test_sharded_train_step_matches_the_plain_step(world, tmp_path):
    for r in run_ranks(train_on_the_card, world, tmp_path, device="cuda"):
        assert all(r.values()), r


@pytest.mark.parametrize("orientation", ["data", "model"])
@pytest.mark.parametrize("arch", ["multitask_lm", "mixtral_8x22b"])
def test_tensor_parallel_step_matches_the_plain_step(world, tmp_path, arch, orientation):
    for r in run_ranks(train_on_the_card, world, tmp_path, arch, ("data", None, "model"),
                       orientation, device="cuda"):
        assert all(r.values()), r
