"""Tensor-parallel compute of the port's sharded train step
(repro_torch.sharding.sharded_step with the in-forward constraints of
repro_torch.sharding.tensor_parallel) on a 2 x 2 gloo mesh, CPU.

One SGD and one AdamW step of the olmo_1b and mixtral_8x22b smoke models,
residual stream and logits constrained to ("data", None, "model"), over
four spawned ranks (tests/torch_dist.py), against the port's unsharded
step from the same weights; the olmo steps also against the JAX package's
plain single-device step from its PRNGKey(0) weights (no constraints on
the JAX side). The dry run's recorder (repro_torch.launch.dryrun.Recorder)
counts each rank's product FLOPs and collectives: no all-gather over the
model axis outputs a whole model-split weight, and the ranks' FLOPs sum to
the unsharded step's (ZeRO-3's gathered compute would count each product
on both model ranks)."""
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402, F401
from torch_dist import (  # noqa: E402
    run_ranks,
    tp_batch,
    tp_caches,
    tp_config,
    tp_decode,
    tp_decode_inputs,
    tp_model,
    tp_optimizer,
    tp_step,
)

from repro.configs import get as jax_get  # noqa: E402
from repro.core import GraphMultiTask as JaxGraphMultiTask  # noqa: E402
from repro.core import band_graph as jax_band_graph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train.trainer import init_state as jax_init_state  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.launch.dryrun import record  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.sharding import sharded_step  # noqa: E402
from repro_torch.sharding import tensor_parallel as tp  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402

TOL = 1e-5
M = 2  # model ranks of the 2 x 2 mesh
STEPS = [("olmo_1b", "sgd", False), ("olmo_1b", "adamw", False),
         ("mixtral_8x22b", "sgd", False), ("mixtral_8x22b", "adamw", True)]
IDS = [f"{a}-{o}" + ("-fsdp_gather_moe" if g else "") for a, o, g in STEPS]


@pytest.fixture(scope="module")
def jax_olmo(tmp_path_factory):
    """The JAX package's olmo_1b smoke weights from PRNGKey(0) (pickled
    for the ranks) and its plain jitted step's loss and updated weights,
    SGD and AdamW."""
    cfg = dataclasses.replace(jax_get("olmo_1b", smoke=True), num_tasks=2)
    model = JaxLM(cfg)
    batch = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tp_batch(cfg).items()}
    out = {"path": str(tmp_path_factory.mktemp("jax_tp") / "olmo.pkl")}
    for name, opt in (("sgd", jax_sgd(1e-2)), ("adamw", jax_adamw(3e-4))):
        state = jax_init_state(model, opt, jax.random.PRNGKey(0))
        if name == "sgd":
            with open(out["path"], "wb") as f:
                pickle.dump(jax.tree.map(np.asarray, state.params), f)
        step = jax_make_train_step(model, opt, multitask=JaxGraphMultiTask(
            jax_band_graph(2, 1), eta=0.1, tau=1.0))
        new, metrics = jax.jit(step)(state, batch)
        out[name] = (float(metrics["loss"]), jax.tree.map(np.asarray, new.params))
    return out


_RANKS: dict = {}


def _ranks(arch, opt, gather, tmp_path_factory, params_path):
    key = (arch, opt, gather)
    if key not in _RANKS:
        _RANKS[key] = run_ranks(tp_step, 4, tmp_path_factory.mktemp("tp"), arch, opt, gather,
                                params_path)
    return _RANKS[key]


def _unsharded(arch, opt_name, params_path, **overrides):
    """The port's unsharded step of the same config, weights and batch:
    loss, updated parameters, product FLOPs."""
    cfg = tp_config(arch, **overrides)
    model = tp_model(cfg, params_path)
    opt = tp_optimizer(opt_name)
    step = make_train_step(model, opt, GraphMultiTask(band_graph(2, 1), eta=0.1, tau=1.0))
    state = init_state(model, opt)
    (_, metrics), _, rec = record(lambda: step(state, tp_batch(cfg)), (state,), {})
    return (float(metrics["loss"]),
            {k: v.detach().numpy() for k, v in model.named_parameters()}, rec.flops)


def _check_params(got, want, opt_name):
    """SGD: every element within TOL; AdamW: each leaf's norm (a near-zero
    gradient summed in another order becomes a step of up to lr either
    way)."""
    assert set(got) == set(want)
    for k, v in want.items():
        if opt_name == "sgd":
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL, err_msg=k)
        else:
            assert np.linalg.norm(got[k]) == pytest.approx(np.linalg.norm(v), rel=TOL), k


def _params_path(arch, jax_olmo):
    return jax_olmo["path"] if arch == "olmo_1b" else None


@pytest.mark.parametrize("arch,opt,gather", STEPS, ids=IDS)
def test_tp_step_matches_the_unsharded_step(arch, opt, gather, jax_olmo, tmp_path_factory):
    path = _params_path(arch, jax_olmo)
    ranks = _ranks(arch, opt, gather, tmp_path_factory, path)
    loss, want, _ = _unsharded(arch, opt, path)
    for r in ranks:
        assert r["loss"] == pytest.approx(loss, rel=TOL)
        _check_params(r["params"], want, opt)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_tp_olmo_step_matches_the_jax_plain_step(opt, jax_olmo, tmp_path_factory):
    ranks = _ranks("olmo_1b", opt, False, tmp_path_factory, jax_olmo["path"])
    loss, tree = jax_olmo[opt]
    cfg = tp_config("olmo_1b")
    want = {k: v.detach().numpy() for k, v in
            load_numpy_params(TransformerLM(cfg, device="cpu"), tree).named_parameters()}
    for r in ranks:
        assert r["loss"] == pytest.approx(loss, rel=TOL)
        _check_params(r["params"], want, opt)


def _whole_weight_gathers(r):
    """The model-axis all-gathers whose output is the raw all-gather of a
    whole model-split weight (its fsdp-gathered local shard, M of them
    stacked on dim 0) or has the weight's full shape."""
    forbidden = set()
    for full, local in r["gathered"].values():
        if len(full) >= 2 and tuple(full) != tuple(local):
            forbidden |= {tuple(full), (M * local[0],) + tuple(local[1:])}
    return [c for c in r["collectives"]
            if c[0] == "all-gather" and c[1] == "model" and tuple(c[2]) in forbidden]


@pytest.mark.parametrize("arch", ["olmo_1b", "mixtral_8x22b"])
def test_tp_step_never_gathers_a_model_split_weight(arch, jax_olmo, tmp_path_factory):
    for r in _ranks(arch, "sgd", False, tmp_path_factory, _params_path(arch, jax_olmo)):
        assert _whole_weight_gathers(r) == []
        assert any(c[1] == "model" for c in r["collectives"])  # activations do move


@pytest.mark.parametrize("arch", ["olmo_1b", "mixtral_8x22b"])
def test_tp_step_flops_sum_to_the_unsharded_step(arch, jax_olmo, tmp_path_factory):
    """olmo: every product splits four ways, so the ranks' FLOPs sum to
    the unsharded step's exactly. Mixtral: the same, but for the router,
    which each model rank runs whole over its data shard's tokens (the
    experts' dispatch needs every expert's probability): (M - 1) times
    its 2 T d E FLOPs a product, four products a layer (forward,
    rematerialized forward, two backward)."""
    path = _params_path(arch, jax_olmo)
    ranks = _ranks(arch, "sgd", False, tmp_path_factory, path)
    _, _, flops = _unsharded(arch, "sgd", path)
    extra = 0
    if arch == "mixtral_8x22b":
        c = get(arch, smoke=True)
        tokens = 4 * 32
        extra = (M - 1) * c.num_layers * 4 * 2 * tokens * c.d_model * c.num_experts
    assert sum(r["flops"] for r in ranks) == flops + extra
    assert len({r["flops"] for r in ranks}) == 1


ODD_HEADS = {"num_heads": 3, "num_kv_heads": 1, "head_dim": 64}


@pytest.mark.parametrize("arch", ["olmo_1b", "mixtral_8x22b"])
def test_tp_step_with_heads_the_ranks_do_not_divide(arch, tmp_path_factory):
    """Three query heads over two model ranks: the rules still split the
    (d, 3 * 64) projections over the model axis, the heads cannot follow,
    so each rank attends with its half of the query positions against
    every key (``tensor_parallel.attention``); the step equals the
    unsharded one."""
    ranks = run_ranks(tp_step, 4, tmp_path_factory.mktemp("tp_odd"), arch, "sgd", False, None,
                      ODD_HEADS)
    loss, want, _ = _unsharded(arch, "sgd", None, **ODD_HEADS)
    for r in ranks:
        assert r["loss"] == pytest.approx(loss, rel=TOL)
        _check_params(r["params"], want, "sgd")
        assert _whole_weight_gathers(r) == []


@pytest.mark.parametrize("overrides,split", [(None, "heads"), (ODD_HEADS, "sequence")],
                         ids=["kv-heads-split", "sequence-split"])
def test_tp_decode_matches_the_plain_decode(overrides, split, tmp_path):
    """The dry run's serving path: one decode_step on a 2 x 2 mesh against
    a 1024-row cache split by kv head, or, with one kv head, by sequence
    (each rank's block of keys, the softmax combined across the model
    ranks), against the plain decode_step: logits and the written caches
    within 1e-5."""
    seq = 1024
    r = run_ranks(tp_decode, 4, tmp_path, overrides, seq)[0]
    cfg = tp_config("olmo_1b", attn_backend="plain", **(overrides or {}))
    model = tp_model(cfg)
    caches = tp_caches(model, seq)
    batch, pos = tp_decode_inputs(cfg, seq)
    logits, _ = model.decode_step(batch, caches, pos)
    np.testing.assert_allclose(r["logits"], logits.numpy(), rtol=TOL, atol=TOL)
    for got, want in zip(r["caches"], caches):  # the new rows from tensor-parallel products
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w.numpy(), rtol=TOL, atol=TOL)
    want_dim = 2 if split == "heads" else 1
    assert f"Shard(dim={want_dim})" in r["cache_placements"][0], r["cache_placements"]


def test_fsdp_gather_moe_keeps_the_loss(jax_olmo, tmp_path_factory):
    """Mixtral's experts split over the model ranks by expert (the rules)
    or, regathered (``fsdp_gather_moe``), by ff: the same step."""
    off = _ranks("mixtral_8x22b", "sgd", False, tmp_path_factory, None)
    on = _ranks("mixtral_8x22b", "sgd", True, tmp_path_factory, None)
    for a, b in zip(off, on):
        assert b["loss"] == pytest.approx(a["loss"], rel=TOL)
        _check_params(b["params"], a["params"], "sgd")


def test_masked_reduction_equals_the_gather_form():
    """The label logit as the reference's masked reduction over the vocab
    equals the gather of the one entry and a select, bit for bit, labels
    outside [0, V) included (they give 0)."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 17, 50, generator=g) * 4
    labels = torch.randint(-3, 53, (3, 17), generator=g)
    labels[0, :4] = torch.tensor([-1, 50, 52, 0])
    v = logits.shape[-1]
    picked = logits.gather(-1, labels.clamp(0, v - 1)[..., None])[..., 0]
    old = torch.where((labels >= 0) & (labels < v), picked, 0.0)
    new = tp.label_logits(logits, labels)
    assert torch.equal(new, old)
    assert (new[0, :3] == 0).all()
    assert torch.equal(tp.logsumexp(logits), torch.logsumexp(logits, dim=-1))


def test_constraints_are_noops_on_plain_tensors():
    """With the constraints set, the unsharded forward and loss are the
    same, bit for bit, as without them."""
    cfg = get("mixtral_8x22b", smoke=True)
    batch = tp_batch(cfg)
    out = []
    for c in (cfg, tp_config("mixtral_8x22b", True)):
        c = dataclasses.replace(c, num_tasks=2, moe_groups=2)
        model = TransformerLM(c, device="cpu", seed=0)
        loss, metrics = model.loss_fn(batch)
        out.append((loss.detach(), model.forward(batch)[0].detach()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    x = torch.randn(2, 3, 4)
    assert tp.constrain(x, ("data", None, "model")) is x


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "zamba2_7b", "xlstm_350m", "pixtral_12b",
                                  "musicgen_large"])
def test_other_families_raise(arch):
    """No family raises any more: every family's case runs, the recurrent
    ones (Zamba2, xLSTM) too — the sharded train step of the smoke model
    (the 2 x 2 layouts' constraints) on a (1, 1) fake mesh of meta
    DTensors, through the dry run's accounting (the gloo runs are
    tests/test_torch_tensor_parallel_families.py's and
    tests/test_torch_tensor_parallel_recurrent.py's); a mixed block
    pattern passes ``check_tensor_parallel`` too (every kind has a
    tensor-parallel forward; tests/test_torch_tensor_parallel_mixed.py)."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import account
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.specs import InputShape
    from repro_torch.sharding import check_tensor_parallel

    model = TransformerLM(get(arch, smoke=True), device="cpu")
    assert callable(sharded_step(model, None))
    check_tensor_parallel(dataclasses.replace(model.cfg, pattern=("attn", "mamba")))
    try:
        r = account(tp_config(arch), InputShape("train_2x32", 32, 2, "train"),
                    make_fake_mesh(shape=(1, 1)), dtype=torch.float32)
    finally:
        dist.destroy_process_group()
    assert r["cost"]["flops"] > 0 and r["memory"]["alias_bytes"] > 0
