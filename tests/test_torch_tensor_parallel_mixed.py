"""Tensor-parallel steps of mixed block stacks and of the uneven layouts,
over spawned gloo ranks, CPU (tests/torch_dist.py):

  * on a 2 x 2 mesh, one SGD step of a dense/MoE interleave (``("attn",
    "attn_moe")``, Mixtral smoke) and of a mamba / attention / shared-block
    stack (``("mamba", "attn", "shared_attn")``, Zamba2 smoke) through
    ``sharding.sharded_step``: loss and every parameter within 1e-5 of the
    port's unsharded step and of the JAX package's plain step from its
    PRNGKey(0) weights;
  * on a 1 x 3 mesh, where the model ranks divide neither Zamba2's 8
    mamba heads, nor xLSTM's mLSTM head width (d_inner 256), nor
    DeepSeek-V2's 4 MLA heads (``qk_nope`` and ``v_head_dim`` 48, so W_uk
    and W_uv do split over the 3 ranks), each mixer runs replicated over
    them: the SGD step within 1e-5 of the unsharded step, and a prefill
    chunk then eight greedy ticks on DTensor caches within 1e-5 of the
    plain serving steps, the same tokens; the dry run's recorder counts
    each replicated layout. An xLSTM whose head width the ranks do divide
    serves from a replicated C cache (each rank reads its own block).

The uneven cases raised ``NotImplementedError`` before; the 1 x 3 step's
shared attention also replicates its query positions (32 over 3)."""
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
    tp_cases,
    tp_config,
    tp_model,
    tp_serve,
    tp_serve_caches,
)

from repro.configs import get as jax_get  # noqa: E402
from repro.core import GraphMultiTask as JaxGraphMultiTask  # noqa: E402
from repro.core import band_graph as jax_band_graph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train.trainer import init_state as jax_init_state  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402

TOL = 1e-5
SEQ = 1024  # cache rows
LENS = [16, 10, 0, 5]
MIXED = {  # 2 x 2
    "mixtral-attn-attn_moe": ("mixtral_8x22b", {"pattern": ("attn", "attn_moe")}),
    "zamba2-mamba-attn-shared_attn": ("zamba2_7b", {"pattern": ("mamba", "attn", "shared_attn"),
                                                   "num_layers": 3}),
}
UNEVEN = {  # 1 x 3: (arch, overrides, the layouts the step and the serving replicate)
    "mamba2-8-heads": ("zamba2_7b", {}, {"mamba2"}),
    "mlstm-head-width-256": ("xlstm_350m", {}, {"mlstm"}),
    "mla-4-heads": ("deepseek_v2_236b", {"qk_nope": 48, "v_head_dim": 48}, {"mla"}),
    "mlstm-replicated-c-cache": ("xlstm_350m", {"d_model": 96, "num_heads": 3,
                                                "num_kv_heads": 3}, set()),
}


class _Jax(dict):
    """Per mixed case, made on first use: the JAX weights from PRNGKey(0)
    (pickled for the ranks) and its plain jitted SGD step's loss and
    updated weights on the test's config and batch."""

    def __init__(self, root):
        super().__init__()
        self.root = root

    def __missing__(self, name):
        arch, over = MIXED[name]
        cfg = dataclasses.replace(jax_get(arch, smoke=True), num_tasks=2, moe_groups=2, **over)
        model, opt = JaxLM(cfg), jax_sgd(1e-2)
        state = jax_init_state(model, opt, jax.random.PRNGKey(0))
        path = str(self.root / f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, state.params), f)
        step = jax_make_train_step(model, opt, multitask=JaxGraphMultiTask(
            jax_band_graph(2, 1), eta=0.1, tau=1.0))
        batch = {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                                else v.numpy())
                 for k, v in tp_batch(tp_config(arch, **over)).items()}
        with jax.default_matmul_precision("highest"):
            new, metrics = jax.jit(step)(state, batch)
        self[name] = (path, float(metrics["loss"]), jax.tree.map(np.asarray, new.params))
        return self[name]


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    return _Jax(tmp_path_factory.mktemp("jax_tp_mixed"))


_RANKS: dict = {}


def _mixed_ranks(jax_steps, tmp_path_factory):
    if "mixed" not in _RANKS:
        cases = [{"arch": arch, "overrides": over, "params_path": jax_steps[name][0],
                  "serve": None} for name, (arch, over) in MIXED.items()]
        _RANKS["mixed"] = run_ranks(tp_cases, 4, tmp_path_factory.mktemp("tpm"), cases, (2, 2),
                                    SEQ, timeout=240)
    return _RANKS["mixed"]


def _uneven_ranks(tmp_path_factory):
    if "uneven" not in _RANKS:
        cases = [{"arch": arch, "overrides": over, "params_path": None, "serve": (4, LENS),
                  "replicated_caches": not want}
                 for arch, over, want in UNEVEN.values()]
        _RANKS["uneven"] = run_ranks(tp_cases, 3, tmp_path_factory.mktemp("tpu"), cases, (1, 3),
                                     SEQ, timeout=240)
    return _RANKS["uneven"]


def _unsharded(arch, over, params_path=None):
    """The port's unsharded SGD step of the same config, weights and batch."""
    cfg = tp_config(arch, **over)
    model = tp_model(cfg, params_path)
    opt = sgd(1e-2)
    step = make_train_step(model, opt, GraphMultiTask(band_graph(2, 1), eta=0.1, tau=1.0))
    _, metrics = step(init_state(model, opt), tp_batch(cfg))
    return float(metrics["loss"]), {k: v.detach().numpy() for k, v in model.named_parameters()}


def _check(step, loss, want):
    assert step["loss"] == pytest.approx(loss, rel=TOL)
    assert set(step["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(step["params"][k], v, rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(MIXED))
def test_mixed_tp_step_matches_the_plain_step_and_jax(name, jax_steps, tmp_path_factory):
    arch, over = MIXED[name]
    i = list(MIXED).index(name)
    path, jax_loss, jax_tree = jax_steps[name]
    ranks = _mixed_ranks(jax_steps, tmp_path_factory)
    loss, want = _unsharded(arch, over, path)
    jax_want = {k: v.detach().numpy() for k, v in load_numpy_params(
        TransformerLM(tp_config(arch, **over), device="cpu"), jax_tree).named_parameters()}
    for r in ranks:
        _check(r[i]["step"], loss, want)
        _check(r[i]["step"], jax_loss, jax_want)
        assert r[i]["step"]["replicated"] == {}  # 2 x 2 divides every split


@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_layout_step_matches_the_plain_step(name, tmp_path_factory):
    arch, over, replicated = UNEVEN[name]
    i = list(UNEVEN).index(name)
    loss, want = _unsharded(arch, over)
    for r in _uneven_ranks(tmp_path_factory):
        _check(r[i]["step"], loss, want)
        if replicated - {"mla"}:  # MLA trains head-parallel by query positions
            assert replicated <= set(r[i]["step"]["replicated"]), r[i]["step"]["replicated"]


@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_layout_serving_matches_the_plain_steps(name, tmp_path_factory):
    """prefill_step of a (4, 16) chunk (slot 2 with no valid token), then
    eight greedy decode ticks (a lane dead on the third): every step's
    logits and the caches within 1e-5 of the plain steps', the same
    tokens; the replicated layouts counted."""
    arch, over, replicated = UNEVEN[name]
    i = list(UNEVEN).index(name)
    cfg = dataclasses.replace(tp_config(arch, **over), attn_backend="plain")
    model = tp_model(cfg)
    want = tp_serve(model, tp_serve_caches(model, 4, SEQ), cfg, 4, SEQ, lens=LENS)
    for r in _uneven_ranks(tmp_path_factory):
        got = r[i]["serve"]
        assert replicated <= set(got["replicated"]), got["replicated"]
        if not replicated:  # the value split, C read from its replicated cache
            assert "mlstm" not in got["replicated"], got["replicated"]
        for g, w in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w)
        for key in ("prefill_caches", "caches"):
            for ge, we in zip(got[key], want[key]):
                for g, w in zip(ge, we):
                    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
