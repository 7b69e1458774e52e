"""Tensor-parallel steps of the other attention families on a 2 x 2 gloo
mesh, CPU: Mixtral, DeepSeek-V2 (MLA), Pixtral (vision inputs) and
MusicGen (codebooks), each at a smoke size whose layout on the 2 x 2 mesh
is the one the family's full config takes on 16 x 16 (named in each test
id):

  * mixtral_8x22b, one kv head: the serving caches split their sequence
    over the model ranks (KVH 8 does not divide 16), and a batch-1 cache
    splits it over both mesh dims (long_500k), its 32-token window
    crossing two ranks' blocks while the other ranks see only masked keys;
  * deepseek_v2_236b: the latent (64 over 2) and the rope dims (16 over 2)
    split as DeepSeek-V2's 512 and 64 over 16; the experts split by expert
    (4 over 2, 160 over 16); the three MLA cache rules served;
  * pixtral_12b, one kv head: wk / wv's 64 columns split 32 a rank, half a
    head, as Pixtral's 1280 split 80 a rank; the cache's sequence split;
  * musicgen_large, three codebooks of 256: the head's 768 columns split
    384 a rank, so rank 0's shard holds codebook 0 and half of codebook 1
    (MusicGen's 8192 over 16: a quarter of a codebook a rank); the loss
    reduces each codebook's columns where they lie.

For each family, over four spawned ranks (tests/torch_dist.py): one SGD
and one AdamW step through ``sharding.sharded_step`` against the port's
unsharded step from the same weights (within 1e-5; AdamW by leaf norm) and
against the JAX package's plain step from its PRNGKey(0) weights;
``prefill_step`` then eight greedy decode ticks on DTensor caches in the
cache rules' layout against the plain steps (logits within 1e-5, the
caches within 1e-5, the same tokens); no all-gather over the model axis
of a whole model-split weight (nor of MusicGen's logits over the vocab);
the ranks' product FLOPs summed equal the unsharded step's (plus each
model rank's whole router, for the MoE families)."""
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
    tp_config,
    tp_family,
    tp_model,
    tp_optimizer,
    tp_serve,
    tp_serve_caches,
)

from repro.configs import get as jax_get  # noqa: E402
from repro.core import GraphMultiTask as JaxGraphMultiTask  # noqa: E402
from repro.core import band_graph as jax_band_graph  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train.trainer import init_state as jax_init_state  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.core import GraphMultiTask, band_graph  # noqa: E402
from repro_torch.launch.dryrun import record  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402

TOL = 1e-5
M = 2  # model ranks of the 2 x 2 mesh
SEQ = 1024  # cache rows: the cache rules split caches of 1024 rows and more
FAMILIES = {
    "mixtral_8x22b": ({"num_kv_heads": 1}, "kv-seq-split"),
    "deepseek_v2_236b": ({}, "latent-rope-split"),
    "pixtral_12b": ({"num_kv_heads": 1}, "half-head-kv"),
    "musicgen_large": ({"num_codebooks": 3}, "codebook-straddling-vocab"),
}
IDS = [f"{a}-{FAMILIES[a][1]}" for a in FAMILIES]
BATCH1 = (None, None, "model")  # the dry run's constraints where B does not divide
# each family's serving cases: (id, {"batch", "start", config overrides})
SERVE = {
    "mixtral_8x22b": [("seq-split", {"batch": 4}),
                      ("batch1-seq-over-both-dims-window-crosses-ranks",
                       {"batch": 1, "start": [245], "activation_sharding": BATCH1,
                        "logits_sharding": BATCH1})],
    "deepseek_v2_236b": [("lora-latent-split", {"batch": 4}),
                         ("replicate", {"batch": 4, "mla_replicate_cache": True}),
                         ("seq-split", {"batch": 4, "mla_cache_seq_shard": True})],
    "pixtral_12b": [("seq-split-vision-chunk", {"batch": 4})],
    "musicgen_large": [("kv-heads-split", {"batch": 4})],
}
SERVE_IDS = [(a, i, k) for a in SERVE for i, (k, _) in enumerate(SERVE[a])]


def _jax_batch(cfg):
    out = {}
    for k, v in tp_batch(cfg).items():
        v = v.numpy()
        out[k] = jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
    return out


class _JaxSteps(dict):
    """Per family, made on first use: the JAX package's smoke weights from
    PRNGKey(0) (pickled for the ranks) and its plain jitted step's loss and
    updated weights, SGD and AdamW, on the test's config and batch."""

    def __init__(self, root):
        super().__init__()
        self.root = root

    def __missing__(self, arch):
        overrides = FAMILIES[arch][0]
        cfg = dataclasses.replace(jax_get(arch, smoke=True), num_tasks=2, moe_groups=2,
                                  **overrides)
        model = JaxLM(cfg)
        batch = _jax_batch(tp_config(arch, **overrides))
        rec = {"path": str(self.root / f"{arch}.pkl")}
        for name, opt in (("sgd", jax_sgd(1e-2)), ("adamw", jax_adamw(3e-4))):
            state = jax_init_state(model, opt, jax.random.PRNGKey(0))
            if name == "sgd":
                with open(rec["path"], "wb") as f:
                    pickle.dump(jax.tree.map(np.asarray, state.params), f)
            step = jax_make_train_step(model, opt, multitask=JaxGraphMultiTask(
                jax_band_graph(2, 1), eta=0.1, tau=1.0))
            new, metrics = jax.jit(step)(state, batch)
            rec[name] = (float(metrics["loss"]), jax.tree.map(np.asarray, new.params))
        self[arch] = rec
        return rec


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    return _JaxSteps(tmp_path_factory.mktemp("jax_tp_families"))


_RANKS: dict = {}


def _ranks(arch, jax_steps, tmp_path_factory):
    """Rank 0 ... 3's records of ``tp_family`` (the steps and every serving
    case), run once per family."""
    if arch not in _RANKS:
        _RANKS[arch] = run_ranks(tp_family, 4, tmp_path_factory.mktemp("tpf"), arch,
                                 FAMILIES[arch][0], jax_steps[arch]["path"],
                                 [c for _, c in SERVE[arch]], SEQ, timeout=240)
    return _RANKS[arch]


def _unsharded(arch, opt_name, params_path):
    """The port's unsharded step of the same config, weights and batch:
    loss, updated parameters, product FLOPs."""
    cfg = tp_config(arch, **FAMILIES[arch][0])
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


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_step_matches_the_unsharded_step(arch, opt, jax_steps, tmp_path_factory):
    ranks = _ranks(arch, jax_steps, tmp_path_factory)
    loss, want, _ = _unsharded(arch, opt, jax_steps[arch]["path"])
    for r in ranks:
        assert r["steps"][opt]["loss"] == pytest.approx(loss, rel=TOL)
        _check_params(r["steps"][opt]["params"], want, opt)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_step_matches_the_jax_plain_step(arch, opt, jax_steps, tmp_path_factory):
    ranks = _ranks(arch, jax_steps, tmp_path_factory)
    loss, tree = jax_steps[arch][opt]
    cfg = tp_config(arch, **FAMILIES[arch][0])
    want = {k: v.detach().numpy() for k, v in
            load_numpy_params(TransformerLM(cfg, device="cpu"), tree).named_parameters()}
    for r in ranks:
        assert r["steps"][opt]["loss"] == pytest.approx(loss, rel=TOL)
        _check_params(r["steps"][opt]["params"], want, opt)


@pytest.mark.parametrize("arch,index,case", SERVE_IDS,
                         ids=[f"{a}-{k}" for a, _, k in SERVE_IDS])
def test_tp_serving_matches_the_plain_steps(arch, index, case, jax_steps, tmp_path_factory):
    """prefill_step of a (B, 16) chunk, then eight greedy decode ticks, on
    DTensor caches in the cache rules' layout: every step's logits and the
    caches within 1e-5 of the plain steps', the same greedy tokens; the
    caches split as the case says."""
    ranks = _ranks(arch, jax_steps, tmp_path_factory)
    r = ranks[0]["serve"][index]
    spec = dict(SERVE[arch][index][1])
    b, start = spec.pop("batch"), spec.pop("start", None)
    cfg = dataclasses.replace(tp_config(arch, **FAMILIES[arch][0]), attn_backend="plain",
                              **spec)
    model = tp_model(cfg, jax_steps[arch]["path"])
    want = tp_serve(model, tp_serve_caches(model, b, SEQ), cfg, b, SEQ, start=start)
    assert len(r["logits"]) == len(want["logits"])
    for got, exp in zip(r["logits"], want["logits"]):
        np.testing.assert_allclose(got, exp, rtol=TOL, atol=TOL)
    for got, exp in zip(r["tokens"], want["tokens"]):
        np.testing.assert_array_equal(got, exp)
    for got, exp in zip(r["caches"], want["caches"]):
        for g, w in zip(got, exp):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    placed = r["cache_placements"][0]
    if case.startswith("batch1"):  # the sequence over both mesh dims, data-major
        assert placed == "(Shard(dim=1), Shard(dim=1))", placed
        for rank in ranks:
            d, m = rank["serve"][index]["coordinate"]
            assert rank["serve"][index]["cache_rows"] == (SEQ // 4, (2 * d + m) * SEQ // 4)
    elif "seq" in case:
        assert placed.endswith("Shard(dim=1))"), placed
    elif case == "lora-latent-split":
        assert placed.endswith("Shard(dim=2))") and \
            r["cache_placements"][1].endswith("Shard(dim=2))"), r["cache_placements"]
    elif case == "replicate":
        assert placed.endswith("Replicate())"), placed
    else:
        assert "Shard(dim=2)" in placed, placed


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


@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_step_never_gathers_a_model_split_weight(arch, jax_steps, tmp_path_factory):
    """... nor MusicGen's (B, S, K V) logits over the vocab: no model-axis
    all-gather outputs as many elements as a data shard's logits."""
    cfg = tp_config(arch, **FAMILIES[arch][0])
    logits = 2 * 32 * cfg.vocab_size * cfg.num_codebooks  # a data shard's (B / 2, S, K V)
    for r in _ranks(arch, jax_steps, tmp_path_factory):
        step = r["steps"]["sgd"]
        assert _whole_weight_gathers(step) == []
        assert any(c[1] == "model" for c in step["collectives"])  # activations do move
        assert not [c for c in step["collectives"] if c[0] == "all-gather" and
                    c[1] == "model" and int(np.prod(c[2])) >= logits]


@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_step_flops_sum_to_the_unsharded_step(arch, jax_steps, tmp_path_factory):
    """Every product splits four ways, so the ranks' FLOPs sum to the
    unsharded step's; the MoE families' routers excepted, which each model
    rank runs whole over its data shard's tokens: (M - 1) times 2 T d E
    FLOPs a product, four products a layer (forward, rematerialized
    forward, two backward)."""
    ranks = _ranks(arch, jax_steps, tmp_path_factory)
    _, _, flops = _unsharded(arch, "sgd", jax_steps[arch]["path"])
    c = tp_config(arch, **FAMILIES[arch][0])
    extra = 0
    if c.uses_moe:
        extra = (M - 1) * c.num_layers * 4 * 2 * (4 * 32) * c.d_model * c.num_experts
    assert sum(r["steps"]["sgd"]["flops"] for r in ranks) == flops + extra
    assert len({r["steps"]["sgd"]["flops"] for r in ranks}) == 1
