"""Tensor-parallel steps of the recurrent families over spawned gloo ranks,
CPU: Zamba2's Mamba2 hybrid on a 2 x 2 mesh and xLSTM on a 1 x 4 mesh,
each at a smoke size whose layout is the one the family's full config
takes on 16 x 16 (named in each test id):

  * zamba2_7b on 2 x 2: the smoke's 8 mamba heads, 1160 ``w_in`` columns
    and 640 conv channels split 580 and 320 a model rank, so rank 1 holds
    x's tail and all of B, C and dt, and neither split aligns with the 4
    heads a rank (Zamba2-7B: 14576 / 7296 over 16, 7 heads a rank); the
    shared attention block's 4 heads split 2 a rank;
  * xlstm_350m on 1 x 4 with one head: each model rank holds a quarter of
    the head's q / k / v columns, ``w_if``'s 2 columns stay whole, each
    rank holds one sLSTM gate, and the mLSTM C cache splits its key dim
    (xLSTM-350M: 4 heads and 8 gate columns over 16).

For each family, over four spawned ranks (tests/torch_dist.py): an SGD and
an AdamW step through ``sharding.sharded_step`` (xLSTM also under
``xlstm_parallel``) against the port's unsharded step from the same
weights (within 1e-5; AdamW by leaf norm) and against the JAX package's
plain step from its PRNGKey(0) weights; ``prefill_step`` then eight greedy
decode ticks on DTensor caches in the cache rules' layout against the
plain steps (logits and caches within 1e-5, the same tokens), with a slot
whose chunk has no valid token keeping its state bit for bit; no
all-gather over the model axis of a whole model-split weight but Mamba2's
``conv_w`` (read whole: route (b) of ``models/mamba2._on_heads``); the
ranks' product FLOPs summed equal the unsharded step's plus the stated
replicated parts; and the collectives of a step are the same at two
sequence lengths."""
import dataclasses
import pickle
from collections import Counter

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
    tp_model,
    tp_optimizer,
    tp_recurrent,
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
SEQ = 1024  # cache rows: the cache rules split attention caches of 1024 rows and more
BATCH1 = (None, None, "model")  # the dry run's constraints where B does not divide
LENS = [16, 10, 0, 5]  # each slot's valid prefix of the 16-token chunk: slot 2 has none
FAMILIES = {
    "zamba2_7b": ({}, (2, 2), "unaligned-columns-2x2"),
    "xlstm_350m": ({"num_heads": 1, "num_kv_heads": 1}, (1, 4), "quarter-head-1x4"),
}
IDS = [f"{a}-{FAMILIES[a][2]}" for a in FAMILIES]
# (arch, step key, overrides of the step's config)
STEPS = [("zamba2_7b", "sgd", {}), ("zamba2_7b", "adamw", {}),
         ("xlstm_350m", "sgd", {}), ("xlstm_350m", "adamw", {}),
         ("xlstm_350m", "sgd_parallel", {"xlstm_parallel": True})]
STEP_IDS = [f"{FAMILIES[a][2]}-{a}-{k}" for a, k, _ in STEPS]
SERVE = {
    "zamba2_7b": [("heads-split", {"batch": 4, "lens": LENS}),
                  ("batch1-seq-over-data", {"batch": 1, "lens": [16],
                                            "activation_sharding": BATCH1,
                                            "logits_sharding": BATCH1})],
    "xlstm_350m": [("key-split", {"batch": 4, "lens": LENS})],
}
SERVE_IDS = [(a, i, k) for a in SERVE for i, (k, _) in enumerate(SERVE[a])]


def _step_overrides(arch, key):
    extra = next(o for a, k, o in STEPS if a == arch and k == key)
    return dict(FAMILIES[arch][0], **extra)


def _jax_batch(cfg):
    out = {}
    for k, v in tp_batch(cfg).items():
        v = v.numpy()
        out[k] = jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
    return out


class _JaxSteps(dict):
    """Per family, made on first use: the JAX package's smoke weights from
    PRNGKey(0) (pickled for the ranks) and its plain jitted step's loss and
    updated weights for each of the family's steps, on the test's config
    and batch."""

    def __init__(self, root):
        super().__init__()
        self.root = root

    def __missing__(self, arch):
        rec = {"path": str(self.root / f"{arch}.pkl")}
        for a, key, extra in STEPS:
            if a != arch:
                continue
            overrides = _step_overrides(arch, key)
            cfg = dataclasses.replace(jax_get(arch, smoke=True), num_tasks=2, moe_groups=2,
                                      **overrides)
            model = JaxLM(cfg)
            opt = jax_sgd(1e-2) if key.startswith("sgd") else jax_adamw(3e-4)
            state = jax_init_state(model, opt, jax.random.PRNGKey(0))
            if key == "sgd":
                with open(rec["path"], "wb") as f:
                    pickle.dump(jax.tree.map(np.asarray, state.params), f)
            step = jax_make_train_step(model, opt, multitask=JaxGraphMultiTask(
                jax_band_graph(2, 1), eta=0.1, tau=1.0))
            new, metrics = jax.jit(step)(state, _jax_batch(tp_config(arch, **overrides)))
            rec[key] = (float(metrics["loss"]), jax.tree.map(np.asarray, new.params))
        self[arch] = rec
        return rec


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    return _JaxSteps(tmp_path_factory.mktemp("jax_tp_recurrent"))


_RANKS: dict = {}


def _ranks(arch, jax_steps, tmp_path_factory):
    """Rank 0 ... 3's records of ``tp_recurrent`` (the steps, the counted
    steps and every serving case), run once per family."""
    if arch not in _RANKS:
        overrides, mesh, _ = FAMILIES[arch]
        _RANKS[arch] = run_ranks(tp_recurrent, 4, tmp_path_factory.mktemp("tpr"), arch,
                                 overrides, jax_steps[arch]["path"], mesh,
                                 [c for _, c in SERVE[arch]], SEQ, timeout=240)
    return _RANKS[arch]


_UNSHARDED: dict = {}


def _unsharded(arch, key, params_path):
    """The port's unsharded step of the same config, weights and batch:
    loss, updated parameters, product FLOPs."""
    if (arch, key) not in _UNSHARDED:
        cfg = tp_config(arch, **_step_overrides(arch, key))
        model = tp_model(cfg, params_path)
        opt = tp_optimizer("sgd" if key.startswith("sgd") else "adamw")
        step = make_train_step(model, opt, GraphMultiTask(band_graph(2, 1), eta=0.1, tau=1.0))
        state = init_state(model, opt)
        (_, metrics), _, rec = record(lambda: step(state, tp_batch(cfg)), (state,), {})
        _UNSHARDED[arch, key] = (float(metrics["loss"]), {
            k: v.detach().numpy() for k, v in model.named_parameters()}, rec.flops)
    return _UNSHARDED[arch, key]


def _check_params(got, want, key):
    """SGD: every element within TOL; AdamW: each leaf's norm (a near-zero
    gradient summed in another order becomes a step of up to lr either
    way)."""
    assert set(got) == set(want)
    for k, v in want.items():
        if key.startswith("sgd"):
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL, err_msg=k)
        else:
            assert np.linalg.norm(got[k]) == pytest.approx(np.linalg.norm(v), rel=TOL), k


@pytest.mark.parametrize("arch,key,extra", STEPS, ids=STEP_IDS)
def test_tp_step_matches_the_unsharded_step(arch, key, extra, jax_steps, tmp_path_factory):
    ranks = _ranks(arch, jax_steps, tmp_path_factory)
    loss, want, _ = _unsharded(arch, key, jax_steps[arch]["path"])
    for r in ranks:
        assert r["steps"][key]["loss"] == pytest.approx(loss, rel=TOL)
        _check_params(r["steps"][key]["params"], want, key)


@pytest.mark.parametrize("arch,key,extra", STEPS, ids=STEP_IDS)
def test_tp_step_matches_the_jax_plain_step(arch, key, extra, jax_steps, tmp_path_factory):
    ranks = _ranks(arch, jax_steps, tmp_path_factory)
    loss, tree = jax_steps[arch][key]
    cfg = tp_config(arch, **_step_overrides(arch, key))
    want = {k: v.detach().numpy() for k, v in
            load_numpy_params(TransformerLM(cfg, device="cpu"), tree).named_parameters()}
    for r in ranks:
        assert r["steps"][key]["loss"] == pytest.approx(loss, rel=TOL)
        _check_params(r["steps"][key]["params"], want, key)


def _plain_serve(arch, index, jax_steps):
    spec = dict(SERVE[arch][index][1])
    b, lens = spec.pop("batch"), spec.pop("lens")
    cfg = dataclasses.replace(tp_config(arch, **FAMILIES[arch][0]), attn_backend="plain",
                              **spec)
    model = tp_model(cfg, jax_steps[arch]["path"])
    caches = tp_serve_caches(model, b, SEQ)
    before = [[t.clone().numpy() for t in e] for e in caches]
    return model, before, tp_serve(model, caches, cfg, b, SEQ, lens=lens)


@pytest.mark.parametrize("arch,index,case", SERVE_IDS,
                         ids=[f"{a}-{k}" for a, _, k in SERVE_IDS])
def test_tp_serving_matches_the_plain_steps(arch, index, case, jax_steps, tmp_path_factory):
    """prefill_step of a (B, 16) chunk, then eight greedy decode ticks (a
    lane dead on the third), on DTensor caches in the cache rules' layout:
    every step's logits and the caches, after the prefill and at the end,
    within 1e-5 of the plain steps', the same greedy tokens."""
    r = _ranks(arch, jax_steps, tmp_path_factory)[0]["serve"][index]
    _, _, want = _plain_serve(arch, index, jax_steps)
    assert len(r["logits"]) == len(want["logits"])
    for got, exp in zip(r["logits"], want["logits"]):
        np.testing.assert_allclose(got, exp, rtol=TOL, atol=TOL)
    for got, exp in zip(r["tokens"], want["tokens"]):
        np.testing.assert_array_equal(got, exp)
    for key in ("prefill_caches", "caches"):
        for got, exp in zip(r[key], want[key]):
            for g, w in zip(got, exp):
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_invalid_tokens_leave_a_slot_bit_identical(arch, jax_steps, tmp_path_factory):
    """Slot 2's prefill chunk has no valid token: after the tensor-parallel
    prefill every cache of it (the recurrent states through the layout
    exchanges, the shared attention's K/V) equals its seeded value bit for
    bit, as the plain prefill's does."""
    r = _ranks(arch, jax_steps, tmp_path_factory)[0]["serve"][0]
    _, before, want = _plain_serve(arch, 0, jax_steps)
    for got, exp, init in zip(r["prefill_caches"], want["prefill_caches"], before):
        for g, w, i in zip(got, exp, init):
            np.testing.assert_array_equal(w[2], i[2])
            np.testing.assert_array_equal(g[2], i[2])


# each cache entry's placements on the (data, model) mesh, per layer kind
LAYOUTS = {
    "zamba2_7b": {"mamba": ["(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Shard(dim=1))"],
                  "shared_attn": ["(Shard(dim=0), Shard(dim=2))"] * 2},
    "xlstm_350m": {"mlstm": ["(Shard(dim=0), Shard(dim=2))"] * 2 + ["(Shard(dim=0), Replicate())"],
                   "slstm": ["(Shard(dim=0), Shard(dim=2))"] * 3 + ["(Shard(dim=0), Replicate())"]},
}


@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_caches_take_the_rules_layouts(arch, jax_steps, tmp_path_factory):
    """The conv tail split over its channels (not the heads'), the SSM
    state over its heads, the attention K/V over their heads; the mLSTM C
    and n over their key dim, m whole; the sLSTM c, n, h over hd, m whole;
    at batch 1 the attention cache's sequence over the data ranks and its
    heads over the model ranks (Zamba2-7B's long_500k layout)."""
    serve = _ranks(arch, jax_steps, tmp_path_factory)[0]["serve"]
    kinds = TransformerLM(tp_config(arch, **FAMILIES[arch][0]), device="meta").kinds
    for kind, placed in zip(kinds, serve[0]["cache_placements"]):
        assert placed == LAYOUTS[arch][kind], (kind, placed)
    if arch == "zamba2_7b":
        kinds = list(kinds)
        att = serve[1]["cache_placements"][kinds.index("shared_attn")]
        assert att == ["(Shard(dim=1), Shard(dim=2))"] * 2, att
        assert serve[1]["cache_placements"][kinds.index("mamba")][1] == \
            "(Replicate(), Shard(dim=1))"


def _whole_weight_gathers(r, m, exempt=()):
    """The model-axis all-gathers whose output is the raw all-gather of a
    whole model-split weight (its fsdp-gathered local shard, m of them
    stacked on dim 0) or has the weight's full shape, but the weights named
    in ``exempt``."""
    forbidden = set()
    for name, (full, local) in r["gathered"].items():
        if len(full) >= 2 and tuple(full) != tuple(local) and \
                name.rsplit(".", 1)[-1] not in exempt:
            forbidden |= {tuple(full), (m * local[0],) + tuple(local[1:])}
    return [c for c in r["collectives"]
            if c[0] == "all-gather" and c[1] == "model" and tuple(c[2]) in forbidden]


@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_step_never_gathers_a_model_split_weight(arch, jax_steps, tmp_path_factory):
    """... but Mamba2's conv_w ((4, 640) at the smoke size; (4, 7296), 58
    KB in bfloat16 a layer, at Zamba2-7B's), which each rank reads whole:
    the exchanges move activations (all-to-all over the model axis)."""
    m = FAMILIES[arch][1][1]
    for r in _ranks(arch, jax_steps, tmp_path_factory):
        step = r["steps"]["sgd"]
        assert _whole_weight_gathers(step, m, exempt={"conv_w"}) == []
        assert any(c[:2] == ("all-to-all", "model") for c in step["collectives"])
        if arch == "zamba2_7b":
            gathered = [c for c in step["collectives"] if c[0] == "all-gather" and
                        c[1] == "model" and tuple(c[2]) in {(4 * m, 320), (4, 640)}]
            assert gathered  # conv_w's, the one exemption


def _replicated_flops(arch, key):
    """The product FLOPs of the unsharded step that the model ranks of the
    tensor-parallel step repeat, times the extra repetitions: every mamba
    layer's C·B products (B and C feed every head), for M - 1 more ranks;
    every sLSTM layer's recurrence (replicated), for M - 1; every mLSTM
    layer's gate product for its head's two columns and its q . n, for the
    M / nh - 1 more ranks that share the head. Four passes over each
    product (the forward, its rematerialization, two gradients), the
    sLSTM's first recurrent gradient excepted (the fresh state needs none)."""
    c = tp_config(arch, **_step_overrides(arch, key))
    m = FAMILIES[arch][1][1]
    b, t = tp_batch(c)["tokens"].shape
    kinds = c.layer_kinds()
    if arch == "zamba2_7b":
        chunk = c.mamba_chunk if t % c.mamba_chunk == 0 else t
        return (m - 1) * kinds.count("mamba") * 4 * 2 * b * t * chunk * c.ssm_state
    hd = c.d_model // c.num_heads
    slstm = 2 * b * 4 * c.num_heads * hd * hd * (4 * t - 1)
    d_inner = 2 * c.d_model
    mlstm = 4 * (2 * b * t * d_inner * 2 * c.num_heads + 2 * b * t * d_inner)
    return ((m - 1) * kinds.count("slstm") * slstm
            + (m // c.num_heads - 1) * kinds.count("mlstm") * mlstm)


@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_step_flops_sum_to_the_unsharded_step(arch, jax_steps, tmp_path_factory):
    """Every other product splits over the ranks, so the ranks' FLOPs sum
    to the unsharded step's plus the replicated parts
    (``_replicated_flops``); every rank does the same work."""
    ranks = _ranks(arch, jax_steps, tmp_path_factory)
    _, _, flops = _unsharded(arch, "sgd", jax_steps[arch]["path"])
    assert sum(r["steps"]["sgd"]["flops"] for r in ranks) == \
        flops + _replicated_flops(arch, "sgd")
    assert len({r["steps"]["sgd"]["flops"] for r in ranks}) == 1


@pytest.mark.parametrize("arch", list(FAMILIES), ids=IDS)
def test_tp_step_collectives_do_not_grow_with_the_sequence(arch, jax_steps, tmp_path_factory):
    """The SGD step's collectives (forward, rematerialized forward,
    backward) at 16 and 32 tokens: the same kinds and the same count of
    each — no collective inside the SSD's chunk loop or the xLSTM cells'
    time loops."""
    for r in _ranks(arch, jax_steps, tmp_path_factory):
        short, long = (r["counted"][t] for t in (16, 32))
        assert Counter(c[0] for c in short) == Counter(c[0] for c in long)
        assert len(short) == len(long) and any(c[0] == "all-to-all" for c in short)
