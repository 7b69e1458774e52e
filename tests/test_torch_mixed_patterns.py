"""Mixed block patterns: the port's ``TransformerLM`` over stacks that mix
the six block kinds, against the JAX package's, which admits any pattern
(``repro.configs.base.ArchConfig.validate``) and groups it into stages.

Each case takes a smoke config and replaces its ``pattern`` (and depth):
dense/MoE interleaves and a shared block after an MoE layer (Mixtral, with
dropless capacity so the dispatch composition cannot move a token), mamba
and attention with and without the shared block (Zamba2), mLSTM with
attention and sLSTM (xLSTM), attention with the shared block (OLMo), and
one stack with a remainder stage (5 layers of a 3-kind pattern). The same
weights (the JAX ``init`` from PRNGKey(0), task tables randomized) go
through ``repro_torch.convert`` to the port. CPU, float32, JAX at matmul
precision "highest":

  * ``forward`` logits within atol 1e-4 of JAX's, the MoE aux loss too;
  * ``loss_fn`` gradients within 1e-4 of ``jax.grad``'s, relative to each
    leaf's largest entry;
  * a ragged prefill chunk then greedy decode ticks: every step's logits
    within 1e-4 of the port's own full forward at that position and of
    JAX's steps, the greedy tokens JAX's;
  * ``ServeEngine``, dense and paged, gives each request JAX's greedy
    tokens;
  * the adapter store's layout (an {"attn", "mlp"} pair per attention slot,
    an "out" pair per recurrent one, stage by stage) and trees equal JAX's
    store, and a ragged prefill chunk under a randomized store gives JAX's
    logits;
  * ``params_to_numpy`` gives back the JAX params tree exactly."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.core.graph import band_graph as jax_band_graph  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    adapters_from_numpy,
    load_numpy_params,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.core.graph import band_graph  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models.model import ATTN_KINDS  # noqa: E402
from repro_torch.serve import PagingSpec, ServeEngine, TaskAdapterStore  # noqa: E402

ATOL = 1e-4
GRAD_RTOL = 1e-4
CASES = [
    ("mixtral_8x22b", ("attn", "attn_moe"), 2),
    ("mixtral_8x22b", ("attn_moe", "shared_attn"), 2),
    ("zamba2_7b", ("attn", "mamba"), 2),
    ("zamba2_7b", ("mamba", "attn", "shared_attn"), 3),
    ("xlstm_350m", ("attn", "mlstm"), 2),
    ("xlstm_350m", ("mlstm", "attn", "slstm"), 3),
    ("olmo_1b", ("attn", "shared_attn"), 2),
    ("mixtral_8x22b", ("attn_moe", "attn", "shared_attn"), 5),  # + remainder stage
]
IDS = [f"{a.split('_')[0]}-{'-'.join(p)}-{n}" for a, p, n in CASES]
PROMPT_LENS = (5, 9, 3)  # a ragged prefill chunk; three requests over two engine slots
TASK_IDS = np.array([0, 2, 1], np.int32)
DECODE_TICKS = 4
MAX_SEQ = 32


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _overrides(arch, pattern, layers):
    over = {"pattern": pattern, "num_layers": layers}
    if "attn_moe" in pattern:  # dropless: no token competes for a slot
        over["capacity_factor"] = float(get(arch, smoke=True).num_experts)
    return over


@functools.lru_cache(maxsize=None)
def _pair(arch, pattern, layers):
    """(JAX model, JAX params with randomized task tables, the port's model
    holding the same weights on the CPU)."""
    over = _overrides(arch, pattern, layers)
    jm = JaxLM(dataclasses.replace(jax_get(arch, smoke=True), **over))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params["task"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                      for k, v in params["task"].items()}
    cfg = dataclasses.replace(get(arch, smoke=True), attn_backend="plain", **over)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _ragged(prompts):
    """(tokens (B, longest), valid (B, longest)) of a ragged prefill chunk."""
    longest = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), longest), np.int32)
    valid = np.zeros((len(prompts), longest), bool)
    for i, p in enumerate(prompts):
        toks[i, :len(p)], valid[i, :len(p)] = p, True
    return toks, valid


def _prompts(cfg):
    return [_tokens(cfg, (n,), 20 + i) for i, n in enumerate(PROMPT_LENS)]


@functools.lru_cache(maxsize=None)
def _jax_ref(arch, pattern, layers):
    """The JAX side of a case, each function jitted once: the forward of
    ``_batch``'s tokens (logits, aux), ``loss_fn`` and its gradient tree, and
    JAX's greedy continuation of ``_prompts`` (one ragged prefill chunk, then
    DECODE_TICKS decode ticks): (tokens (B, ticks + 1), every step's logits
    (ticks + 1, B, V))."""
    jm, params, tm = _pair(arch, pattern, layers)
    batch = {k: jnp.asarray(v) for k, v in _batch(tm.cfg).items()}

    def loss_and_forward(p):  # one program: XLA shares the forward
        return jm.loss_fn(p, batch)[0], jm.forward(p, batch)

    (loss, (logits, aux)), grads = jax.jit(jax.value_and_grad(loss_and_forward,
                                                              has_aux=True))(params)
    toks, valid = _ragged(_prompts(tm.cfg))
    b = len(toks)
    tids = jnp.asarray(TASK_IDS)
    caches = jm.init_cache(b, MAX_SEQ)
    step, caches = jax.jit(jm.prefill_step)(
        params, {"tokens": jnp.asarray(toks), "task_ids": tids}, caches,
        jnp.zeros(b, jnp.int32), jnp.asarray(valid))
    decode = jax.jit(jm.decode_step)
    pos = valid.sum(1).astype(np.int32)
    steps, out = [np.asarray(step)[:, 0]], []
    for _ in range(DECODE_TICKS):
        nxt = steps[-1].argmax(-1).astype(np.int32)
        out.append(nxt)
        step, caches = decode(params, {"tokens": jnp.asarray(nxt[:, None]), "task_ids": tids},
                              caches, jnp.asarray(pos))
        steps.append(np.asarray(step)[:, 0])
        pos = pos + 1
    out.append(steps[-1].argmax(-1).astype(np.int32))
    return {"logits": np.asarray(logits), "aux": float(aux), "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads), "tokens": np.stack(out, 1),
            "steps": np.stack(steps)}


def _batch(cfg):
    return {"tokens": _tokens(cfg, (2, 12), 2), "labels": _tokens(cfg, (2, 12), 3),
            "task_ids": np.array([1, 3], np.int32)}


@pytest.mark.parametrize("arch,pattern,layers", CASES, ids=IDS)
def test_forward_matches_jax(arch, pattern, layers):
    _, _, tm = _pair(arch, pattern, layers)
    ref = _jax_ref(arch, pattern, layers)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg).items()}
    with torch.no_grad():
        tl, ta = tm.forward(batch)
    np.testing.assert_allclose(tl.numpy(), ref["logits"], atol=ATOL, rtol=0)
    assert float(ta) == pytest.approx(ref["aux"], abs=ATOL)
    assert (float(ta) > 0) == ("attn_moe" in pattern)


@pytest.mark.parametrize("arch,pattern,layers", CASES, ids=IDS)
def test_loss_gradients_match_jax(arch, pattern, layers):
    _, _, tm = _pair(arch, pattern, layers)
    ref = _jax_ref(arch, pattern, layers)
    tm.zero_grad(set_to_none=True)
    tloss, _ = tm.loss_fn({k: torch.from_numpy(v) for k, v in _batch(tm.cfg).items()})
    tloss.backward()
    assert tloss.item() == pytest.approx(ref["loss"], rel=GRAD_RTOL)
    want = params_from_numpy(ref["grads"], tm.cfg)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_RTOL * scale + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("arch,pattern,layers", CASES, ids=IDS)
def test_prefill_then_decode_match_the_forward_and_jax(arch, pattern, layers):
    """A ragged prefill chunk (rows of 5, 9 and 3 valid tokens) then greedy
    decode ticks fed JAX's tokens: every step's logits within 1e-4 of JAX's
    steps and of the port's own full forward over each row's prompt and
    continuation; the greedy tokens JAX's."""
    _, _, tm = _pair(arch, pattern, layers)
    ref = _jax_ref(arch, pattern, layers)
    prompts = _prompts(tm.cfg)
    toks, valid = _ragged(prompts)
    b = len(prompts)
    tt = torch.from_numpy(TASK_IDS)
    caches = tm.init_cache(b, MAX_SEQ)
    logits, caches = tm.prefill_step({"tokens": torch.from_numpy(toks), "task_ids": tt}, caches,
                                     torch.zeros(b, dtype=torch.int32), torch.from_numpy(valid))
    steps = [logits[:, 0].numpy()]
    pos = torch.from_numpy(valid.sum(1).astype(np.int32))
    for t in range(DECODE_TICKS):
        nxt = torch.from_numpy(np.ascontiguousarray(ref["tokens"][:, t:t + 1]))
        logits, caches = tm.decode_step({"tokens": nxt, "task_ids": tt}, caches, pos)
        steps.append(logits[:, 0].numpy())
        pos = pos + 1
    steps = np.stack(steps)
    np.testing.assert_allclose(steps, ref["steps"], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(steps.argmax(-1).T, ref["tokens"])
    for i, p in enumerate(prompts):
        seq = np.concatenate([p, ref["tokens"][i, :DECODE_TICKS]])[None]
        with torch.no_grad():
            full, _ = tm.forward({"tokens": torch.from_numpy(seq), "task_ids": tt[i:i + 1]})
        np.testing.assert_allclose(steps[:, i], full[0, len(p) - 1:].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch,pattern,layers", CASES, ids=IDS)
def test_serve_engine_gives_jax_greedy_tokens(arch, pattern, layers, paged):
    """The three prompts over two slots (the third takes a reused slot),
    prefill chunks of 4: each request's tokens are JAX's greedy
    continuation of its prompt."""
    _, _, tm = _pair(arch, pattern, layers)
    ref = _jax_ref(arch, pattern, layers)
    paging = PagingSpec.sized(8, MAX_SEQ, pool_tokens=2 * MAX_SEQ) if paged else None
    engine = ServeEngine(tm, max_seq=MAX_SEQ, prefill_chunk=4, num_slots=2, paging=paging)
    got = engine.generate({"tokens": _prompts(tm.cfg), "task_ids": TASK_IDS}, DECODE_TICKS + 1)
    np.testing.assert_array_equal(got, ref["tokens"])


@pytest.mark.parametrize("arch,pattern,layers", CASES, ids=IDS)
def test_adapter_store_matches_jax(arch, pattern, layers):
    jm, params, tm = _pair(arch, pattern, layers)
    m = tm.cfg.num_tasks
    js = jserve.TaskAdapterStore(jm, jax_band_graph(m, 1), rank=4)
    ts = TaskAdapterStore(tm, band_graph(m, 1), rank=4)
    js.randomize(scale=0.3)
    adapters_from_numpy(ts, jax.tree.map(np.asarray, js.raw))
    for stage, (kinds, _, _) in zip(ts.raw["stages"], tm.cfg.stages()):
        for j, kind in enumerate(kinds):
            want = ["attn", "mlp"] if kind in ATTN_KINDS else ["out"]
            assert sorted(stage[f"slot{j}"]) == want, (j, kind)
    for tree, ref in ((ts.raw, js.raw), (ts.serving, js.serving)):
        got = list(tree_lib.paths(tree))
        want = list(tree_lib.paths(jax.tree.map(np.asarray, ref)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, w) in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w, atol=1e-6, rtol=1e-6, err_msg=p)
    toks, valid = _ragged(_prompts(tm.cfg))
    b = len(toks)
    jl, _ = jax.jit(jm.prefill_step)(
        params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(TASK_IDS)},
        jm.init_cache(b, MAX_SEQ), jnp.zeros(b, jnp.int32), jnp.asarray(valid),
        adapters=js.serving)
    tl, _ = tm.prefill_step({"tokens": torch.from_numpy(toks),
                             "task_ids": torch.from_numpy(TASK_IDS)}, tm.init_cache(b, MAX_SEQ),
                            torch.zeros(b, dtype=torch.int32), torch.from_numpy(valid),
                            adapters=ts.serving)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert np.abs(tl.numpy() - _jax_ref(arch, pattern, layers)["steps"][0][:, None]).max() > 1e-3


@pytest.mark.parametrize("arch,pattern,layers", CASES, ids=IDS)
def test_params_to_numpy_round_trips(arch, pattern, layers):
    _, params, tm = _pair(arch, pattern, layers)
    want = dict(tree_lib.paths(jax.tree.map(np.asarray, params)))
    got = dict(tree_lib.paths(params_to_numpy(tm)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if "shared_attn" in pattern:  # the one shared block has an MLP, as the reference's
        assert "shared_attn/mlp/wi" in got or "shared_attn/mlp/wg" in got
        assert not any(k.startswith("shared_attn/moe") for k in got)
