"""The VLM family (Pixtral-12B) served through the port's entry points
against the JAX package's, on the pixtral_12b smoke config with the same
weights (repro_torch.convert), CPU, float32, JAX at matmul precision
"highest": greedy tokens equal, request by request.

Covered: the batcher dense, paged and with a chunk budget (interleaved
prefill and decode in one dispatch), and ``ServeEngine.generate``, over
requests with vision inputs and text-only ones; the reference's own
extras tests (tests/test_serve_prefill.py: the vision inputs reach the
prefill dispatch, ``submit`` validates them); and the prefix cache, where
the port departs from the reference on purpose: two requests with the same
token ids and different images each get the tokens they get without the
cache (the JAX batcher serves the first image's cached K/V to the second),
while text-only requests still share their prefix."""
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402

ARCH = "pixtral_12b"
MAX_SEQ = 32
SIDES = ("jax", "torch")


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _models():
    jm = JaxLM(jax_get(ARCH, smoke=True))
    params = jm.init(jax.random.PRNGKey(0))
    tm = load_numpy_params(TransformerLM(get(ARCH, smoke=True), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _api(side):
    return jserve if side == "jax" else tserve


def _vision(cfg, rng, n):
    emb = rng.standard_normal((n, cfg.d_model)).astype(np.float32)
    msk = np.zeros(n, bool)
    msk[: n // 2] = True
    return {"vision_embeds": emb, "vision_mask": msk}


def _requests(side, lens=(5, 9, 3, 7, 11, 4), text_only=(2, 5), max_new=4, seed=0):
    """Requests with vision inputs over the first half of the prompt, but
    ``text_only`` ones without extras."""
    cfg = get(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
        extras = _vision(cfg, rng, n)
        reqs.append(_api(side).Request(uid=i, tokens=toks, max_new=max_new,
                                       task_id=i % cfg.num_tasks,
                                       extras=None if i in text_only else extras))
    return reqs


def _batcher(side, **kw):
    jm, params, tm = _models()
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_chunk", 4)
    if side == "jax":
        return jserve.ContinuousBatcher(jm, params, **kw)
    return tserve.ContinuousBatcher(tm, cuda_graphs=False, **kw)


def _drive(b, reqs):
    for r in reqs:
        b.submit(r)
    return {r.uid: [int(t) for t in r.out] for r in b.run()}


def _mode(side, mode):
    if mode == "paged":
        return {"paging": _api(side).PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ)}
    return {"chunk_budget": 6} if mode == "chunk_budget" else {}


@pytest.mark.parametrize("mode", ["dense", "paged", "chunk_budget"])
def test_batcher_greedy_tokens_match_jax(mode):
    """Six requests over two slots (slot reuse, ragged chunks, vision and
    text-only prompts): the JAX batcher's tokens and dispatch counts."""
    outs = {}
    for side in SIDES:
        b = _batcher(side, **_mode(side, mode))
        outs[side] = (_drive(b, _requests(side)), b.decode_dispatches, b.prefill_dispatches,
                      b.mixed_dispatches)
    assert outs["torch"] == outs["jax"]
    assert len(outs["jax"][0]) == 6


def test_generate_matches_jax():
    """``ServeEngine.generate`` over a (B, S0) batch with (B, S0, d) vision
    embeddings and a (B, S0) mask: JAX's engine's tokens."""
    jm, params, tm = _models()
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    b, s0 = 3, 7
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s0)).astype(np.int32),
             "task_ids": np.array([0, 1, 3], np.int32),
             "vision_embeds": rng.standard_normal((b, s0, cfg.d_model)).astype(np.float32),
             "vision_mask": rng.random((b, s0)) < 0.5}
    want = jserve.ServeEngine(jm, params, max_seq=MAX_SEQ, prefill_chunk=4).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, 5)
    got = tserve.ServeEngine(tm, max_seq=MAX_SEQ, prefill_chunk=4).generate(batch, 5)
    assert got.shape == (b, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_vlm_extras_reach_the_prefill_dispatch():
    """tests/test_serve_prefill.py on the port: wired extras (a) match the
    engine fed the same vision inputs token for token and (b) change the
    output against a text-only prompt."""
    _, _, tm = _models()
    reqs = _requests("torch", lens=(6, 9), text_only=())
    engine = tserve.ServeEngine(tm, max_seq=MAX_SEQ)
    refs = [engine.generate({"tokens": r.tokens[None], "task_ids": np.array([r.task_id]),
                             "vision_embeds": r.extras["vision_embeds"][None],
                             "vision_mask": r.extras["vision_mask"][None]},
                            r.max_new)[0].tolist() for r in reqs]
    outs = _drive(_batcher("torch"), reqs)
    assert [outs[i] for i in range(2)] == refs
    alone = _drive(_batcher("torch", num_slots=1),
                   [tserve.Request(uid=0, tokens=reqs[0].tokens, max_new=4,
                                   task_id=reqs[0].task_id)])
    assert alone[0] != refs[0]


def test_submit_validates_extras():
    """tests/test_serve_prefill.py on the port: misaligned or missing
    vision inputs, and extras on a model that is not a VLM, are refused
    with the reference's messages."""
    rng = np.random.default_rng(1)
    b = _batcher("torch", num_slots=1)
    bad, bad2 = _requests("torch", lens=(6, 6), text_only=())
    bad.extras["vision_mask"] = np.zeros(5, bool)
    with pytest.raises(ValueError, match="aligned with the prompt"):
        b.submit(bad)
    del bad2.extras["vision_embeds"]
    with pytest.raises(ValueError, match="vision_embeds"):
        b.submit(bad2)
    text = TransformerLM(get("qwen2_5_14b", smoke=True), device="cpu")
    req = tserve.Request(uid=2, tokens=np.arange(6, dtype=np.int32), max_new=2,
                         extras=_vision(text.cfg, rng, 6))
    with pytest.raises(ValueError, match="vlm"):
        tserve.ContinuousBatcher(text, num_slots=1, max_seq=MAX_SEQ).submit(req)


def _same_ids_requests(side, n=40):
    """Two requests with the same 40 token ids and different images, then
    two text-only requests with another 40 shared ids."""
    cfg = get(ARCH, smoke=True)
    rng = np.random.default_rng(7)
    ids, text = (rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for _ in range(2))
    api = _api(side)
    return [api.Request(uid=0, tokens=ids, max_new=6, extras=_vision(cfg, rng, n)),
            api.Request(uid=1, tokens=ids, max_new=6, extras=_vision(cfg, rng, n)),
            api.Request(uid=2, tokens=text, max_new=6),
            api.Request(uid=3, tokens=text, max_new=6)]


def test_prefix_cache_keeps_each_images_kv_apart():
    """One slot, 16-token blocks, ``prefix_cache=True``, 64-token slots: a
    request whose vision inputs mask any position in neither matches nor
    registers prefix blocks, so two requests with the same 40 ids and
    different images each get their no-cache tokens; the two text-only
    requests share 32 cached tokens and keep their no-cache tokens. The
    reference keys the trie on ids alone (repro/serve/paging.py
    ``_key_seq``): its second image request hits 32 cached tokens of the
    first image's K/V and returns the first request's tokens."""
    outs = {}
    for side in SIDES:
        for prefix in (False, True):
            spec = _api(side).PagingSpec.sized(16, 64, 256)
            b = _batcher(side, num_slots=1, max_seq=64, prefill_chunk=8, paging=spec,
                         prefix_cache=prefix)
            outs[side, prefix] = (_drive(b, _same_ids_requests(side)),
                                  b.prefix.hit_tokens if prefix else 0)
    alone, _ = outs["torch", False]
    assert alone == outs["jax", False][0]
    assert alone[0] != alone[1]  # the images change the tokens
    got, hits = outs["torch", True]
    assert got == alone and hits == 32  # only the text-only pair shares
    ref, ref_hits = outs["jax", True]
    assert ref[1] == alone[0] != alone[1] and ref_hits == 64  # the reference's fault
