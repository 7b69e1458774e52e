"""bfloat16 parity of the port with the JAX package on the olmo_1b,
qwen2_5_14b, multitask_lm, musicgen_large (GELU MLP, LayerNorm, 2
codebooks) and pixtral_12b (vision inputs) smoke configs (CPU, JAX weights
at bf16 from PRNGKey(0), carried across by repro_torch.convert).

The reference is JAX evaluated op by op (``jax.disable_jit``): one rounding
to bf16 after each operation of the jaxpr, as the port computes. Under
``jit`` XLA's CPU fusion keeps some elementwise chains in float32
(``--xla_allow_excess_precision``, on by default), which moves ~60 % of a
block's bf16 outputs by an ulp, and no op-by-op program can follow it
(scripts/bf16_parity.py prints the port against both).

Gates: SiLU at bf16 equals ``jax.nn.silu`` bit for bit (``F.silu``, the
port's form before the repair, does not), and so does the tanh GELU
(``F.gelu(approximate="tanh")`` rounds once and differs on more than a
tenth of its outputs); the ``forward`` logits within
max |diff| 0.05 and mean |diff| 5e-3 (measured 1.4e-3..3.5e-3; ``F.silu``
gave 5.8e-3..6.3e-3); greedy serving of 4 prompts x 16 tokens equal token
for token, except that a row may split where JAX's top-2 logits lie within
0.03 (a bf16 near-tie), and is compared no further after its split (an
audio row per codebook: the codebooks that split must be near-ties; the
JAX side serves codebook rows with a chunk budget, its one admission regime
that takes them, and the port does the same)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.serve import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models.layers import gelu, silu  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request  # noqa: E402

ARCHS = ["olmo_1b", "qwen2_5_14b", "multitask_lm", "musicgen_large", "pixtral_12b"]
LOGITS_MAX, LOGITS_MEAN = 0.05, 5e-3
TIE = 0.03  # a greedy split is allowed only where JAX's top-2 margin is below this
ROWS, PROMPT, NEW = 4, 8, 16


def test_silu_rounds_like_jax():
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32) * 4
    want = np.asarray(jax.jit(jax.nn.silu)(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(silu(xt).float().numpy(), want)
    assert (F.silu(xt).float().numpy() != want).mean() > 0.1  # the form before the repair
    xf = torch.from_numpy(x)
    assert torch.equal(silu(xf), F.silu(xf))  # float32 keeps F.silu
    np.testing.assert_allclose(silu(xf).numpy(), np.asarray(jax.nn.silu(x)), atol=1e-5, rtol=1e-6)


def test_gelu_rounds_like_jax():
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32) * 4
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(gelu(xt).float().numpy(), want)
    assert (F.gelu(xt, approximate="tanh").float().numpy() != want).mean() > 0.1
    xf = torch.from_numpy(x)
    assert torch.equal(gelu(xf), F.gelu(xf, approximate="tanh"))  # float32 keeps F.gelu
    np.testing.assert_allclose(gelu(xf).numpy(), np.asarray(jax.nn.gelu(x)), atol=1e-5,
                               rtol=1e-6)


def _greedy(batcher_cls, req_cls, toks, extras, cfg, *args):
    """Greedy tokens (a codebook row each step for audio) and each step's
    logits row."""
    rows = {}

    def keep(req, row):
        rows[(req.uid, len(req.out))] = np.asarray(row, np.float32).copy()
        return np.argmax(row, axis=-1)

    kw = {"chunk_budget": ROWS * PROMPT} if cfg.input_mode == "audio" else {}
    bt = batcher_cls(*args, num_slots=ROWS, max_seq=PROMPT + NEW, prefill_chunk=4,
                     sample_fn=keep, **kw)
    for i, t in enumerate(toks):
        bt.submit(req_cls(uid=i, tokens=t, max_new=NEW, task_id=i % cfg.num_tasks,
                          extras=extras[i]))
    return {r.uid: [np.asarray(x).tolist() for x in r.out] for r in bt.run()}, rows


def _inputs(cfg, rng, b, s):
    """Token ids ((b, s, K) for audio) and, for a VLM, vision inputs over
    each row's first half; the per-request extras of a VLM's rows."""
    shape = (b, s, cfg.num_codebooks) if cfg.input_mode == "audio" else (b, s)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    extras = [None] * b
    if cfg.input_mode == "vlm":
        batch["vision_embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch["vision_mask"] = np.zeros((b, s), bool)
        batch["vision_mask"][:, : s // 2] = True
        extras = [{"vision_embeds": batch["vision_embeds"][i],
                   "vision_mask": batch["vision_mask"][i]} for i in range(b)]
    return batch, extras


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_greedy_match_jax(arch):
    jm = JaxLM(jax_get(arch, smoke=True), dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get(arch, smoke=True), attn_backend="plain")
    tm = load_numpy_params(TransformerLM(cfg, device="cpu", dtype=torch.bfloat16),
                           jax.tree.map(np.asarray, params))
    assert tm.embed.dtype == torch.bfloat16
    batch, _ = _inputs(cfg, np.random.default_rng(1), 4, 32)
    batch["task_ids"] = np.arange(4, dtype=np.int32) % cfg.num_tasks
    prompts, extras = _inputs(cfg, np.random.default_rng(0), ROWS, PROMPT)
    toks = prompts["tokens"]
    with jax.disable_jit():
        jl, _ = jm.forward(params, {k: jnp.asarray(v) for k, v in batch.items()})
        want, jrows = _greedy(JaxBatcher, JaxRequest, toks, extras, cfg, jm, params)
    with torch.no_grad():
        tl, _ = tm.forward({k: torch.from_numpy(v) for k, v in batch.items()})
    diff = np.abs(np.asarray(jl, np.float32) - tl.numpy())
    assert diff.max() <= LOGITS_MAX and diff.mean() <= LOGITS_MEAN, (diff.max(), diff.mean())

    got, _ = _greedy(ContinuousBatcher, Request, toks, extras, cfg, tm)
    assert sorted(got) == sorted(want)
    for uid in want:
        for t, (a, b) in enumerate(zip(want[uid], got[uid], strict=True)):
            if a != b:
                split = np.flatnonzero(np.atleast_1d(np.asarray(a) != np.asarray(b)))
                top2 = np.sort(jrows[(uid, t)].reshape(-1, cfg.vocab_size)[split], axis=-1)
                margin = float((top2[:, -1] - top2[:, -2]).max())
                assert margin < TIE, (uid, t, a, b, margin)
                break
