"""bfloat16 parity of the port with the JAX package on the olmo_1b,
qwen2_5_14b and multitask_lm smoke configs (CPU, JAX weights at bf16 from
PRNGKey(0), carried across by repro_torch.convert).

The reference is JAX evaluated op by op (``jax.disable_jit``): one rounding
to bf16 after each operation of the jaxpr, as the port computes. Under
``jit`` XLA's CPU fusion keeps some elementwise chains in float32
(``--xla_allow_excess_precision``, on by default), which moves ~60 % of a
block's bf16 outputs by an ulp, and no op-by-op program can follow it
(scripts/bf16_parity.py prints the port against both).

Gates: SiLU at bf16 equals ``jax.nn.silu`` bit for bit (``F.silu``, the
port's form before the repair, does not); the ``forward`` logits within
max |diff| 0.05 and mean |diff| 5e-3 (measured 1.4e-3..3.5e-3; ``F.silu``
gave 5.8e-3..6.3e-3); greedy serving of 4 prompts x 16 tokens equal token
for token, except that a row may split where JAX's top-2 logits lie within
0.03 (a bf16 near-tie), and is compared no further after its split."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

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
from repro_torch.models.layers import silu  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request  # noqa: E402

ARCHS = ["olmo_1b", "qwen2_5_14b", "multitask_lm"]
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


def _greedy(batcher_cls, req_cls, toks, num_tasks, *args):
    """Greedy tokens and each step's logits row."""
    rows = {}

    def keep(req, row):
        rows[(req.uid, len(req.out))] = np.asarray(row, np.float32).copy()
        return int(np.argmax(row))

    bt = batcher_cls(*args, num_slots=ROWS, max_seq=PROMPT + NEW, prefill_chunk=4,
                     sample_fn=keep)
    for i, t in enumerate(toks):
        bt.submit(req_cls(uid=i, tokens=t, max_new=NEW, task_id=i % num_tasks))
    return {r.uid: [int(x) for x in r.out] for r in bt.run()}, rows


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_greedy_match_jax(arch):
    jm = JaxLM(jax_get(arch, smoke=True), dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get(arch, smoke=True), attn_backend="plain")
    tm = load_numpy_params(TransformerLM(cfg, device="cpu", dtype=torch.bfloat16),
                           jax.tree.map(np.asarray, params))
    assert tm.embed.dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32),
             "task_ids": np.arange(4, dtype=np.int32) % cfg.num_tasks}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (ROWS, PROMPT)).astype(np.int32)
    with jax.disable_jit():
        jl, _ = jm.forward(params, {k: jnp.asarray(v) for k, v in batch.items()})
        want, jrows = _greedy(JaxBatcher, JaxRequest, toks, cfg.num_tasks, jm, params)
    with torch.no_grad():
        tl, _ = tm.forward({k: torch.from_numpy(v) for k, v in batch.items()})
    diff = np.abs(np.asarray(jl, np.float32) - tl.numpy())
    assert diff.max() <= LOGITS_MAX and diff.mean() <= LOGITS_MEAN, (diff.max(), diff.mean())

    got, _ = _greedy(ContinuousBatcher, Request, toks, cfg.num_tasks, tm)
    assert sorted(got) == sorted(want)
    for uid in want:
        for t, (a, b) in enumerate(zip(want[uid], got[uid], strict=True)):
            if a != b:
                top2 = np.sort(jrows[(uid, t)])[-2:]
                margin = float(top2[1] - top2[0])
                assert margin < TIE, (uid, t, a, b, margin)
                break
