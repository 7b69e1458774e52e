"""Parity of the port's training forward (repro_torch.models.TransformerLM
.forward / .loss_fn, models.attention.causal_attend) with the JAX
package's, on the olmo_1b, qwen2_5_14b, multitask_lm, phi4_mini_3_8b (tied
head) and qwen1_5_110b (QKV bias) smoke configs, CPU,
float32, JAX at matmul precision "highest", the same weights through
repro_torch.convert: logits (atol 1e-4), the loss with an out-of-range
label (rtol 1e-5), every parameter's gradient against jax.grad (atol 1e-5,
rtol 1e-4), causal_attend's GQA / window / chunking, remat on against off,
and the serving steps against the port's own forward."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.models.attention import causal_attend as jax_causal_attend  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params, params_from_numpy  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models.attention import causal_attend  # noqa: E402

ARCHS = ["olmo_1b", "qwen2_5_14b", "multitask_lm", "phi4_mini_3_8b", "qwen1_5_110b"]
B, S = 3, 24


def _pair(arch, **overrides):
    """JAX model + params (task tables randomized so the per-task gathers
    and their grads show) and the port's model holding the same weights."""
    jm = JaxLM(dataclasses.replace(jax_get(arch, smoke=True), **overrides))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params["task"] = {
        k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
        for k, v in params["task"].items()
    }
    cfg = dataclasses.replace(get(arch, smoke=True), **overrides)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _batch(cfg, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "task_ids": (np.arange(b) % cfg.num_tasks).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jm, params, tm = _pair(arch)
    batch = _batch(tm.cfg)
    with jax.default_matmul_precision("highest"):
        jl, jaux = jax.jit(jm.forward)(params, _jax(batch))
    with torch.no_grad():
        tl, taux = tm.forward(_torch(batch))
    assert tl.shape == (B, S, tm.cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=1e-4, rtol=0)
    assert float(jaux) == float(taux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax_with_out_of_range_labels(arch):
    """A label outside [0, V) contributes a zero label logit (masked
    reduction), in both packages; it is not clamped onto a vocab row."""
    jm, params, tm = _pair(arch)
    batch = _batch(tm.cfg, seed=2)
    v = tm.cfg.vocab_size
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, 3], batch["labels"][1, 0], batch["labels"][2, -1] = v, -1, v + 9
    with jax.default_matmul_precision("highest"):
        jloss, jmet = jax.jit(jm.loss_fn)(params, _jax(batch))
    with torch.no_grad():
        tloss, tmet = tm.loss_fn(_torch(batch))
        clamped = dict(_torch(batch), labels=_torch(batch)["labels"].clamp(0, v - 1))
        closs, _ = tm.loss_fn(clamped)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["nll"]), float(jmet["nll"]), rtol=1e-5)
    assert float(tmet["aux"]) == 0.0
    assert abs(float(closs) - float(tloss)) > 1e-4  # clamping would change the loss


@pytest.mark.parametrize("arch", ARCHS)
def test_every_grad_matches_jax(arch):
    jm, params, tm = _pair(arch)
    batch = _batch(tm.cfg, seed=3)
    with jax.default_matmul_precision("highest"):
        jg = jax.jit(jax.grad(lambda p, b: jm.loss_fn(p, b)[0]))(params, _jax(batch))
    want = params_from_numpy(jax.tree.map(np.asarray, jg), tm.cfg)
    names = [n for n, _ in tm.named_parameters()]
    loss, _ = tm.loss_fn(_torch(batch))
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()])
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    if tm.cfg.tie_embeddings:  # the tied table takes grads from both uses
        assert "head" not in want and float(grads[names.index("embed")].abs().sum()) > 0


@pytest.mark.parametrize("case", [
    dict(s=32, h=8, kvh=2, window=None, q_chunk=8),   # GQA G = 4, 4 chunks
    dict(s=32, h=8, kvh=2, window=5, q_chunk=16),     # sliding window
    dict(s=30, h=8, kvh=2, window=None, q_chunk=8),   # 8 does not divide 30: one chunk
    dict(s=20, h=4, kvh=4, window=7, q_chunk=64),     # MHA, chunk wider than S
])
def test_causal_attend_matches_jax(case):
    rng = np.random.default_rng(4)
    b, hd = 2, 16
    q = rng.standard_normal((b, case["s"], case["h"], hd)).astype(np.float32)
    k = rng.standard_normal((b, case["s"], case["kvh"], hd)).astype(np.float32)
    v = rng.standard_normal((b, case["s"], case["kvh"], hd)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_causal_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 sliding_window=case["window"], q_chunk=case["q_chunk"])
    got = causal_attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        sliding_window=case["window"], q_chunk=case["q_chunk"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_causal_attend_bf16_matches_jax():
    """bf16 inputs: float32 scores, probabilities cast to bf16 before the
    second product, a bf16 result, as in the reference."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 16, n, 32)).astype(np.float32) for n in (8, 2, 2))
    want = jax_causal_attend(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), q_chunk=8)
    got = causal_attend(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), q_chunk=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("arch", ["olmo_1b", "multitask_lm"])
def test_remat_on_equals_off(arch):
    _, _, on = _pair(arch, remat=True)
    _, _, off = _pair(arch, remat=False)
    batch = _torch(_batch(on.cfg, seed=6))
    results = []
    for tm in (on, off):
        loss, _ = tm.loss_fn(batch)
        grads = torch.autograd.grad(loss, list(tm.parameters()))
        results.append((loss.detach(), grads))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_forward(arch):
    """prefill_step(t_0..t_{n-2}) then decode_step(t_{n-1}) give the port's
    own forward logits at those positions (the reference's
    test_prefill_decode_consistency)."""
    _, _, tm = _pair(arch)
    seq = 8
    batch = _torch(_batch(tm.cfg, seed=7, s=seq))
    with torch.no_grad():
        full, _ = tm.forward(batch)
    caches = tm.init_cache(B, seq)
    pre = {"tokens": batch["tokens"][:, : seq - 1], "task_ids": batch["task_ids"]}
    lp, caches = tm.prefill_step(pre, caches, torch.zeros(B, dtype=torch.int32),
                                 torch.ones(B, seq - 1, dtype=torch.bool))
    last = {"tokens": batch["tokens"][:, seq - 1:], "task_ids": batch["task_ids"]}
    ld, _ = tm.decode_step(last, caches, torch.full((B,), seq - 1, dtype=torch.int32))
    torch.testing.assert_close(lp[:, 0], full[:, seq - 2], atol=1e-4, rtol=0)
    torch.testing.assert_close(ld[:, 0], full[:, seq - 1], atol=1e-4, rtol=0)
