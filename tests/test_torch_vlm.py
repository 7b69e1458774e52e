"""The VLM family (Pixtral-12B) in the port's model against the JAX
package's, on the pixtral_12b smoke config and on its hd-160 variant (the
full model's head dim, ``head_dim=160``), with the same weights
(repro_torch.convert), CPU, float32, JAX at matmul precision "highest".
Stated tolerance: 1e-5 absolute on logits and on the loss.

Covered: the training forward and loss with vision inputs (embeddings that
replace the token embedding where ``vision_mask`` is set); a prefill of
all but the last token and a decode step of the last one against the full
forward (the reference's tests/test_arch_smoke.py consistency test), and
against JAX's steps; and at hd 160, a ragged prefill chunk with vision
inputs and two decode ticks with a dead lane, dense and paged, against
JAX's steps on its jnp attention and on its Pallas kernels in interpret
mode (the port's CPU path is the kernels' plain versions, which take any
head dim)."""
import dataclasses
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
ATOL = 1e-5
MAX_SEQ = 32
VARIANTS = {"smoke": {}, "hd160": {"head_dim": 160}}


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@functools.lru_cache(maxsize=None)
def _jax(variant, backend="jnp"):
    """The JAX model and params (task tables randomized so per-task gathers
    show), built once per variant and backend."""
    jm = JaxLM(dataclasses.replace(jax_get(ARCH, smoke=True), attn_backend=backend,
                                   **VARIANTS[variant]))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params["task"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                      for k, v in params["task"].items()}
    return jm, params


def _pair(variant):
    jm, params = _jax(variant)
    cfg = dataclasses.replace(get(ARCH, smoke=True), attn_backend="plain", **VARIANTS[variant])
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _batch(cfg, seed=1, b=2, s=16):
    """Token ids, next-token labels, task ids, and vision embeddings over
    each row's first quarter (row 1's over its second quarter too)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.zeros((b, s), bool)
    mask[:, : s // 4] = True
    mask[1, s // 4: s // 2] = True
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "task_ids": (np.arange(b) % cfg.num_tasks).astype(np.int32),
            "vision_embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
            "vision_mask": mask}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _close(want, got):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_and_loss_match_jax_with_vision_inputs(variant):
    jm, params, tm = _pair(variant)
    batch = _batch(tm.cfg)
    jl, _ = jax.jit(jm.forward)(params, _j(batch))
    (jloss, _) = jax.jit(jm.loss_fn)(params, _j(batch))
    with torch.no_grad():
        tl, taux = tm.forward(_t(batch))
        loss, metrics = tm.loss_fn(_t(batch))
    assert tl.shape == (2, 16, tm.cfg.vocab_size) and float(taux) == 0.0
    _close(jl, tl)
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    # the vision inputs reach the logits: text only changes them
    text = {k: v for k, v in _t(batch).items() if not k.startswith("vision")}
    with torch.no_grad():
        assert (tm.forward(text)[0] - tl).abs().max() > 1e-3


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_after_prefill_matches_the_full_forward(variant):
    """prefill(t_0 .. t_{n-2}) then decode(t_{n-1}), each with its vision
    inputs, give the full forward's last logits (the reference's
    consistency test, atol 1e-5 in f32) and JAX's decode logits."""
    jm, params, tm = _pair(variant)
    seq = 8
    full = _batch(tm.cfg, seed=2, s=seq)
    full["vision_mask"][:, seq - 1] = [True, False]  # row 0's decode token is an image patch
    with torch.no_grad():
        want, _ = tm.forward(_t(full))
    head = {k: (v[:, : seq - 1] if v.ndim > 1 else v) for k, v in full.items()
            if k != "labels"}
    last = {k: (v[:, seq - 1: seq] if v.ndim > 1 else v) for k, v in full.items()
            if k != "labels"}
    caches = tm.init_cache(2, MAX_SEQ)
    tm.prefill_step(_t(head), caches, torch.zeros(2, dtype=torch.int32),
                    torch.ones((2, seq - 1), dtype=torch.bool))
    got, _ = tm.decode_step(_t(last), caches, seq - 1)
    _close(want[:, -1], got[:, 0])
    _, jc = jax.jit(lambda p, b: jm.prefill(p, b, MAX_SEQ))(params, _j(head))
    jd, _ = jax.jit(jm.decode_step)(params, _j(last), jc, seq - 1)
    _close(jd, got)


def _table(spec, b):
    """Shuffled physical blocks, each slot's own, the rest of the row 0."""
    rng = np.random.default_rng(3)
    per = spec.max_blocks_per_slot
    ids = rng.permutation(spec.num_blocks - 1)[: b * per] + 1
    return ids.reshape(b, per).astype(np.int32)


@pytest.mark.parametrize("paged", [False, True])
def test_hd160_steps_match_jax_jnp_and_pallas_kernels(paged):
    """At hd 160: a ragged prefill chunk (one row with no valid token, the
    vision inputs over part of the chunk) and two decode ticks with a dead
    lane, dense and paged (shuffled block tables): the live rows' logits
    against JAX's steps with attn_backend "jnp" and "pallas" (the flash
    prefill and decode kernels in interpret mode)."""
    _, _, tm = _pair("hd160")
    cfg = tm.cfg
    b, c = 3, 8
    rng = np.random.default_rng(4)
    chunk = {"tokens": rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32),
             "task_ids": np.array([0, 3, 1], np.int32),
             "vision_embeds": rng.standard_normal((b, c, cfg.d_model)).astype(np.float32),
             "vision_mask": np.arange(c)[None, :] < np.array([[3], [5], [0]])}
    pos0 = np.array([0, 5, 9], np.int32)
    valid = np.arange(c)[None, :] < np.array([8, 3, 0])[:, None]
    live = np.array([True, False, True])
    tspec = tserve.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    jspec = jserve.PagingSpec.sized(8, MAX_SEQ, 4 * MAX_SEQ) if paged else None
    table = _table(tspec, b) if paged else None

    def run(step_prefill, step_decode, caches, to, tables):
        out = []
        logits, caches = step_prefill(to(chunk), caches, to(pos0), to(valid), tables)
        out.append(np.asarray(logits)[:2])
        pos = pos0 + valid.sum(1).astype(np.int32)
        nxt = np.asarray(logits)[:, 0].argmax(-1).astype(np.int32)[:, None]
        for _ in range(2):
            # a text position: zero embeddings under a False mask, as the
            # reference's make_step_batch gives a decode tick
            step = {"tokens": nxt, "task_ids": chunk["task_ids"],
                    "vision_embeds": np.zeros((b, 1, cfg.d_model), np.float32),
                    "vision_mask": np.zeros((b, 1), bool)}
            logits, caches = step_decode(to(step), caches, to(pos), to(live), tables)
            out.append(np.asarray(logits)[live])
            pos = pos + live
            nxt = np.asarray(logits)[:, 0].argmax(-1).astype(np.int32)[:, None]
        return out

    def to_t(x):
        return _t(x) if isinstance(x, dict) else torch.from_numpy(np.asarray(x))

    with torch.no_grad():
        got = run(lambda bt, cc, p, v, tb: tm.prefill_step(bt, cc, p, v, block_tables=tb),
                  lambda bt, cc, p, lv, tb: tm.decode_step(bt, cc, p, live=lv, block_tables=tb),
                  tm.init_cache(b, MAX_SEQ, tspec), to_t,
                  None if table is None else torch.from_numpy(table))
    for backend in ("jnp", "pallas"):
        jm, params = _jax("hd160", backend)

        def to_j(x):
            return _j(x) if isinstance(x, dict) else jnp.asarray(x)

        want = run(lambda bt, cc, p, v, tb: jm.prefill_step(params, bt, cc, p, v,
                                                            block_tables=tb),
                   lambda bt, cc, p, lv, tb: jm.decode_step(params, bt, cc, p, live=lv,
                                                           block_tables=tb),
                   jm.init_cache(b, MAX_SEQ, jspec), to_j,
                   None if table is None else jnp.asarray(table))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=backend)
