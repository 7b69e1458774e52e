"""Parity of the port's model (repro_torch.models.TransformerLM) with the
JAX package's on the olmo_1b, qwen2_5_14b, phi4_mini_3_8b (tied head),
qwen1_5_110b (QKV bias) and mixtral_8x22b (MoE) smoke configs, with the JAX
weights converted through repro_torch.convert: decode_step / prefill_step
logits and caches (atol 1e-4, CPU, float32), the cache-write edge cases,
id clamping and slot reset, and the device policy of the entry point."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params, params_from_numpy  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402

ATOL = 1e-4
ARCHS = ["olmo_1b", "qwen2_5_14b", "phi4_mini_3_8b", "qwen1_5_110b", "mixtral_8x22b"]


def _pair(arch, backend="plain"):
    """JAX model + params (task tables randomized so per-task gathers show)
    and the port's model holding the same weights on the CPU."""
    jm = JaxLM(jax_get(arch, smoke=True))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params["task"] = {
        k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
        for k, v in params["task"].items()
    }
    cfg = dataclasses.replace(get(arch, smoke=True), attn_backend=backend)
    tm = load_numpy_params(TransformerLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


def _caches_close(jc, tc, atol=ATOL):
    jk, jv = jc[0]["slot0"]  # (P, B, S, KVH, hd) stacked over layers
    for i, (k, v) in enumerate(tc):
        _close(jk[i], k, atol)
        _close(jv[i], v, atol)


@pytest.mark.parametrize("backend", ["plain", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits_match_jax(arch, backend):
    jm, params, tm = _pair(arch, backend)
    b, s, c = 3, 24, 5
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (b, c)).astype(np.int32)
    tids = np.array([0, 3, tm.cfg.num_tasks], np.int32)  # the last: clamped null id
    pos = np.array([0, 4, 10], np.int32)
    valid = np.array([[1] * 5, [1, 1, 1, 0, 0], [0] * 5], bool)  # ragged + idle row
    jc, tc = jm.init_cache(b, s), tm.init_cache(b, s)
    jb = {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(tids)}
    tb = {"tokens": torch.from_numpy(toks), "task_ids": torch.from_numpy(tids)}
    jl, jc = jm.prefill_step(params, jb, jc, jnp.asarray(pos), jnp.asarray(valid))
    tl, tc = tm.prefill_step(tb, tc, torch.from_numpy(pos), torch.from_numpy(valid))
    assert tl.shape == (b, 1, tm.cfg.vocab_size) and tl.dtype == torch.float32
    _close(jl, tl)
    _caches_close(jc, tc)
    for step in range(3):  # decode ticks with a dead slot
        nxt = rng.integers(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
        p2 = (pos + valid.sum(1) + step).astype(np.int32)
        live = np.array([True, True, False])
        jl, jc = jm.decode_step(params, {"tokens": jnp.asarray(nxt), "task_ids": jnp.asarray(tids)},
                                jc, jnp.asarray(p2), live=jnp.asarray(live))
        tl, tc = tm.decode_step({"tokens": torch.from_numpy(nxt), "task_ids": torch.from_numpy(tids)},
                                tc, torch.from_numpy(p2), live=torch.from_numpy(live))
        _close(jl, tl)
    _caches_close(jc, tc)


def test_cache_write_dead_slot_and_out_of_range():
    """Dead slots and positions past the cache write nothing — a position
    >= S is dropped, not clamped onto the last row — exactly as the JAX
    masked-select writes."""
    rng = np.random.default_rng(2)
    b, s = 4, 6
    cache = rng.standard_normal((b, s, 2, 3)).astype(np.float32)
    new = rng.standard_normal((b, 1, 2, 3)).astype(np.float32)
    pos = np.array([2, 5, 6, 9], np.int32)  # rows 2 and 3 past the cache
    live = np.array([True, False, True, True])
    want = JaxLM._cache_write(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos),
                              jnp.asarray(live))
    got = torch.from_numpy(cache.copy())
    TransformerLM._cache_write(got, torch.from_numpy(new), torch.from_numpy(pos),
                               torch.from_numpy(live))
    _close(want, got, atol=0)
    np.testing.assert_array_equal(got[1:].numpy(), cache[1:])  # only slot 0 changed
    np.testing.assert_array_equal(got[0, 2].numpy(), new[0, 0])


def test_cache_write_slab_edges():
    """Invalid lanes write nothing, lanes past the cache write nothing, and
    the in-place scatter equals the JAX masked select."""
    rng = np.random.default_rng(3)
    b, s, c = 3, 8, 4
    cache = rng.standard_normal((b, s, 2, 3)).astype(np.float32)
    new = rng.standard_normal((b, c, 2, 3)).astype(np.float32)
    pos = np.array([0, 6, 3], np.int32)  # slot 1 crosses the end of the cache
    valid = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]], bool)
    want = JaxLM._cache_write_slab(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos),
                                   jnp.asarray(valid))
    got = torch.from_numpy(cache.copy())
    TransformerLM._cache_write_slab(got, torch.from_numpy(new), torch.from_numpy(pos),
                                    torch.from_numpy(valid))
    _close(want, got, atol=0)
    np.testing.assert_array_equal(got[2].numpy(), cache[2])  # idle row untouched
    np.testing.assert_array_equal(got[1, :6].numpy(), cache[1, :6])


@pytest.mark.parametrize("arch", ARCHS)
def test_out_of_range_ids_clamp_like_jax(arch):
    jm, params, tm = _pair(arch)
    v, t = tm.cfg.vocab_size, tm.cfg.num_tasks
    toks = np.array([[-3], [v + 7], [v - 1]], np.int32)
    tids = np.array([-1, t + 5, t], np.int32)
    pos = np.zeros(3, np.int32)
    jl, _ = jm.decode_step(params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(tids)},
                           jm.init_cache(3, 4), jnp.asarray(pos))
    tl, _ = tm.decode_step({"tokens": torch.from_numpy(toks), "task_ids": torch.from_numpy(tids)},
                           tm.init_cache(3, 4), torch.from_numpy(pos))
    assert torch.isfinite(tl).all()
    _close(jl, tl)


def test_reset_slot_state_zeroes_only_reset_rows():
    _, _, tm = _pair("qwen2_5_14b")
    caches = tm.init_cache(3, 5)
    for k, v in caches:
        k.fill_(1.0)
        v.fill_(2.0)
    tm.reset_slot_state(caches, np.array([False, True, False]))
    for k, v in caches:
        assert (k[1] == 0).all() and (v[1] == 0).all()
        assert (k[[0, 2]] == 1).all() and (v[[0, 2]] == 2).all()


def test_converted_state_covers_every_weight():
    jm = JaxLM(jax_get("qwen2_5_14b", smoke=True))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tm = TransformerLM(get("qwen2_5_14b", smoke=True), device="cpu")
    state = params_from_numpy(tree, tm.cfg)
    assert set(state) == set(tm.state_dict())
    np.testing.assert_array_equal(
        state["layers.1.attn.wq"].numpy(), tree["stages"][0]["slot0"]["attn"]["wq"][1]
    )


def test_entry_point_raises_without_cuda(monkeypatch):
    """No device given means CUDA; without a GPU the entry point raises
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get("olmo_1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(cfg, device="cuda")
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"


def test_unported_block_patterns_and_backends_raise():
    """Every block pattern the reference admits builds (a mixed stack runs
    each kind's block, tests/test_torch_mixed_patterns.py); an unknown kind,
    backend or arch raises."""
    cfg = get("olmo_1b", smoke=True)
    model = TransformerLM(dataclasses.replace(cfg, pattern=("attn", "mamba")), device="cpu")
    assert model.kinds == ("attn", "mamba")
    with pytest.raises(ValueError, match="block kind"):
        dataclasses.replace(cfg, pattern=("attn", "rnn")).validate()
    with pytest.raises(ValueError, match="attn_backend"):
        dataclasses.replace(cfg, attn_backend="pallas").validate()
    with pytest.raises(ValueError, match="unknown arch"):
        get("llama_3_70b")  # in neither package's registry


def test_configs_mirror_jax_values():
    for arch in ARCHS + ["multitask_linreg", "deepseek_v2_236b", "xlstm_350m", "pixtral_12b",
                         "musicgen_large"]:
        for smoke in (False, True):
            j, t = jax_get(arch, smoke=smoke), get(arch, smoke=smoke)
            for f in dataclasses.fields(t):
                if f.name != "attn_backend":
                    assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
