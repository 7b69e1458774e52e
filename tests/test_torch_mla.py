"""DeepSeek-V2's multi-head latent attention (MLA) in the port
(repro_torch.models.attention: init_mla, mla_full, mla_decode) against the
JAX package's (repro.models.attention), on the CPU in float32 with JAX at
matmul precision "highest": the same weights (the JAX init, carried over
through numpy) and inputs (numpy, seeded). Stated tolerance: atol 2e-5,
rtol 1e-5.

Covered: the parameter shapes and dtypes; the materialized training path
(``mla_full``, at a query chunk that divides S and at one that does not);
the absorbed decode at C = 1 and C = 8 with per-slot positions, over dense
caches and over paged pools read through ``gather_pages``; the backend
matrix (``resolve_attn_backend``, mirroring tests/test_serve_backend.py);
and that an MLA model on the kernel backend never reaches the GQA
attention dispatcher."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels.runtime import gather_pages, resolve_attn_backend  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serve import PagingSpec  # noqa: E402

ATOL, RTOL = 2e-5, 1e-5
D = 96
DIMS = dict(n_heads=4, qk_nope=16, qk_rope=8, v_dim=12, kv_lora=32)
THETA = 1e4


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _params(seed=0):
    """(JAX params, the same as torch tensors)."""
    jp = jattn.init_mla(jax.random.PRNGKey(seed), D, jattn.MLADims(**DIMS), jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _close(want, got):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_mla_shapes_and_dtypes(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jattn.init_mla(jax.random.PRNGKey(0), D, jattn.MLADims(**DIMS), jdt)
    got = tattn.init_mla(D, tattn.MLADims(**DIMS), dtype, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == dtype, k
        # dense_init's law: std 1/sqrt(fan_in) (fan_in the leading axis)
        assert abs(float(got[k].float().std()) * v.shape[0] ** 0.5 - 1) < 0.1, k


@pytest.mark.parametrize("q_chunk", [8, 1024])
def test_mla_full_matches_jax(q_chunk):
    """Training path: the heads up-projected from the latent, causal
    attention at query width qk_nope + qk_rope; the output and the
    (c_kv, k_rope) it would cache."""
    jp, tp = _params()
    rng = np.random.default_rng(1)
    b, s = 2, 24
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    jo, (jc, jr) = jattn.mla_full(jp, jnp.asarray(x), jattn.MLADims(**DIMS), jnp.asarray(pos),
                                  THETA, q_chunk=q_chunk)
    to, (tc, tr) = tattn.mla_full(tp, torch.from_numpy(x), tattn.MLADims(**DIMS),
                                  torch.from_numpy(pos), THETA, q_chunk=q_chunk)
    for want, got in ((jo, to), (jc, tc), (jr, tr)):
        _close(want, got)
    assert tuple(tr.shape) == (b, s, DIMS["qk_rope"])


def _caches(rng, b, s):
    r, dr = DIMS["kv_lora"], DIMS["qk_rope"]
    return (rng.standard_normal((b, s, r)).astype(np.float32),
            rng.standard_normal((b, s, dr)).astype(np.float32))


@pytest.mark.parametrize("c", [1, 8])
def test_mla_decode_matches_jax_dense(c):
    """The absorbed decode over dense latent caches, per-slot positions
    (one slot at 0: a single visible row)."""
    jp, tp = _params()
    rng = np.random.default_rng(2)
    b, s = 3, 40
    x = rng.standard_normal((b, c, D)).astype(np.float32)
    cc, rc = _caches(rng, b, s)
    pos = np.array([s - c, 0, 17], np.int32)
    want = jattn.mla_decode(jp, jnp.asarray(x), jattn.MLADims(**DIMS), jnp.asarray(cc),
                            jnp.asarray(rc), jnp.asarray(pos), THETA)
    got = tattn.mla_decode(tp, torch.from_numpy(x), tattn.MLADims(**DIMS),
                           torch.from_numpy(cc), torch.from_numpy(rc), torch.from_numpy(pos),
                           THETA)
    _close(want, got)


@pytest.mark.parametrize("c", [1, 8])
def test_mla_decode_through_gather_pages_matches_jax_and_dense(c):
    """Paged: the latent pools (NB, BS, r) and (NB, BS, qk_rope) read
    through shuffled block tables; JAX's ``gather_pages`` view and the
    port's give the same output, which is the dense caches' output."""
    jp, tp = _params()
    rng = np.random.default_rng(3)
    b, bs, mb = 3, 8, 5
    nb = 1 + b * mb
    x = rng.standard_normal((b, c, D)).astype(np.float32)
    cpool, rpool = _caches(rng, nb, bs)
    table = rng.permutation(np.arange(1, nb))[: b * mb].reshape(b, mb).astype(np.int32)
    pos = np.array([mb * bs - c, 3, 20], np.int32)
    jview = [jattn.gather_pages(jnp.asarray(p), jnp.asarray(table)) for p in (cpool, rpool)]
    want = jattn.mla_decode(jp, jnp.asarray(x), jattn.MLADims(**DIMS), *jview,
                            jnp.asarray(pos), THETA)
    tt = torch.from_numpy(table)
    tview = [gather_pages(torch.from_numpy(p), tt) for p in (cpool, rpool)]
    got = tattn.mla_decode(tp, torch.from_numpy(x), tattn.MLADims(**DIMS), *tview,
                           torch.from_numpy(pos), THETA)
    _close(want, got)
    dense = tattn.mla_decode(tp, torch.from_numpy(x), tattn.MLADims(**DIMS),
                             *(v.contiguous() for v in tview), torch.from_numpy(pos), THETA)
    assert torch.equal(got, dense)


def test_resolve_attn_backend_matrix():
    """The reference's matrix with the port's names: "kernel" serves GQA
    and becomes "plain" for MLA; an unknown name raises."""
    assert resolve_attn_backend("kernel") == "kernel"
    assert resolve_attn_backend("plain") == "plain"
    assert resolve_attn_backend("kernel", mla=True) == "plain"
    assert resolve_attn_backend("plain", mla=True) == "plain"
    with pytest.raises(ValueError, match="attn_backend"):
        resolve_attn_backend("pallas")


def test_mla_model_never_reaches_the_gqa_dispatcher(monkeypatch):
    """An MLA model on the kernel backend serves a prefill chunk and a
    decode tick, dense and paged, without calling ``cached_attend``: its
    query width (qk_nope + qk_rope) is no kernel instantiation, and the
    absorbed decode has no K/V heads to stream."""
    cfg = dataclasses.replace(get("deepseek_v2_236b", smoke=True), attn_backend="kernel")
    model = TransformerLM(cfg, device="cpu", seed=0)

    def refuse(*a, **k):
        raise AssertionError("an MLA layer reached cached_attend")

    monkeypatch.setattr(tattn, "cached_attend", refuse)
    spec = PagingSpec.sized(8, 32, 64)
    for paging in (None, spec):
        caches = model.init_cache(2, 32, paging)
        assert tuple(caches[0][0].shape[-1:]) == (cfg.kv_lora,)
        assert tuple(caches[0][1].shape[-1:]) == (cfg.qk_rope,)
        table = None
        if paging is not None:
            table = torch.arange(1, 1 + 2 * spec.max_blocks_per_slot,
                                 dtype=torch.int32).reshape(2, -1)
        toks = torch.ones((2, 4), dtype=torch.int32)
        valid = torch.ones((2, 4), dtype=torch.bool)
        logits, _ = model.prefill_step({"tokens": toks}, caches, torch.zeros(2), valid,
                                       block_tables=table)
        logits2, _ = model.decode_step({"tokens": toks[:, :1]}, caches, torch.full((2,), 4),
                                       block_tables=table)
        assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
