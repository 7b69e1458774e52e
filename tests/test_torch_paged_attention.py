"""The port's paged attention against the JAX package's, on the CPU in
float32 with inputs made from a numpy seed: the plain paged decode /
prefill versions against ``paged_*_reference`` and against the Pallas
kernels in interpret mode (block sizes 8 and 16, shuffled physical ids,
G 1 and 5, sliding window, ragged positions, a stale position past the
table, poisoned null and unmapped blocks), atol 3e-5 as the dense sweeps;
``cached_attend`` on paged pools through both backends; the in-place paged
writes ``paged_cache_write(_slab)`` against the JAX scatters (exact, every
block but the null block 0, which dead lanes share and nothing reads); and
paged ``prefill_step`` + ``decode_step`` logits and pools of the model
against JAX on both smoke configs (atol 1e-4, the dense model tests')."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.kernels.decode_attention.kernel import paged_decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import paged_decode_attention_reference  # noqa: E402
from repro.kernels.prefill_attention.kernel import paged_prefill_attention_pallas  # noqa: E402
from repro.kernels.prefill_attention.ref import paged_prefill_attention_reference  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.serve.paging import PagingSpec as JaxPagingSpec  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.convert import load_numpy_params  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    paged_decode_attention_reference as t_paged_decode_ref,
)
from repro_torch.kernels.prefill_attention import ops as pre_ops  # noqa: E402
from repro_torch.kernels.prefill_attention.ref import (  # noqa: E402
    paged_prefill_attention_reference as t_paged_prefill_ref,
)
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serve.paging import PagingSpec  # noqa: E402

ATOL = 3e-5
MODEL_ATOL = 1e-4


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(), atol=atol, rtol=0)


def _pools(rng, b, mb, bs, kvh, hd, poison=True):
    """Pools of b * mb + 3 blocks with shuffled physical ids. Slot 0 maps
    only its first half (the rest stays 0: unmapped), and, poisoned, the
    null block and every block no slot maps hold large values."""
    nb = b * mb + 3  # two spare blocks nobody maps
    k = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    ids = rng.permutation(np.arange(1, nb))[: b * mb]
    table = ids.reshape(b, mb).astype(np.int32)
    table[0, mb // 2:] = 0
    if poison:
        unmapped = np.setdiff1d(np.arange(nb), table)
        k[unmapped], v[unmapped] = 30.0, -30.0
    return k, v, table


# ------------------------------------------------------- plain versions
DECODE_CASES = [  # bs, mb, kvh, g, pos, window
    (8, 6, 2, 1, [20, 47, 5], None),
    (16, 4, 2, 5, [9, 63, 30], None),
    (8, 8, 1, 5, [23, 40, 64], 16),
    (16, 5, 4, 1, [3, 79, 79 + 50], 8),  # slot 2 past the table: sees no key
]


@pytest.mark.parametrize("bs,mb,kvh,g,pos,window", DECODE_CASES)
def test_paged_decode_plain_matches_jax(bs, mb, kvh, g, pos, window):
    rng = np.random.default_rng(bs * 100 + mb)
    b, hd = 3, 32
    k, v, table = _pools(rng, b, mb, bs, kvh, hd)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    pos = np.array(pos, np.int32)
    got = t_paged_decode_ref(*map(torch.from_numpy, (q, k, v, table, pos)), window=window)
    args = tuple(map(jnp.asarray, (q, k, v, table, pos)))
    _close(paged_decode_attention_reference(*args, window=window), got)
    _close(paged_decode_attention_pallas(*args, window=window, interpret=True), got)
    # the model-layout op on CPU tensors is the plain version, not a launch
    before = dec_ops.paged_decode_attention.launches
    op = dec_ops.paged_decode_attention(
        torch.from_numpy(q).reshape(b, 1, kvh * g, hd), *map(torch.from_numpy, (k, v, table, pos)),
        window=window)
    _close(got.reshape(b, 1, kvh * g, hd).numpy(), op, atol=0)
    assert dec_ops.paged_decode_attention.launches == before


PREFILL_CASES = [  # bs, mb, kvh, g, c, pos, window
    (8, 6, 2, 1, 5, [0, 40, 13], None),
    (16, 4, 2, 5, 3, [9, 60, 30], None),
    (8, 8, 1, 5, 8, [23, 40, 56], 16),
    (16, 5, 2, 2, 4, [3, 77, 60], 8),  # slot 1 runs past the table
]


@pytest.mark.parametrize("bs,mb,kvh,g,c,pos,window", PREFILL_CASES)
def test_paged_prefill_plain_matches_jax(bs, mb, kvh, g, c, pos, window):
    rng = np.random.default_rng(bs * 100 + mb + c)
    b, hd = 3, 32
    k, v, table = _pools(rng, b, mb, bs, kvh, hd)
    q = rng.standard_normal((b, kvh, c, g, hd)).astype(np.float32)
    pos = np.array(pos, np.int32)
    got = t_paged_prefill_ref(*map(torch.from_numpy, (q, k, v, table, pos)), window=window)
    args = tuple(map(jnp.asarray, (q, k, v, table, pos)))
    _close(paged_prefill_attention_reference(*args, window=window), got)
    _close(paged_prefill_attention_pallas(*args, window=window, interpret=True), got)
    qm = torch.from_numpy(q).permute(0, 2, 1, 3, 4).reshape(b, c, kvh * g, hd)
    before = pre_ops.paged_prefill_attention.launches
    op = pre_ops.paged_prefill_attention(qm, *map(torch.from_numpy, (k, v, table, pos)),
                                         window=window)
    _close(got.permute(0, 2, 1, 3, 4).reshape(b, c, kvh * g, hd).numpy(), op, atol=0)
    assert pre_ops.paged_prefill_attention.launches == before


def test_out_of_range_table_ids_clamp_like_jax():
    """The JAX gather pool[block_tables] clamps ids past the pool; the
    port's plain version clamps the same way instead of raising."""
    rng = np.random.default_rng(4)
    k, v, table = _pools(rng, 2, 4, 8, 2, 32, poison=False)
    table[1, 1] = 500  # past the pool
    q = rng.standard_normal((2, 2, 3, 32)).astype(np.float32)
    pos = np.array([10, 30], np.int32)
    want = paged_decode_attention_reference(*map(jnp.asarray, (q, k, v, table, pos)))
    _close(want, t_paged_decode_ref(*map(torch.from_numpy, (q, k, v, table, pos))))


@pytest.mark.parametrize("c,window", [(1, None), (1, 12), (5, None), (5, 12)])
def test_cached_attend_paged_backends_match_jax(c, window):
    """cached_attend with block_tables on CPU tensors: the "kernel" backend
    (paged ops -> plain versions) and the "plain" backend (gather_pages +
    masked softmax) both equal the JAX jnp path over the gathered view."""
    rng = np.random.default_rng(9)
    b, bs, mb, kvh, g, hd = 3, 8, 5, 2, 3, 32
    k, v, table = _pools(rng, b, mb, bs, kvh, hd)
    q = rng.standard_normal((b, c, kvh * g, hd)).astype(np.float32)
    pos = np.array([3, 39 - c, 17], np.int32)
    want = jattn.cached_attend(*map(jnp.asarray, (q, k, v, pos)), sliding_window=window,
                               backend="jnp", block_tables=jnp.asarray(table))
    t = list(map(torch.from_numpy, (q, k, v, pos)))
    for backend in ("kernel", "plain"):
        got = tattn.cached_attend(*t, sliding_window=window, backend=backend,
                                  block_tables=torch.from_numpy(table))
        _close(want, got)


# ---------------------------------------------------------------- writes
def test_paged_cache_write_matches_jax():
    """One token per slot: live slots land at their (block, row); a dead
    slot, including one whose stale pos points past its table, lands in the
    null block 0 only."""
    rng = np.random.default_rng(5)
    nb, bs = 9, 4
    pool = rng.standard_normal((nb, bs, 2, 3)).astype(np.float32)
    new = rng.standard_normal((4, 1, 2, 3)).astype(np.float32)
    table = np.array([[3, 1, 0], [5, 2, 4], [6, 7, 8], [0, 0, 0]], np.int32)
    pos = np.array([5, 11, 40, 2], np.int32)  # slot 2 stale, far past its table
    live = np.array([True, True, False, False])
    want = np.asarray(jattn.paged_cache_write(
        *map(jnp.asarray, (pool, new, pos, table)), jnp.asarray(live)))
    got = torch.from_numpy(pool.copy())
    out = tattn.paged_cache_write(got, *map(torch.from_numpy, (new, pos, table, live)))
    assert out is got  # in place
    np.testing.assert_array_equal(got[1:].numpy(), want[1:])
    np.testing.assert_array_equal(got[1, 1].numpy(), new[0, 0])  # pos 5 -> block 1 row 1
    np.testing.assert_array_equal(got[4, 3].numpy(), new[1, 0])  # pos 11 -> block 4 row 3
    changed = np.flatnonzero((got.numpy() != pool).any(axis=(1, 2, 3)))
    assert set(changed) <= {0, 1, 4}
    # without a live mask every slot writes; slot 2's stale pos clips to its last block
    want = np.asarray(jattn.paged_cache_write(*map(jnp.asarray, (pool, new, pos, table))))
    got = torch.from_numpy(pool.copy())
    tattn.paged_cache_write(got, *map(torch.from_numpy, (new, pos, table)))
    np.testing.assert_array_equal(got[1:].numpy(), want[1:])


def test_paged_cache_write_slab_matches_jax():
    """A (B, C) slab: valid lanes cross block boundaries, invalid lanes and
    all-False rows go to the null block 0, nothing else moves."""
    rng = np.random.default_rng(6)
    nb, bs, c = 10, 4, 5
    pool = rng.standard_normal((nb, bs, 2, 3)).astype(np.float32)
    new = rng.standard_normal((3, c, 2, 3)).astype(np.float32)
    table = np.array([[2, 5, 7], [9, 1, 0], [3, 4, 6]], np.int32)
    pos = np.array([2, 1, 30], np.int32)  # slot 2: stale pos past its table
    valid = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0], [0, 0, 0, 0, 0]], bool)
    want = np.asarray(jattn.paged_cache_write_slab(
        *map(jnp.asarray, (pool, new, pos, table, valid))))
    got = torch.from_numpy(pool.copy())
    tattn.paged_cache_write_slab(got, *map(torch.from_numpy, (new, pos, table, valid)))
    np.testing.assert_array_equal(got[1:].numpy(), want[1:])
    changed = np.flatnonzero((got.numpy() != pool).any(axis=(1, 2, 3)))
    assert set(changed) <= {0, 2, 5, 9}
    np.testing.assert_array_equal(got[5, 2].numpy(), new[0, 4])  # pos 6 -> block 5 row 2


# ----------------------------------------------------------------- model
def _pair(arch, backend):
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


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("backend", ["plain", "kernel"])
@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_5_14b"])
def test_paged_prefill_then_decode_logits_match_jax(arch, backend, bs):
    """Paged prefill of a ragged (B, C) chunk then decode ticks with a dead
    slot, through shuffled block tables: logits and every mapped pool block
    equal JAX's."""
    jm, params, tm = _pair(arch, backend)
    b, c, max_seq = 3, 6, 32
    spec = PagingSpec.sized(bs, max_seq, 3 * max_seq)
    jspec = JaxPagingSpec.sized(bs, max_seq, 3 * max_seq)
    rng = np.random.default_rng(1)
    ids = rng.permutation(np.arange(1, spec.num_blocks))
    table = ids[: b * spec.max_blocks_per_slot].reshape(b, -1).astype(np.int32)
    toks = rng.integers(0, tm.cfg.vocab_size, (b, c)).astype(np.int32)
    tids = np.array([0, 3, tm.cfg.num_tasks], np.int32)
    pos = np.array([0, 7, 13], np.int32)
    valid = np.array([[1] * 6, [1, 1, 1, 0, 0, 0], [0] * 6], bool)
    jc, tc = jm.init_cache(b, max_seq, jspec), tm.init_cache(b, max_seq, spec)
    assert tc[0][0].shape == (spec.num_blocks, bs, tm.cfg.num_kv_heads, tm.cfg.head_dim)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jl, jc = jm.prefill_step(params, {"tokens": jnp.asarray(toks), "task_ids": jnp.asarray(tids)},
                             jc, jnp.asarray(pos), jnp.asarray(valid), block_tables=jt)
    tl, tc = tm.prefill_step({"tokens": torch.from_numpy(toks), "task_ids": torch.from_numpy(tids)},
                             tc, torch.from_numpy(pos), torch.from_numpy(valid), block_tables=tt)
    _close(jl[:2], tl[:2], MODEL_ATOL)  # slot 2 has no valid token: discarded
    live = np.array([True, True, False])
    for step in range(3):
        nxt = rng.integers(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
        p2 = (pos + valid.sum(1) + step).astype(np.int32)
        jl, jc = jm.decode_step(params, {"tokens": jnp.asarray(nxt),
                                         "task_ids": jnp.asarray(tids)},
                                jc, jnp.asarray(p2), live=jnp.asarray(live), block_tables=jt)
        tl, tc = tm.decode_step({"tokens": torch.from_numpy(nxt),
                                 "task_ids": torch.from_numpy(tids)},
                                tc, torch.from_numpy(p2), live=torch.from_numpy(live),
                                block_tables=tt)
        _close(jl[:2], tl[:2], MODEL_ATOL)
    jk, jv = jc[0]["slot0"]  # (P, NB, BS, KVH, hd) stacked over layers
    for i, (k, v) in enumerate(tc):
        _close(jk[i][1:], k[1:], MODEL_ATOL)  # every block but the null block
        _close(jv[i][1:], v[1:], MODEL_ATOL)


def test_paged_reset_leaves_pools_alone():
    _, _, tm = _pair("olmo_1b", "plain")
    spec = PagingSpec.sized(8, 16, 32)
    caches = tm.init_cache(2, 16, spec)
    for k, v in caches:
        k.fill_(1.0)
        v.fill_(2.0)
    assert tm.reset_slot_state(caches, np.array([True, True]), spec) is caches
    for k, v in caches:
        assert (k == 1).all() and (v == 2).all()


def test_paged_ops_reject_bad_shapes():
    """Shapes the paged ops do not take raise before anything runs."""
    q = torch.zeros(2, 1, 4, 32)
    pool = torch.zeros(5, 8, 2, 32)
    table = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_tables"):
        dec_ops.paged_decode_attention(q, pool, pool, table[:1], 0)  # B rows != 2
    with pytest.raises(ValueError, match="pools"):
        dec_ops.paged_decode_attention(q, pool, pool[:, :4], table, 0)
    with pytest.raises(ValueError, match="KVH"):
        dec_ops.paged_decode_attention(torch.zeros(2, 3, 4, 32), pool, pool, table, 0)  # C != 1
    with pytest.raises(ValueError, match="KVH"):
        pre_ops.paged_prefill_attention(torch.zeros(2, 3, 3, 32), pool, pool, table, 0)
