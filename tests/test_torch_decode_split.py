"""The arithmetic of the port's flash-decode kernel
(``csrc/decode_attention.cu`` with its tile body in
``csrc/attention_tile.cuh``), emulated on the CPU, against the JAX package's
flash decode: the kernel itself runs only on a GPU.

The emulation follows the kernel step by step: each slot's visible keys, in
32-key tiles (4 warps x 8-key chunks), are split into ``nsplit`` near-equal
runs of tiles from ``pos`` alone; inside a split each warp runs its own online
softmax over its 8-key chunk of every tile with the finite mask -1e30 (keys
past S take no part), the block merges its warps, and the merge of the
splits that had tiles gives ``M = max m_s``,
``out = sum e^{m_s - M} acc_s / max(sum e^{m_s - M} l_s, 1e-30)``. It is held
to ``decode_attention_pallas(interpret=True)`` and
``decode_attention_reference`` (and their paged counterparts, through the
plain ``gather_pages``) within 1e-5, for 1 to 16 splits, G 1, 4 and 5, hd 64
and 128, with a sliding window, and with a stale position whose row sees no
key and so averages every row. Zamba2's hd 112 runs at the block's padded
width (``padded_dim`` in the tile header: q, K and V zero past hd, the
output cut back to hd), dense and paged, with ragged S and positions at
the edges, held to the same references within 1e-5; Pixtral's hd 160 (G 4)
at its padded width of 256, dense with a window and paged."""
import functools
import math
import re

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_pallas,
    paged_decode_attention_pallas,
)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_reference,
    paged_decode_attention_reference,
)
from repro_torch.kernels.runtime import HEAD_DIMS, CSRC, gather_pages, scale_for  # noqa: E402

NEG_INF = -1e30
WARPS, CHUNK = 4, 8  # DECODE_WARPS and kChunk in attention_tile.cuh
TILE = WARPS * CHUNK  # kTileS: keys per tile, the unit of the split


def _key_range(pmin, pmax, s, window):
    """attention_tile.cuh::key_range: the keys a block of rows at positions
    pmin..pmax must visit; every key when some row sees none."""
    if pmin >= 0 and (window is None or pmax - window + 1 <= s - 1):
        lo = max(0, pmin - window + 1) if window else 0
        return lo, min(pmax, s - 1)
    return 0, s - 1


def _decode_split(p, s, window, nsplit, split):
    """decode_attention.cu::decode_split: tiles [t_begin, t_end) of split
    ``split`` and the number of splits that hold tiles."""
    lo, hi = _key_range(p, p, s, window)
    t_lo, ntiles = lo // TILE, hi // TILE - lo // TILE + 1
    per = math.ceil(ntiles / nsplit)
    t_begin = t_lo + split * per
    return t_begin, min(t_lo + ntiles, t_begin + per), math.ceil(ntiles / per)


def _merge(parts):
    """(m, l, acc) partials -> merged (m, l, acc): the block's merge of its
    warps and the combine kernel's merge of the splits are the same sum."""
    big_m = torch.stack([m for m, _, _ in parts]).max(0).values
    w = [torch.exp(m - big_m) for m, _, _ in parts]
    l_sum = sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
    acc = sum(wi[..., None] * pa for wi, (_, _, pa) in zip(w, parts))
    return big_m, l_sum, acc


def _warp(q, k, v, p, window, first, n, scale):
    """One warp's online softmax: chunks of CHUNK keys at first + u * TILE,
    u < n. q (KVH, G, hd); k, v (S, KVH, hd) of one slot; scale the
    wrapper's, 1 / sqrt of the unpadded head dim."""
    s = k.shape[0]
    kvh, g, hd = q.shape
    m = torch.full((kvh, g), NEG_INF)
    l = torch.zeros((kvh, g))
    acc = torch.zeros((kvh, g, hd))
    for u in range(n):
        keys = first + u * TILE + torch.arange(CHUNK)
        live = keys < s
        rows = keys.clamp(max=s - 1)
        kk = torch.where(live[:, None, None], k[rows], 0.0)  # zero-filled past S
        vv = torch.where(live[:, None, None], v[rows], 0.0)
        sc = torch.einsum("kgd,nkd->kgn", q, kk) * scale
        seen = keys <= p
        if window is not None:
            seen &= keys > p - window
        sc = torch.where(live & seen, sc, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.max(-1).values)
        e = torch.where(live, torch.exp(sc - m_new[..., None]), 0.0)
        a = torch.exp(m - m_new)
        l = a * l + e.sum(-1)
        acc = a[..., None] * acc + torch.einsum("kgn,nkd->kgd", e, vv)
        m = m_new
    return m, l, acc


def _padded_dim(hd):
    """attention_tile.cuh::padded_dim: the head dim a decode block computes
    at."""
    return 32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 else 256


def _split_merge(q, k, v, pos, window, nsplit):
    """The kernel's algorithm in plain torch. q (B, KVH, G, hd), k and v
    (B, S, KVH, hd), pos (B,) ints. Returns (B, KVH, G, hd). The block
    computes at the padded head dim, with zeros past hd."""
    hd = q.shape[-1]
    pad = _padded_dim(hd) - hd
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    out = torch.empty_like(q)
    s = k.shape[1]
    for bi in range(q.shape[0]):
        p = int(pos[bi])
        parts = []
        for sp in range(nsplit):
            t_begin, t_end, used = _decode_split(p, s, window, nsplit, sp)
            if t_begin >= t_end:
                assert sp >= used  # an empty split writes no partial
                continue
            warps = [_warp(q[bi], k[bi], v[bi], p, window, t_begin * TILE + w * CHUNK,
                           t_end - t_begin, scale_for(hd)) for w in range(WARPS)]
            parts.append(_merge(warps))
        assert len(parts) == used
        _, l_sum, acc = _merge(parts)
        out[bi] = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    if pad:
        assert not out[..., hd:].any()  # the zero dims the kernel never writes
    return out[..., :hd]


# (B, S, KVH, G, hd, pos, window): ragged positions at the start, in the
# middle and at the end of the cache (S 300: not a multiple of the tile);
# G 1 (OLMo-1B), 4 (multitask-LM, hd 64) and 5 (Qwen2.5-14B); a window. The
# stale case: slot 0's position 556 sees only kv > 540, past S, so its rows
# see no key and average all S rows (S is a multiple of the Pallas kernel's
# 256-key block, which it pads with zero keys a no-key row would average).
_CASES = [
    (3, 300, 2, 1, 128, (0, 150, 299), None),
    (3, 300, 2, 4, 64, (63, 299, 31), None),
    (2, 300, 2, 5, 128, (299, 17), 100),
    (3, 256, 2, 4, 64, (556, 40, 255), 16),
]
# paged: (B, max_blocks, block size, KVH, G, hd, pos, window)
_PAGED = [
    (3, 19, 16, 2, 4, 64, (0, 150, 299), None),
    (2, 32, 8, 2, 5, 128, (556, 200), 16),  # slot 0 sees no key: every row, null block too
]


# Zamba2-7B's hd 112 (MHA, G 1): ragged S 300, positions at 0, mid-cache
# and the last row; paged, 16-row pages with slot 0 half unmapped
_CASES_112 = [(3, 300, 2, 1, 112, (0, 150, 299), None)]
_PAGED_112 = [(2, 19, 16, 2, 1, 112, (303, 0), None)]
# Pixtral-12B's hd 160 (G 4): a window over a ragged S; paged, slot 0 half
# unmapped and slot 1 at its last row
_CASES_160 = [(2, 300, 2, 4, 160, (299, 40), 100)]
_PAGED_160 = [(2, 19, 16, 2, 4, 160, (150, 303), None)]
_DENSE_SETS = {"dense": _CASES, "hd112": _CASES_112, "hd160": _CASES_160}
_PAGED_SETS = {"paged": _PAGED, "hd112": _PAGED_112, "hd160": _PAGED_160}


@functools.lru_cache(maxsize=None)
def _case(i, cases="dense"):
    b, s, kvh, g, hd, pos, window = _DENSE_SETS[cases][i]
    rng = np.random.default_rng(60 + i)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    pos_np = np.asarray(pos, np.int32)
    args = tuple(map(jnp.asarray, (q, k, v, pos_np)))
    ref = np.asarray(decode_attention_reference(*args, window=window))
    pallas = np.asarray(decode_attention_pallas(*args, window=window, interpret=True))
    return (q, k, v, pos_np, window), ref, pallas


@functools.lru_cache(maxsize=None)
def _paged_case(i, cases="paged"):
    b, mb, bs, kvh, g, hd, pos, window = _PAGED_SETS[cases][i]
    rng = np.random.default_rng(80 + i)
    nb = b * mb + 1
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    k_pool = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    v_pool = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    table = (rng.permutation(nb - 1)[: b * mb] + 1).reshape(b, mb).astype(np.int32)
    table[0, mb // 2:] = 0  # unmapped pages point at the null block
    pos_np = np.asarray(pos, np.int32)
    args = tuple(map(jnp.asarray, (q, k_pool, v_pool, table, pos_np)))
    ref = np.asarray(paged_decode_attention_reference(*args, window=window))
    pallas = np.asarray(paged_decode_attention_pallas(*args, window=window, interpret=True))
    return (q, k_pool, v_pool, table, pos_np, window), ref, pallas


def _check(got, ref, pallas):
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("nsplit", range(1, 17))
@pytest.mark.parametrize("case", range(len(_CASES)))
def test_split_merge_matches_jax_decode(case, nsplit):
    (q, k, v, pos, window), ref, pallas = _case(case)
    got = _split_merge(*map(torch.from_numpy, (q, k, v)), pos, window, nsplit).numpy()
    _check(got, ref, pallas)


@pytest.mark.parametrize("nsplit", [1, 3, 16])
@pytest.mark.parametrize("case", range(len(_PAGED)))
def test_paged_split_merge_matches_jax_paged_decode(case, nsplit):
    """The paged kernel walks the slot's logical rows through the table:
    the same algorithm over ``gather_pages``' view."""
    (q, k_pool, v_pool, table, pos, window), ref, pallas = _paged_case(case)
    t = torch.from_numpy(table)
    k = gather_pages(torch.from_numpy(k_pool), t)
    v = gather_pages(torch.from_numpy(v_pool), t)
    got = _split_merge(torch.from_numpy(q), k, v, pos, window, nsplit).numpy()
    _check(got, ref, pallas)


@pytest.mark.parametrize("nsplit", [1, 3, 16])
def test_hd112_split_merge_matches_jax_decode(nsplit):
    """hd 112 at the block's padded width of 128, dense."""
    (q, k, v, pos, window), ref, pallas = _case(0, "hd112")
    got = _split_merge(*map(torch.from_numpy, (q, k, v)), pos, window, nsplit).numpy()
    _check(got, ref, pallas)


@pytest.mark.parametrize("nsplit", [1, 3])
def test_hd112_paged_split_merge_matches_jax_paged_decode(nsplit):
    """hd 112 over a pool: slot 0 at pos 303 reads past its mapped pages
    into the null block."""
    (q, k_pool, v_pool, table, pos, window), ref, pallas = _paged_case(0, "hd112")
    t = torch.from_numpy(table)
    k = gather_pages(torch.from_numpy(k_pool), t)
    v = gather_pages(torch.from_numpy(v_pool), t)
    got = _split_merge(torch.from_numpy(q), k, v, pos, window, nsplit).numpy()
    _check(got, ref, pallas)


@pytest.mark.parametrize("nsplit", [1, 3, 10])
def test_hd160_split_merge_matches_jax_decode(nsplit):
    """hd 160 at the block's padded width of 256 (two groups of 4 dims a
    lane in the kernel), dense, with a window."""
    (q, k, v, pos, window), ref, pallas = _case(0, "hd160")
    got = _split_merge(*map(torch.from_numpy, (q, k, v)), pos, window, nsplit).numpy()
    _check(got, ref, pallas)


@pytest.mark.parametrize("nsplit", [1, 3])
def test_hd160_paged_split_merge_matches_jax_paged_decode(nsplit):
    """hd 160 over a pool: slot 0 reads past its mapped pages into the null
    block."""
    (q, k_pool, v_pool, table, pos, window), ref, pallas = _paged_case(0, "hd160")
    t = torch.from_numpy(table)
    k = gather_pages(torch.from_numpy(k_pool), t)
    v = gather_pages(torch.from_numpy(v_pool), t)
    got = _split_merge(torch.from_numpy(q), k, v, pos, window, nsplit).numpy()
    _check(got, ref, pallas)


def test_row_without_keys_averages_every_row_across_splits():
    """Slot 0 of the stale case sees no key: the merge of 5 splits (every
    tile visited, each split's m at -1e30) gives the uniform average of all
    S value rows, as the reference's -1e30 mask does."""
    (q, k, v, pos, window), ref, _ = _case(3)
    got = _split_merge(*map(torch.from_numpy, (q, k, v)), pos, window, 5).numpy()
    want = v[0].mean(0)  # (KVH, hd)
    np.testing.assert_allclose(got[0], np.repeat(want[:, None], q.shape[2], 1),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ref[0], got[0], atol=1e-5, rtol=0)


def test_empty_splits_follow_the_filled_ones():
    """Splits are filled in order and the first empty one ends them, so the
    merge can count the used splits from pos alone: a slot at pos 40 has 2
    tiles, and 16 splits leave 14 empty."""
    spans = [_decode_split(40, 1024, None, 16, sp) for sp in range(16)]
    assert [(tb, te) for tb, te, _ in spans[:2]] == [(0, 1), (1, 2)]
    assert all(tb >= te for tb, te, _ in spans[2:])
    assert {used for _, _, used in spans} == {2}
    # a window moves the first tile: pos 700, window 256 -> keys 445..700
    tb, te, used = _decode_split(700, 1024, 256, 3, 0)
    assert (tb, te, used) == (445 // TILE, 445 // TILE + 3, 3)


def test_emulated_geometry_is_the_kernels():
    """The emulation's warps and chunk are the source's defaults."""
    src = (CSRC / "attention_tile.cuh").read_text()
    assert re.search(rf"#define DECODE_WARPS {WARPS}\b", src)
    assert re.search(rf"constexpr int kChunk = {CHUNK};", src)
    assert "return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;" in src
    assert [_padded_dim(hd) for hd in (32, 64, 112, 128, 160)] == [32, 64, 128, 128, 256]


def test_head_dims_are_the_sources_instantiations():
    """Every head dim the wrappers accept (``runtime.HEAD_DIMS``, 112 and
    160 among them) has a case in each dtype's switch of both attention
    sources, and no other does: adding a width opens no path for another
    (96 is refused before a launch)."""
    for name, macro in (("decode_attention.cu", "DECODE_CASE"),
                        ("decode_attention.cu", "GEOMETRY_CASE"),
                        ("prefill_attention.cu", "PREFILL_CASE")):
        src = (CSRC / name).read_text()
        for ty in ("float", "__nv_bfloat16"):
            found = re.findall(rf"case (\d+): {macro}\({ty}, (\d+)\);", src)
            assert [int(a) for a, _ in found] == list(HEAD_DIMS), (name, macro, ty)
            assert all(a == b for a, b in found)
    assert 112 in HEAD_DIMS and 160 in HEAD_DIMS and 96 not in HEAD_DIMS
