"""The arithmetic of the port's chunked flash-prefill kernel
(``csrc/prefill_attention.cu``), emulated on the CPU, against the JAX
package's prefill: the kernel itself runs only on a GPU.

(a) The split of each slot's visible key tiles across blocks and the merge
    of their partials: per split an online softmax over 64-key tiles with
    the finite mask -1e30, then ``M = max m_s``,
    ``out = sum e^{m_s - M} acc_s / max(sum e^{m_s - M} l_s, 1e-30)``, for 1
    to 8 splits, held to ``prefill_attention_reference`` and
    ``prefill_attention_pallas(interpret=True)`` within 1e-5, with and
    without a sliding window, including a row that sees no key.
(b) 3xTF32: operands rounded to TF32 (10 mantissa bits, round to nearest,
    ties away, as ``cvt.rna.tf32.f32``) through an int32 view, and
    ``a @ b = a_lo b_hi + a_hi b_lo + a_hi b_hi``. At OLMo-1B's prefill shape
    it stays within the kernel's f32 tolerance (2e-5) of the f32 plain
    version, where plain TF32 (``a_hi b_hi``) does not; bf16 operands are
    exact in TF32, so their products need fewer terms.

(c) Zamba2's hd 112, the first head dim that is no power of two: the split
    and merge at G 1 and C 32 with ragged S and positions at the edges,
    held to the same references; ``Plan<T, 112>::kMaxRows`` from the
    kernel's shared-memory arithmetic is a whole number of m16 tiles (64 in
    f32, 160 in bf16); the combine kernel's thread map (HD / 4 = 28 threads
    a row, 9 rows of a 256-thread block, 4 threads idle) writes every
    (row, dim) of a slab exactly once.
(d) Pixtral's hd 160 (G 4, C 8 of a windowed ragged S): the split and merge
    held to the same references; ``Plan<T, 160>::kMaxRows`` is 32 in f32
    and 112 in bf16 with 16-byte aligned rows; the combine kernel's map
    (40 threads a row, 6 rows of a 256-thread block, 16 threads idle)
    writes every (row, dim) of Pixtral's 128-row slab exactly once.

Both emulations live here, not in the package: the package has one prefill
kernel and its plain version."""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.prefill_attention.kernel import prefill_attention_pallas  # noqa: E402
from repro.kernels.prefill_attention.ref import prefill_attention_reference  # noqa: E402
from repro_torch.kernels.prefill_attention.ref import (  # noqa: E402
    prefill_attention_reference as t_prefill_ref,
)
from repro_torch.kernels.runtime import CSRC, scale_for  # noqa: E402

NEG_INF = -1e30
TILE = 64  # kTileK: keys per ring stage of the kernel


# ------------------------------------------------- (a) split and merge
def _key_range(pmin, pmax, s, window):
    """attention_tile.cuh::key_range: the keys a block of rows at positions
    pmin..pmax must visit; every key when some row sees none."""
    if pmin >= 0 and (window is None or pmax - window + 1 <= s - 1):
        lo = max(0, pmin - window + 1) if window else 0
        return lo, min(pmax, s - 1)
    return 0, s - 1


def _split_merge(q, k, v, pos, window, nsplit):
    """The kernel's algorithm in plain torch. q (B, KVH, C, G, hd), k and v
    (B, S, KVH, hd), pos (B,) ints. Returns (B, KVH, C, G, hd)."""
    b, kvh, c, g, hd = q.shape
    s = k.shape[1]
    scale = scale_for(hd)
    out = torch.empty_like(q)
    for bi in range(b):
        p = int(pos[bi])
        qr = q[bi].reshape(kvh, c * g, hd)
        qpos = p + torch.arange(c * g) // g  # row r is chunk token r // g
        lo, hi = _key_range(p, p + c - 1, s, window)
        t_lo, ntiles = lo // TILE, hi // TILE - lo // TILE + 1
        per = math.ceil(ntiles / nsplit)
        parts = []
        for sp in range(nsplit):
            t_begin, t_end = t_lo + sp * per, min(t_lo + ntiles, t_lo + (sp + 1) * per)
            if t_begin >= t_end:
                break  # an empty split writes no partial
            m = torch.full((kvh, c * g), NEG_INF)
            l = torch.zeros((kvh, c * g))
            acc = torch.zeros((kvh, c * g, hd))
            for t in range(t_begin, t_end):
                keys = torch.arange(t * TILE, min((t + 1) * TILE, s))
                sc = torch.einsum("krd,nkd->krn", qr, k[bi, keys]) * scale
                seen = keys[None, :] <= qpos[:, None]
                if window is not None:
                    seen &= keys[None, :] > qpos[:, None] - window
                sc = torch.where(seen[None], sc, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, sc.max(-1).values)
                e = torch.exp(sc - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = alpha * l + e.sum(-1)
                acc = alpha[..., None] * acc + torch.einsum("krn,nkd->krd", e, v[bi, keys])
                m = m_new
            parts.append((m, l, acc))
        big_m = torch.stack([pm for pm, _, _ in parts]).max(0).values
        w = [torch.exp(pm - big_m) for pm, _, _ in parts]
        num = sum(wi[..., None] * pa for wi, (_, _, pa) in zip(w, parts))
        den = sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
        out[bi] = (num / torch.clamp(den, min=1e-30)[..., None]).reshape(kvh, c, g, hd)
    return out


# (B, S, KVH, G, hd, C, pos, window): pos 0 beside a slot near the end; S
# 200 is not a multiple of the tile. With window 3 the (254) slot's last row
# sits at 258, reads only kv > 255 and so sees no key: it averages all S
# rows. (That case keeps S a multiple of the Pallas kernel's 256-key block:
# the Pallas kernel pads S with zero keys, which rows at or past S would see.)
_CASES = [
    (3, 256, 2, 4, 32, 5, (254, 0, 40), 3),
    (3, 200, 2, 2, 64, 8, (0, 150, 192), None),
    (2, 200, 1, 5, 32, 32, (3, 168), 64),
]


# Zamba2-7B's shape at a reduced cache: G 1, hd 112, C 32, S 300 (no multiple
# of the 64-key tile); slots at 0, mid-cache and with the chunk's last row at
# the cache's last row
_CASES_112 = [(3, 300, 2, 1, 112, 32, (0, 131, 268), None)]
# Pixtral-12B's G 4 at hd 160, C 8 (32 slab rows), a window over S 300
_CASES_160 = [(2, 300, 2, 4, 160, 8, (0, 250), 100)]
_SETS = {"all": _CASES, "hd112": _CASES_112, "hd160": _CASES_160}


@functools.lru_cache(maxsize=None)
def _case(i, cases="all"):
    b, s, kvh, g, hd, c, pos, window = _SETS[cases][i]
    rng = np.random.default_rng(40 + i)
    q = rng.standard_normal((b, kvh, c, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    pos_np = np.asarray(pos, np.int32)
    args = tuple(map(jnp.asarray, (q, k, v, pos_np)))
    ref = np.asarray(prefill_attention_reference(*args, window=window))
    pallas = np.asarray(prefill_attention_pallas(*args, window=window, interpret=True))
    return (q, k, v, pos_np, window), ref, pallas


@pytest.mark.parametrize("nsplit", range(1, 9))
@pytest.mark.parametrize("case", range(len(_CASES)))
def test_split_merge_matches_jax_prefill(case, nsplit):
    (q, k, v, pos, window), ref, pallas = _case(case)
    got = _split_merge(*map(torch.from_numpy, (q, k, v)), pos, window, nsplit).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


def test_row_without_keys_averages_every_row_across_splits():
    """The no-key row of case 0 (slot 0, chunk token 4) gets the uniform
    average of all S value rows from the merge of 4 splits, as the
    reference's -1e30 mask gives it."""
    (q, k, v, pos, window), ref, _ = _case(0)
    got = _split_merge(*map(torch.from_numpy, (q, k, v)), pos, window, 4).numpy()
    want = v[0].mean(0)  # (KVH, hd)
    np.testing.assert_allclose(got[0, :, 4], want[:, None, :].repeat(q.shape[3], 1),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ref[0, :, 4], got[0, :, 4], atol=1e-5, rtol=0)


# ---------------------------------------------------------- (b) 3xTF32
def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, through the int32 view of its bits: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a, b, products):
    """a @ b (batched, last two dims) from TF32 parts: 3 = a_lo b_hi +
    a_hi b_lo + a_hi b_hi (3xTF32), 2 = a_lo b + a_hi b (b exact in TF32),
    1 = a_hi b_hi (plain TF32)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if products == 1:
        return ah @ bh
    if products == 2:
        return al @ bh + ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _attention(q, k, v, pos, products):
    """Prefill attention with both products emulated; q (B, KVH, C, G, hd)."""
    b, kvh, c, g, hd = q.shape
    s = k.shape[1]
    qr = q.reshape(b, kvh, c * g, hd)
    kt = k.permute(0, 2, 3, 1)  # (B, KVH, hd, S)
    sc = _mm(qr, kt, products) * scale_for(hd)
    qpos = torch.as_tensor(pos)[:, None] + torch.arange(c * g)[None] // g  # (B, R)
    seen = torch.arange(s)[None, None] <= qpos[..., None]
    sc = torch.where(seen[:, None], sc, torch.tensor(NEG_INF))
    w = torch.softmax(sc, dim=-1)
    out = _mm(w, v.permute(0, 2, 1, 3), products)  # (B, KVH, R, hd)
    return out.reshape(b, kvh, c, g, hd)


@functools.lru_cache(maxsize=None)
def _olmo_prefill():
    """OLMo-1B's prefill attention call on the main path: B 4, S 1024,
    KVH 16, G 1, hd 128, C 32, pos [0, 200, 640, 992]; f32 plain result."""
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((4, 16, 32, 1, 128)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((4, 1024, 16, 128)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((4, 1024, 16, 128)).astype(np.float32))
    pos = [0, 200, 640, 992]
    return q, k, v, pos, t_prefill_ref(q, k, v, torch.tensor(pos, dtype=torch.int32))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10  # TF32 step at 1
    x = torch.cat([one * (1 + ulp / 2), one * (1 + ulp / 2 - 2.0 ** -20), one * (1 + 3 * ulp / 4)])
    want = torch.tensor([1 + ulp, -1 - ulp, 1.0, -1.0, 1 + ulp, -1 - ulp])
    assert torch.equal(_tf32(x), want)
    hi, lo = _split(torch.tensor([math.pi]))
    assert abs(float(hi + lo) - math.pi) < 2.0 ** -21 * math.pi


def test_3xtf32_meets_f32_tolerance_where_tf32_does_not():
    q, k, v, pos, want = _olmo_prefill()
    err3 = (_attention(q, k, v, pos, 3) - want).abs().max().item()
    err1 = (_attention(q, k, v, pos, 1) - want).abs().max().item()
    assert err3 <= 2e-5, err3
    assert err1 > 2e-5, err1


def test_bf16_operands_are_exact_in_tf32_so_fewer_products_suffice():
    """bf16 Q, K and V widen to f32 values with 8 mantissa bits: TF32 keeps
    them whole, so Q @ K^T needs one product and P @ V two (P_lo V +
    P_hi V), and these equal the 3xTF32 products exactly."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((3, 16, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 64, 40)).astype(np.float32))
    a16, b16 = a.bfloat16().float(), b.bfloat16().float()
    assert torch.equal(_tf32(a16), a16) and torch.equal(_tf32(b16), b16)
    assert torch.equal(_mm(a16, b16, 1), _mm(a16, b16, 3))
    p = torch.softmax(a, dim=-1)  # f32 P: not exact in TF32
    assert torch.equal(_mm(p, b16, 2), _mm(p, b16, 3))
    assert not torch.equal(_mm(p, b16, 1), _mm(p, b16, 2))


# ------------------------------------------------------------- (c) hd 112
@pytest.mark.parametrize("nsplit", [1, 3, 8])
def test_hd112_split_merge_matches_jax_prefill(nsplit):
    (q, k, v, pos, window), ref, pallas = _case(0, "hd112")
    got = _split_merge(*map(torch.from_numpy, (q, k, v)), pos, window, nsplit).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


def _plan_max_rows(elem, hd):
    """prefill_attention.cu::Plan<T, HD>::kMaxRows for a T of ``elem``
    bytes: the query rows that fit in 227 KB beside the K/V ring, in whole
    m16 tiles, at most 128 (f32: Q and P carry a low part) or 160."""
    lo = elem == 4
    k_stride, v_stride, q_stride = hd + 16 // elem, hd + 32 // elem, hd + 4
    ring = 2 * (64 * k_stride * elem + 64 * v_stride * elem)
    fixed = ring + 2 * 64 * 8
    row_bytes = q_stride * 4 * (2 if lo else 1) + (64 + 4) * 4 * 2 + 16
    fit = (232448 - fixed) // row_bytes // 16 * 16
    return min(fit, 128 if lo else 160), k_stride * elem, v_stride * elem


def test_hd112_plan_holds_whole_m16_tiles_of_aligned_rows():
    src = (CSRC / "prefill_attention.cu").read_text()
    for needle in ("constexpr int kRowCap = 160;", "constexpr int kRowCapLo = 128;",
                   "constexpr int kSmemCap = 232448;", "constexpr int kTileK = 64;",
                   "case 112: return Plan<float, 112>::kMaxRows;",
                   "case 112: return Plan<__nv_bfloat16, 112>::kMaxRows;"):
        assert needle in src, needle
    # the arithmetic as at the instantiated head dims (HD 128: 48 and 144)
    assert [_plan_max_rows(e, 128)[0] for e in (4, 2)] == [48, 144]
    for elem, want in ((4, 64), (2, 160)):
        rows, k_row, v_row = _plan_max_rows(elem, 112)
        assert rows == want and rows % 16 == 0
        assert k_row % 16 == 0 and v_row % 16 == 0  # cp.async 16-byte destinations


def _combine_writes(hd, r_rows, threads=256):
    """How often the combine kernel's thread map (kLanes = HD / 4 threads a
    row, kRowsPer = 256 / kLanes rows a block) writes each (row, dim) of an
    ``r_rows``-row slab."""
    lanes = hd // 4
    rows_per = threads // lanes
    written = np.zeros((r_rows, hd), np.int32)
    for block in range(math.ceil(r_rows / rows_per)):
        for t in range(threads):
            row = block * rows_per + t // lanes
            if t >= rows_per * lanes or row >= r_rows:
                continue
            written[row, (t % lanes) * 4:(t % lanes) * 4 + 4] += 1
    return written


def test_hd112_combine_covers_every_row_and_dim_once():
    """The combine kernel's map at HD 112 (kLanes 28, kRowsPer 9): threads
    past 9 * 28 return, the others write their row's 4 dims."""
    assert (_combine_writes(112, 32) == 1).all()  # a zamba2 slab: C 32, G 1
    assert "if (threadIdx.x >= kRowsPer * kLanes || row >= R) return;" in (
        CSRC / "prefill_attention.cu").read_text()


# ------------------------------------------------------------- (d) hd 160
@pytest.mark.parametrize("nsplit", [1, 3, 8])
def test_hd160_split_merge_matches_jax_prefill(nsplit):
    (q, k, v, pos, window), ref, pallas = _case(0, "hd160")
    got = _split_merge(*map(torch.from_numpy, (q, k, v)), pos, window, nsplit).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


def test_hd160_plan_and_combine_cover_pixtrals_slab():
    """``Plan<T, 160>``: 32 rows in f32 (171,008 B fixed, 1,872 B a row)
    and 112 in bf16, K/V rows of 656 / 672 B and 336 / 352 B; Pixtral's
    128-row slab (C 32, G 4) takes 4 row tiles in f32 and 2 in bf16; the
    combine kernel (40 threads a row, 6 rows a block) writes each (row,
    dim) of it once, across 22 blocks."""
    src = (CSRC / "prefill_attention.cu").read_text()
    for needle in ("case 160: return Plan<float, 160>::kMaxRows;",
                   "case 160: return Plan<__nv_bfloat16, 160>::kMaxRows;"):
        assert needle in src, needle
    for elem, want, rows_k, rows_v, tiles in ((4, 32, 656, 672, 4), (2, 112, 336, 352, 2)):
        rows, k_row, v_row = _plan_max_rows(elem, 160)
        assert (rows, k_row, v_row) == (want, rows_k, rows_v)
        n = math.ceil(128 / rows)  # row_tile_for(128, rows)
        assert math.ceil(128 / ((math.ceil(128 / n) + 15) // 16 * 16)) == tiles
    assert (_combine_writes(160, 128) == 1).all()
