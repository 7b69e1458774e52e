"""Public ops ``decode_attention`` and ``paged_decode_attention``:
model-layout tensors (q (B, 1, H, hd); a dense cache (B, S, KVH, hd), or a
shared pool (num_blocks, block_size, KVH, hd) with a (B, max_blocks) int32
block table; pos () or (B,) per-slot) in, (B, 1, H, hd) out.

On CUDA tensors each launches the hand-written flash-decode kernel
(``csrc/decode_attention.cu``) or raises; on CPU tensors it runs the plain
version in ``ref.py``. A launch is two CUDA kernels: the partial kernel,
over ``nsplit`` splits of each slot's visible keys, and the merge of the
splits. ``<op>.launches`` counts wrapper calls that launched (CPU calls do
not count)."""
import ctypes
import functools
import math

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_reference,
    paged_decode_attention_reference,
)

_ROWS = 16  # kRows in attention_tile.cuh: query heads one block holds
# The grid holds _WAVES times the blocks the card holds at once: a short
# slot's splits are empty (they return at once) or short, and finer splits
# of the longest slot keep the last blocks short (scripts/decode_probe.py:
# OLMo-1B's decode is fastest near 16 splits, which 4 gives on an H100).
_WAVES = 4
_lib = None


def _bind(lib):
    """Argument and result types of the library's entry points; returns it."""
    fn = lib.decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.paged_decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.decode_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    return lib


def _lib_fns():
    global _lib
    if _lib is None:
        _lib = _bind(runtime.load_library("decode_attention"))
    return _lib


@functools.lru_cache(maxsize=None)
def geometry(dtype: torch.dtype, hd: int, paged: bool, lib=None) -> tuple[int, int]:
    """(keys per tile, blocks of the partial kernel one SM holds) for a
    dtype and head dim, as the built library reports them."""
    tile, per_sm = ctypes.c_int(), ctypes.c_int()
    err = (lib or _lib_fns()).decode_geometry(
        runtime.DTYPE_CODES[dtype], hd, int(paged), ctypes.byref(tile), ctypes.byref(per_sm)
    )
    runtime.check_launch("decode_geometry", err)
    return tile.value, per_sm.value


def num_splits(q: torch.Tensor, kvh: int, s: int, paged: bool = False, lib=None) -> int:
    """Split of each slot's visible key tiles across blocks for a CUDA query
    ``q`` (B, 1, H, hd) against ``s`` logical key rows, chosen from shapes
    alone (``pos`` stays on the card): ``_WAVES`` times as many blocks over
    the (KV head, slot) grid as the card holds at once (what one SM holds
    follows from the partial kernel's shared memory and registers, as the
    library reports them: 2 at f32 hd 128), at most one split per key
    tile, and rounded down so that no split is empty for a slot that sees
    all ``s`` keys (32 tiles in 17 splits take 2 tiles each: 16 splits).
    ``lib``: a build bound by ``_bind`` (default the port's)."""
    b, hd = q.shape[0], q.shape[-1]
    tile, per_sm = geometry(q.dtype, hd, paged, lib)
    target = _WAVES * per_sm * runtime.sm_count(q.device.index or 0)
    tiles = math.ceil(s / tile)
    per = math.ceil(tiles / min(tiles, math.ceil(target / (b * kvh))))
    return math.ceil(tiles / per)


def _scratch(b, kvh, nsplit, hd, device):
    """Per-split partials: (max, sum) and the unnormalised accumulator."""
    part_ml = torch.empty((b, kvh, nsplit, _ROWS, 2), dtype=torch.float32, device=device)
    part_acc = torch.empty((b, kvh, nsplit, _ROWS, hd), dtype=torch.float32, device=device)
    return part_ml, part_acc


def _launch(q, k, v, table, pos, window, nsplit, lib=None):
    """Both launches of one call at a given split count (tests force it),
    through ``lib`` (a build of the source bound by ``_bind``; default the
    port's); q, k, v, table already checked, ``pos`` a (B,) int32 vector on
    the card, ``window`` as ``runtime.window_arg`` gives it. Returns out
    (B, 1, H, hd)."""
    lib = lib or _lib_fns()
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dtype = runtime.DTYPE_CODES[q.dtype]
    out = torch.empty_like(q)
    part_ml, part_acc = _scratch(b, kvh, nsplit, hd, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    tail = (pos.data_ptr(), out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr())
    if table is None:
        err = lib.decode_attention_launch(
            *ptrs, *tail, b, k.shape[1], kvh, g, hd, window, nsplit, runtime.scale_for(hd),
            dtype, stream,
        )
        runtime.check_launch("decode_attention", err)
    else:
        nb, bs = k.shape[:2]
        err = lib.paged_decode_attention_launch(
            *ptrs, table.data_ptr(), *tail, b, table.shape[1], bs, nb, kvh, g, hd, window,
            nsplit, runtime.scale_for(hd), dtype, stream,
        )
        runtime.check_launch("paged_decode_attention", err)
    return out


def decode_attention(q, k_cache, v_cache, pos, *, window=None):
    b, one, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or h % kvh or k_cache.shape != (b, s, kvh, hd) or (
        v_cache.shape != k_cache.shape
    ):
        raise ValueError(
            f"decode_attention: want q (B, 1, H, hd) and caches (B, S, KVH, hd) "
            f"with KVH | H, got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}"
        )
    g = h // kvh
    if q.device.type == "cpu" and k_cache.device.type == "cpu" and (
        v_cache.device.type == "cpu"
    ):
        out = decode_attention_reference(
            q.reshape(b, kvh, g, hd), k_cache, v_cache, pos, window=window
        )
        return out.reshape(b, 1, h, hd)
    runtime.check_kernel_inputs(
        "decode_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    )
    if g > _ROWS:
        raise ValueError(f"decode_attention: group size {g} > {_ROWS}")
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    out = _launch(q, k_cache, v_cache, None, pos_b, win, num_splits(q, kvh, s))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos, *, window=None):
    """Flash decode over a shared pool: logical row j of slot b lives at
    ``pool[block_tables[b, j // BS], j % BS]`` (ids clamped to the pool),
    and the slot has ``max_blocks * BS`` logical rows, masked by ``pos``."""
    b, one, h, hd = q.shape
    nb, bs, kvh = k_pool.shape[:3]
    if one != 1 or h % kvh or k_pool.shape != (nb, bs, kvh, hd) or (
        v_pool.shape != k_pool.shape
    ) or block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"paged_decode_attention: want q (B, 1, H, hd), pools (NB, BS, KVH, hd) "
            f"with KVH | H and block_tables (B, MB), got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}, {tuple(block_tables.shape)}"
        )
    g = h // kvh
    mb = block_tables.shape[1]
    if all(t.device.type == "cpu" for t in (q, k_pool, v_pool, block_tables)):
        out = paged_decode_attention_reference(
            q.reshape(b, kvh, g, hd), k_pool, v_pool, block_tables, pos, window=window
        )
        return out.reshape(b, 1, h, hd)
    runtime.check_kernel_inputs(
        "paged_decode_attention", {"q": q, "k_pool": k_pool, "v_pool": v_pool}
    )
    runtime.check_block_table("paged_decode_attention", block_tables, b, q.device)
    if g > _ROWS:
        raise ValueError(f"paged_decode_attention: group size {g} > {_ROWS}")
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    out = _launch(q, k_pool, v_pool, block_tables, pos_b, win,
                  num_splits(q, kvh, mb * bs, paged=True))
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
