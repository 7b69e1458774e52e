"""Public ops ``decode_attention`` and ``paged_decode_attention``:
model-layout tensors (q (B, 1, H, hd); a dense cache (B, S, KVH, hd), or a
shared pool (num_blocks, block_size, KVH, hd) with a (B, max_blocks) int32
block table; pos () or (B,) per-slot) in, (B, 1, H, hd) out.

On CUDA tensors each launches the hand-written flash-decode kernel
(``csrc/decode_attention.cu``) or raises; on CPU tensors it runs the plain
version in ``ref.py``. ``<op>.launches`` counts kernel launches (CPU calls
do not count)."""
import ctypes
import math

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_reference,
    paged_decode_attention_reference,
)

_ROWS = 16  # kRows in attention_tile.cuh: query heads one block holds
_TILE_S = 64  # kTileS: keys per tile
_lib = None


def _lib_fns():
    global _lib
    if _lib is None:
        lib = runtime.load_library("decode_attention")
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
        _lib = lib
    return _lib


def _scratch(b, kvh, nsplit, hd, device):
    """Per-split partials: (max, sum) and the unnormalised accumulator."""
    part_ml = torch.empty((b, kvh, nsplit, _ROWS, 2), dtype=torch.float32, device=device)
    part_acc = torch.empty((b, kvh, nsplit, _ROWS, hd), dtype=torch.float32, device=device)
    return part_ml, part_acc


def num_splits(b: int, kvh: int, s: int, device: torch.device) -> int:
    """Flash-decoding split of S: about two blocks per SM, at most one
    split per key tile."""
    target = 2 * runtime.sm_count(device.index or 0)
    return max(1, min(math.ceil(target / (b * kvh)), math.ceil(s / _TILE_S)))


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
    dtype = runtime.check_kernel_inputs(
        "decode_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    )
    if g > _ROWS:
        raise ValueError(f"decode_attention: group size {g} > {_ROWS}")
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    nsplit = num_splits(b, kvh, s, q.device)
    out = torch.empty_like(q)
    part_ml, part_acc = _scratch(b, kvh, nsplit, hd, q.device)
    err = _lib_fns().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_b.data_ptr(),
        out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        b, s, kvh, g, hd, win, nsplit, runtime.scale_for(hd),
        runtime.DTYPE_CODES[dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    runtime.check_launch("decode_attention", err)
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
    dtype = runtime.check_kernel_inputs(
        "paged_decode_attention", {"q": q, "k_pool": k_pool, "v_pool": v_pool}
    )
    runtime.check_block_table("paged_decode_attention", block_tables, b, q.device)
    if g > _ROWS:
        raise ValueError(f"paged_decode_attention: group size {g} > {_ROWS}")
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    nsplit = num_splits(b, kvh, mb * bs, q.device)
    out = torch.empty_like(q)
    part_ml, part_acc = _scratch(b, kvh, nsplit, hd, q.device)
    err = _lib_fns().paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        pos_b.data_ptr(), out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        b, mb, bs, nb, kvh, g, hd, win, nsplit, runtime.scale_for(hd),
        runtime.DTYPE_CODES[dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    runtime.check_launch("paged_decode_attention", err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
