"""Public ops ``prefill_attention`` and ``paged_prefill_attention``:
model-layout tensors (q (B, C, H, hd); a dense cache (B, S, KVH, hd), or a
shared pool (num_blocks, block_size, KVH, hd) with a (B, max_blocks) int32
block table; pos () or (B,) per-slot first-token positions) in,
(B, C, H, hd) out.

On CUDA tensors each launches the hand-written chunked flash-prefill
kernel (``csrc/prefill_attention.cu``), which reads q and writes out in
this layout directly (no (B, KVH, C, G, hd) transpose), or raises; on CPU
tensors it runs the plain version in ``ref.py``. A launch is two CUDA
kernels: the partial kernel, over ``nsplit`` splits of each slot's visible
keys, and the merge of the splits. ``<op>.launches`` counts wrapper calls
that launched (CPU calls do not count)."""
import ctypes
import math

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.prefill_attention.ref import (
    paged_prefill_attention_reference,
    prefill_attention_reference,
)

_TILE_K = 64  # kTileK in prefill_attention.cu: keys per ring stage
_lib = None


def _bind(lib):
    """Argument and result types of the library's entry points; returns it."""
    fn = lib.prefill_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.paged_prefill_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.prefill_max_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.prefill_max_rows.restype = ctypes.c_int
    return lib


def _lib_fns():
    global _lib
    if _lib is None:
        _lib = _bind(runtime.load_library("prefill_attention"))
    return _lib


def _slab(q, kvh):
    """(B, C, H, hd) -> (B, KVH, C, G, hd): the slab layout of the oracle."""
    b, cq, h, hd = q.shape
    return q.reshape(b, cq, kvh, h // kvh, hd).permute(0, 2, 1, 3, 4)


def _unslab(out):
    b, kvh, cq, g, hd = out.shape
    return out.permute(0, 2, 1, 3, 4).reshape(b, cq, kvh * g, hd)


def num_splits(q: torch.Tensor, kvh: int, s: int) -> int:
    """Split of each slot's visible keys across blocks for a CUDA query
    ``q`` (B, C, H, hd) against ``s`` logical key rows, chosen from shapes
    alone (``pos`` stays on the card): about two waves of blocks over the
    (row tile, KV head, slot) grid, one block per SM (the partial kernel's
    shared memory holds one), at most one split per key tile."""
    b, cq, h, hd = q.shape
    rows = cq * (h // kvh)
    max_rows = _lib_fns().prefill_max_rows(runtime.DTYPE_CODES[q.dtype], hd)
    row_tiles = math.ceil(rows / max_rows)
    target = 2 * runtime.sm_count(q.device.index or 0)
    return max(1, min(math.ceil(target / (b * kvh * row_tiles)), math.ceil(s / _TILE_K)))


def _scratch(b, kvh, nsplit, rows, hd, device):
    """Per-split partials of every slab row: (max, sum) and the
    unnormalised accumulator."""
    part_ml = torch.empty((b, kvh, nsplit, rows, 2), dtype=torch.float32, device=device)
    part_acc = torch.empty((b, kvh, nsplit, rows, hd), dtype=torch.float32, device=device)
    return part_ml, part_acc


def _launch(q, k, v, table, pos_b, window, nsplit, lib=None):
    """Both launches of one call at a given split count (tests force it),
    through ``lib`` (a build of the source bound by ``_bind``; default the
    port's); q, k, v, table already checked. Returns out (B, C, H, hd)."""
    lib = lib or _lib_fns()
    b, cq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dtype = runtime.DTYPE_CODES[q.dtype]
    out = torch.empty_like(q)
    part_ml, part_acc = _scratch(b, kvh, nsplit, cq * g, hd, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    tail = (pos_b.data_ptr(), out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr())
    if table is None:
        err = lib.prefill_attention_launch(
            *ptrs, *tail, b, k.shape[1], kvh, cq, g, hd, window, nsplit,
            runtime.scale_for(hd), dtype, stream,
        )
        runtime.check_launch("prefill_attention", err)
    else:
        nb, bs = k.shape[:2]
        err = lib.paged_prefill_attention_launch(
            *ptrs, table.data_ptr(), *tail, b, table.shape[1], bs, nb, kvh, cq, g, hd,
            window, nsplit, runtime.scale_for(hd), dtype, stream,
        )
        runtime.check_launch("paged_prefill_attention", err)
    return out


def prefill_attention(q, k_cache, v_cache, pos, *, window=None):
    b, cq, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    if h % kvh or k_cache.shape != (b, s, kvh, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"prefill_attention: want q (B, C, H, hd) and caches (B, S, KVH, hd) "
            f"with KVH | H, got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}"
        )
    g = h // kvh
    if q.device.type == "cpu" and k_cache.device.type == "cpu" and (
        v_cache.device.type == "cpu"
    ):
        return _unslab(
            prefill_attention_reference(_slab(q, kvh), k_cache, v_cache, pos, window=window)
        )
    runtime.check_kernel_inputs(
        "prefill_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    )
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    nsplit = num_splits(q, kvh, s)
    out = _launch(q, k_cache, v_cache, None, pos_b, win, nsplit)
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0


def paged_prefill_attention(q, k_pool, v_pool, block_tables, pos, *, window=None):
    """Chunked flash prefill over a shared pool: logical row j of slot b
    lives at ``pool[block_tables[b, j // BS], j % BS]`` (ids clamped to the
    pool); the slot has ``max_blocks * BS`` logical rows, masked by
    ``pos + i``."""
    b, cq, h, hd = q.shape
    nb, bs, kvh = k_pool.shape[:3]
    if h % kvh or k_pool.shape != (nb, bs, kvh, hd) or v_pool.shape != k_pool.shape or (
        block_tables.ndim != 2 or block_tables.shape[0] != b
    ):
        raise ValueError(
            f"paged_prefill_attention: want q (B, C, H, hd), pools (NB, BS, KVH, hd) "
            f"with KVH | H and block_tables (B, MB), got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}, {tuple(block_tables.shape)}"
        )
    g = h // kvh
    mb = block_tables.shape[1]
    if all(t.device.type == "cpu" for t in (q, k_pool, v_pool, block_tables)):
        return _unslab(paged_prefill_attention_reference(
            _slab(q, kvh), k_pool, v_pool, block_tables, pos, window=window
        ))
    runtime.check_kernel_inputs(
        "paged_prefill_attention", {"q": q, "k_pool": k_pool, "v_pool": v_pool}
    )
    runtime.check_block_table("paged_prefill_attention", block_tables, b, q.device)
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    nsplit = num_splits(q, kvh, mb * bs)
    out = _launch(q, k_pool, v_pool, block_tables, pos_b, win, nsplit)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
