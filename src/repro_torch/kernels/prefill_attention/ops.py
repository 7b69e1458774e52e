"""Public ops ``prefill_attention`` and ``paged_prefill_attention``:
model-layout tensors (q (B, C, H, hd); a dense cache (B, S, KVH, hd), or a
shared pool (num_blocks, block_size, KVH, hd) with a (B, max_blocks) int32
block table; pos () or (B,) per-slot first-token positions) in,
(B, C, H, hd) out.

On CUDA tensors each launches the hand-written chunked flash-prefill
kernel (``csrc/prefill_attention.cu``), which reads q and writes out in
this layout directly (no (B, KVH, C, G, hd) transpose), or raises; on CPU
tensors it runs the plain version in ``ref.py``. ``<op>.launches`` counts
kernel launches (CPU calls do not count)."""
import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.prefill_attention.ref import (
    paged_prefill_attention_reference,
    prefill_attention_reference,
)

_lib = None


def _lib_fns():
    global _lib
    if _lib is None:
        lib = runtime.load_library("prefill_attention")
        fn = lib.prefill_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        fn = lib.paged_prefill_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _slab(q, kvh):
    """(B, C, H, hd) -> (B, KVH, C, G, hd): the slab layout of the oracle."""
    b, cq, h, hd = q.shape
    return q.reshape(b, cq, kvh, h // kvh, hd).permute(0, 2, 1, 3, 4)


def _unslab(out):
    b, kvh, cq, g, hd = out.shape
    return out.permute(0, 2, 1, 3, 4).reshape(b, cq, kvh * g, hd)


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
    dtype = runtime.check_kernel_inputs(
        "prefill_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    )
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    out = torch.empty_like(q)
    err = _lib_fns().prefill_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_b.data_ptr(),
        out.data_ptr(), b, s, kvh, cq, g, hd, win, runtime.scale_for(hd),
        runtime.DTYPE_CODES[dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    runtime.check_launch("prefill_attention", err)
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
    dtype = runtime.check_kernel_inputs(
        "paged_prefill_attention", {"q": q, "k_pool": k_pool, "v_pool": v_pool}
    )
    runtime.check_block_table("paged_prefill_attention", block_tables, b, q.device)
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    out = torch.empty_like(q)
    err = _lib_fns().paged_prefill_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        pos_b.data_ptr(), out.data_ptr(), b, mb, bs, nb, kvh, cq, g, hd, win,
        runtime.scale_for(hd), runtime.DTYPE_CODES[dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    runtime.check_launch("paged_prefill_attention", err)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
