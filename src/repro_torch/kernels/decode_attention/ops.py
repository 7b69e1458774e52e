"""Public op ``decode_attention``: model-layout tensors (q (B, 1, H, hd);
dense caches (B, S, KVH, hd); pos () or (B,) per-slot) in, (B, 1, H, hd)
out.

On CUDA tensors it launches the hand-written flash-decode kernel
(``csrc/decode_attention.cu``) or raises; on CPU tensors it runs the plain
version in ``ref.py``. ``decode_attention.launches`` counts kernel launches
(CPU calls do not count)."""
import ctypes
import math

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention.ref import decode_attention_reference

_ROWS = 16  # kRows in attention_tile.cuh: query heads one block holds
_TILE_S = 64  # kTileS: keys per tile
_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = runtime.load_library("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.decode_attention_launch


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
    part_ml = torch.empty((b, kvh, nsplit, _ROWS, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty(
        (b, kvh, nsplit, _ROWS, hd), dtype=torch.float32, device=q.device
    )
    err = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_b.data_ptr(),
        out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        b, s, kvh, g, hd, win, nsplit, runtime.scale_for(hd),
        runtime.DTYPE_CODES[dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    runtime.check_launch("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
