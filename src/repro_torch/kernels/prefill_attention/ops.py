"""Public op ``prefill_attention``: model-layout tensors (q (B, C, H, hd);
dense caches (B, S, KVH, hd); pos () or (B,) per-slot first-token
positions) in, (B, C, H, hd) out.

On CUDA tensors it launches the hand-written chunked flash-prefill kernel
(``csrc/prefill_attention.cu``), which reads q and writes out in this
layout directly (no (B, KVH, C, G, hd) transpose); on CPU tensors it runs
the plain version in ``ref.py``. ``prefill_attention.launches`` counts
kernel launches (CPU calls do not count)."""
import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.prefill_attention.ref import prefill_attention_reference

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = runtime.load_library("prefill_attention")
        fn = lib.prefill_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.prefill_attention_launch


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
        # (B, C, H, hd) -> (B, KVH, C, G, hd): the slab layout of the oracle
        qg = q.reshape(b, cq, kvh, g, hd).permute(0, 2, 1, 3, 4)
        out = prefill_attention_reference(qg, k_cache, v_cache, pos, window=window)
        return out.permute(0, 2, 1, 3, 4).reshape(b, cq, h, hd)
    dtype = runtime.check_kernel_inputs(
        "prefill_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache}
    )
    win = runtime.window_arg(window)
    pos_b = runtime.pos_vector(pos, b, q.device)
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos_b.data_ptr(),
        out.data_ptr(), b, s, kvh, cq, g, hd, win, runtime.scale_for(hd),
        runtime.DTYPE_CODES[dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    runtime.check_launch("prefill_attention", err)
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
