"""Device policy, the backend matrix, position vectors, and the build of
the hand-written kernels.

Four concerns live here:

* ``require_device`` — where an entry point runs. CUDA unless the caller
  names another device; a missing GPU raises instead of quietly running on
  the CPU.
* ``resolve_attn_backend`` — which attention path a serving layer takes
  for the configured ``attn_backend``. The matrix, as the reference's:

  ==============  ==========  =========
  layer           "kernel"    "plain"
  ==============  ==========  =========
  GQA (any hd in  CUDA        plain
  ``HEAD_DIMS``,  kernels     softmax
  window or not,  1-4
  dense / paged)
  MLA             plain       plain
  mamba2, xLSTM   no attention
  ==============  ==========  =========

  MLA has no kernel in the reference either: its absorbed decode contracts
  the queries against the compressed latent cache, so there are no K/V
  heads for a flash kernel to stream (and its query width, qk_nope +
  qk_rope = 192 at DeepSeek-V2's width, is no kernel instantiation).
  The graph-mix kernel follows ``attn_backend`` as it is.
* ``pos_vector`` — normalizes ()/(B,)/python-int positions to one (B,)
  int32 tensor on the kernels' device; ``gather_pages`` — the logical
  view of a paged pool through a block table (the plain paged versions'
  first step).
* the kernel build. Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface under
  ``build/kernels/`` at the repo root, keyed by a hash of its sources and
  flags, and loaded with ``ctypes``. ``build_kernels`` starts one ``nvcc``
  per source, all together, so a fresh checkout builds in the time of the
  slowest source.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.configs.base import ATTN_BACKENDS

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/runtime.py -> repo root three levels above src/
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("decode_attention", "prefill_attention", "graph_mix")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (32, 64, 112, 128, 160)  # template instantiations of the kernels
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}


def require_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    entry points never fall back to the CPU without being told."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_attn_backend(backend: str, *, mla: bool = False) -> str:
    """The attention backend one serving layer runs on (the matrix in the
    module docstring): ``"kernel"`` is kept for GQA layers and becomes
    ``"plain"`` for MLA. An unknown name raises: a typo must not serve the
    slow path unnoticed."""
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"attn_backend must be one of {ATTN_BACKENDS}, got {backend!r}")
    return "plain" if mla else backend


def pos_vector(pos, b: int, device) -> torch.Tensor:
    """Normalize ()/(B,)/python-int positions to a (B,) int32 tensor."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return p.broadcast_to((b,)).contiguous()


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Each slot's logical KV view of a shared pool.

    pool: (num_blocks, block_size, ...); block_tables: (B, max_blocks).
    Returns (B, max_blocks * block_size, ...): logical position p of slot b
    is row p of the view, so masking by ``pos`` works as on a dense cache.
    Table entries are clamped to [0, num_blocks - 1], as the JAX gather
    ``pool[block_tables]`` clamps (torch indexing would raise instead)."""
    ids = block_tables.long().clamp(0, pool.shape[0] - 1)
    g = pool[ids]  # (B, MB, BS, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


# ------------------------------------------------------------------ build
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
        "cannot be built"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current sources
    (the .cu, every shared .cuh header) and compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile each named source that has no library for its current hash.

    One ``nvcc`` per source, all started together; each writes to a
    temporary file that is renamed into place only on success. Returns
    ``{name: compiler output}`` (``-Xptxas -v`` register and shared-memory
    report) for the sources built by this call; raises with the compiler
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs[name] = (proc, tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
            else:
                os.replace(tmp, out)
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_kernel_inputs(op: str, tensors: dict) -> torch.dtype:
    """Reject what the CUDA launchers do not take: tensors off one CUDA
    device, mixed or unsupported dtypes, non-contiguous or misaligned
    storage, head dims without a template instantiation. Returns the dtype."""
    devices = {t.device for t in tensors.values()}
    dtypes = {t.dtype for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{op}: all inputs must lie on one CUDA device, got "
            f"{ {k: str(t.device) for k, t in tensors.items()} }"
        )
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPE_CODES:
        raise TypeError(
            f"{op}: inputs must share one dtype in {list(DTYPE_CODES)}, got "
            f"{ {k: t.dtype for k, t in tensors.items()} }"
        )
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{op}: {k} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {k} must be 16-byte aligned")
    hd = next(iter(tensors.values())).shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{op}: head_dim {hd} not in {HEAD_DIMS}")
    return next(iter(dtypes))


def check_block_table(op: str, block_tables: torch.Tensor, b: int,
                      device: torch.device) -> None:
    """Reject a block table the paged launchers do not take: not a
    contiguous (B, max_blocks) int32 tensor on the inputs' device."""
    if block_tables.device != device:
        raise ValueError(
            f"{op}: block_tables lies on {block_tables.device}, the inputs on {device}"
        )
    if block_tables.dtype != torch.int32:
        raise TypeError(f"{op}: block_tables must be int32, got {block_tables.dtype}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b or block_tables.shape[1] < 1:
        raise ValueError(
            f"{op}: block_tables must be ({b}, max_blocks), got {tuple(block_tables.shape)}"
        )
    if not block_tables.is_contiguous():
        raise ValueError(f"{op}: block_tables must be contiguous")


def check_launch(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed with cudaError_t {err}")


def window_arg(window) -> int:
    """Sliding window as the launchers take it: 0 = none."""
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"window must be a positive int or None, got {window}")
    return int(window)


@functools.lru_cache(maxsize=None)
def scale_for(hd: int) -> float:
    """1 / sqrt(hd) rounded as float32 arithmetic rounds it."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))
