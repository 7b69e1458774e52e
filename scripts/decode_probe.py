"""Split counts and block shapes of the flash-decode kernels on the card:
``csrc/decode_attention.cu`` built with other warps per block and ring
depths, each build timed at split counts 1 to 32 at OLMo-1B's main-path decode
shapes (f32, B 4, S 1024, KVH 16, hd 128, pos [63, 300, 700, 1023], dense
and paged over 16-token pages), Qwen2.5-14B's (KVH 8, G 5) and
multitask-LM's (KVH 4, G 4, hd 64).

    PYTHONPATH=src python scripts/decode_probe.py [--parent DIR]

Builds (``-DDECODE_WARPS=<w> -DDECODE_STAGES=<s>``, into
``build/kernels/probe/``; all compile together): the entries of
``VARIANTS``, ``w<warps>s<ring depth>``; ``w4s3`` is the port's build, and
its ptxas report is printed. At each shape's own split count it also reads
the eager device time of the partial and merge kernels with
torch.profiler. ``--parent DIR`` also
builds ``DIR/decode_attention.cu`` (a parent tree's ``csrc``, whose
entry points take the same arguments) and times it at its own split
count, ``min(ceil(2 * SMs / (B * KVH)), ceil(S / 64))``, beside the
variants. Milliseconds per call (partial + merge): replays of a CUDA graph
of calls over 4 input sets (over 256 MB at the OLMo-1B shape, above the
50 MB L2), as ``chip_smoke.py`` times its kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import ops

# name: compile-time knobs of attention_tile.cuh
VARIANTS = {
    "w4s3": {},  # the port's build
    "w4s2": {"DECODE_STAGES": 2},
    "w8s2": {"DECODE_WARPS": 8, "DECODE_STAGES": 2},
}
SPLITS = (1, 2, 4, 6, 8, 9, 10, 12, 13, 14, 16, 20, 24, 32)
# name, B, S, KVH, G, hd, pos, block (None: dense)
SHAPES = (
    ("olmo_1b", 4, 1024, 16, 1, 128, [63, 300, 700, 1023], None),
    ("olmo_1b_paged", 4, 1024, 16, 1, 128, [63, 300, 700, 1023], 16),
    ("qwen2_5_14b", 4, 1024, 8, 5, 128, [0, 513, 64, 1000], None),
    ("multitask_lm", 4, 1024, 4, 4, 64, [63, 300, 700, 1023], None),
)


def build(out_dir, parent=None):
    """One library per variant (and the parent's), all compiled together;
    {name: CDLL}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = list(runtime.NVCC_FLAGS)
    jobs = {name: (runtime.CSRC / "decode_attention.cu", [f"-D{k}={v}" for k, v in defs.items()])
            for name, defs in VARIANTS.items()}
    if parent:
        jobs["parent"] = (Path(parent) / "decode_attention.cu", [])
    procs = {}
    for name, (src, defs) in jobs.items():
        lib = out_dir / f"decode_{name}.so"
        cmd = [runtime._nvcc(), *flags, *defs, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"probe: build of {name} failed\n{log}")
        if name == "w4s3":
            for line in log.splitlines():
                if "Used" in line or "spill" in line or "Compiling entry" in line:
                    print(f"ptxas {name}: {line.strip()}", flush=True)
        libs[name] = (bind_parent if name == "parent" else ops._bind)(ctypes.CDLL(str(lib)))
    return libs


def bind_parent(lib):
    """The two launch entry points of a parent build (it has no
    decode_geometry)."""
    for name, pointers, ints in (("decode_attention_launch", 7, 7),
                                 ("paged_decode_attention_launch", 8, 9)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def graph_ms(calls, reps=20):
    """Device ms per call: the calls (one per input set) captured in one
    CUDA graph, median of ``reps`` timed replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def kernel_times(call, reps=4):
    """Eager device ms per call of each CUDA kernel ``call`` launches, by
    kernel name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("::")[-1]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def inputs(gen, b, s, kvh, g, hd, block, sets=4):
    """(q, k, v, table) per set: dense caches, or pools of 16-token pages
    with shuffled ids (table None when dense)."""
    dev = torch.device("cuda")
    out = []
    for _ in range(sets):
        q = torch.randn((b, 1, kvh * g, hd), generator=gen, device=dev)
        if block is None:
            out.append((q, torch.randn((b, s, kvh, hd), generator=gen, device=dev),
                        torch.randn((b, s, kvh, hd), generator=gen, device=dev), None))
            continue
        nb = b * s // block + 1
        ids = torch.randperm(nb - 1, generator=gen, device=dev) + 1
        out.append((q, torch.randn((nb, block, kvh, hd), generator=gen, device=dev),
                    torch.randn((nb, block, kvh, hd), generator=gen, device=dev),
                    ids.reshape(b, -1).to(torch.int32).contiguous()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a parent tree's csrc directory to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(runtime.BUILD_DIR / "probe", args.parent)
    sms = runtime.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, b, s, kvh, g, hd, pos, block in SHAPES:
        sets = inputs(gen, b, s, kvh, g, hd, block)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        want = ops.paged_decode_attention if block else ops.decode_attention
        ref = [want(q.cpu(), k.cpu(), v.cpu(), *([t.cpu()] if block else []), pos_t.cpu())
               for q, k, v, t in sets[:1]][0]
        for name, lib in libs.items():
            if name == "parent":
                splits = [max(1, min(math.ceil(2 * sms / (b * kvh)), math.ceil(s / 64)))]
            else:
                tile, per_sm = ops.geometry(torch.float32, hd, block is not None, lib)
                own = ops.num_splits(sets[0][0], kvh, s, block is not None, lib)
                splits = sorted({own, *SPLITS})
            got = ops._launch(*sets[0], pos_t, 0, own if name != "parent" else splits[0],
                              lib=lib)
            err = (got.cpu() - ref).abs().max().item()
            times = {n: graph_ms([lambda t=t, n=n: ops._launch(*t, pos_t, 0, n, lib=lib)
                                  for t in sets]) for n in splits}
            extra = "" if name == "parent" else f" (tile {tile}, {per_sm} blocks/SM, own {own})"
            print(f"probe {shape} {name}{extra}: err {err:.2e}; "
                  + "; ".join(f"nsplit {n}: {t:.4f} ms" for n, t in times.items()), flush=True)
            n_own = splits[0] if name == "parent" else own
            eager = kernel_times(lambda: ops._launch(*sets[0], pos_t, 0, n_own, lib=lib))
            print(f"probe {shape} {name} eager at nsplit {n_own}: "
                  + ", ".join(f"{k} {t:.4f} ms" for k, t in eager.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
