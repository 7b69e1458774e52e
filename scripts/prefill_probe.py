"""Where the time of one dense prefill call goes on the card, and what the
split count costs: the dense prefill kernel at OLMo-1B's main-path shapes
(f32, B 4, S 1024, KVH 16, hd 128, C 32, pos [0, 200, 640, 992]), built
again with phases compiled out, each build timed at split counts 1 to 16.

    PYTHONPATH=src python scripts/prefill_probe.py

Builds (``csrc/prefill_attention.cu`` with ``-DPREFILL_PROBE_SKIP=<mask>``
into ``build/kernels/probe/``; all compile together): ``full`` (the port's
kernel); without the Q @ K^T products (``no_qk``), the softmax
(``no_softmax``) or the P @ V products (``no_pv``); without the K/V copies
(``no_copy``); with the copies only (``copy_only``); with neither
(``loop_only``); and with no tile at all (``no_tiles``: the Q prologue, the
partial writes and the merge). The difference from ``full`` is what a phase
costs where it does not overlap with the rest. Only ``full`` computes the
right answer. Milliseconds per call (two launches): replays of a CUDA graph
of 50 calls on one input set, so L2-warm, and below ``chip_smoke.py``'s
replays over input sets larger than the L2.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.prefill_attention import ops

SKIP = {"qk": 1, "softmax": 2, "pv": 4, "copy": 8, "tiles": 16}  # kSkip* in the source
VARIANTS = {
    "full": 0,
    "no_qk": SKIP["qk"],
    "no_softmax": SKIP["softmax"],
    "no_pv": SKIP["pv"],
    "no_copy": SKIP["copy"],
    "copy_only": SKIP["qk"] | SKIP["softmax"] | SKIP["pv"],
    "loop_only": SKIP["qk"] | SKIP["softmax"] | SKIP["pv"] | SKIP["copy"],
    "no_tiles": SKIP["tiles"],
}
SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16)


def build(out_dir):
    """One library per variant, all compiled together; {name: bound CDLL}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in runtime.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, mask in VARIANTS.items():
        lib = out_dir / f"{name}.so"
        cmd = [runtime._nvcc(), *flags, f"-DPREFILL_PROBE_SKIP={mask}", "-o", str(lib),
               str(runtime.CSRC / "prefill_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"probe: build of {name} failed\n{log}")
        libs[name] = ops._bind(ctypes.CDLL(str(lib)))
    return libs


def graph_ms(call, calls=50, reps=10):
    """Device ms per call: ``calls`` calls captured in one CUDA graph (no
    host work between launches), median of ``reps`` timed replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
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
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(runtime.BUILD_DIR / "probe")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, kvh, g, hd, c = 4, 1024, 16, 1, 128, 32
    q = torch.randn((b, c, kvh * g, hd), generator=gen, device=dev)
    k = torch.randn((b, s, kvh, hd), generator=gen, device=dev)
    v = torch.randn((b, s, kvh, hd), generator=gen, device=dev)
    pos = torch.tensor([0, 200, 640, 992], dtype=torch.int32, device=dev)
    print(f"probe: wrapper's nsplit {ops.num_splits(q, kvh, s)}", flush=True)
    for name, lib in libs.items():
        times = {n: graph_ms(lambda n=n: ops._launch(q, k, v, None, pos, 0, n, lib=lib))
                 for n in SPLITS}
        print(f"probe {name}: " + "; ".join(f"nsplit {n}: {t:.4f} ms" for n, t in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
