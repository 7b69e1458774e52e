#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; each raises on failure, and then no result line is printed:

  1. build    — compile every kernel source with nvcc for sm_90a, one
                process per source, all together.
  2. kernels  — each hand-written kernel against its plain PyTorch version
                on the card, at the serving path's shapes: OLMo-1B
                (B=4, S=1024, KVH=16, G=1, hd=128, ragged pos; prefill
                C=32), Qwen2.5-14B GQA (KVH=8, G=5), a sliding window, and
                every head-dim instantiation; f32 (atol 2e-5) and bf16
                (atol 2e-2). At the OLMo-1B f32 shapes it times the kernel,
                its plain version and one scaled_dot_product_attention call
                (library_ms, a yardstick the port never calls), and computes
                the bound.
  3. serve    — OLMo-1B at full width (f32, random weights from seed 0)
                through ServeEngine.generate: 6 requests with ragged
                64..700-token prompts over 4 slots, 16 new tokens each.
                Launch counters, zeroed just before, must show 16 decode
                kernel launches per decode dispatch and 16 prefill launches
                per prefill dispatch. The same requests through the plain
                attention path must give the same greedy tokens (a request's
                comparison ends at the first step whose plain top-2 logit
                margin is below 1e-3). Smoke configs on the card must match
                a CPU run within 1e-4 (logits).

  4. profile  — host wall time of a prefill round and of 8 decode ticks at
                OLMo-1B full width against the device time torch.profiler
                sees, with the top kernels (measurement only).

Output: the card's name and power limit first, per-phase lines, then one
{"kernels": [...]} JSON line, and last {"ok": true, "device": {...}}.
Exits non-zero without a result when there is no CUDA device or no
src/repro_torch beside this file.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32, dense bf16
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MARGIN = 1e-3
LAYERS = 16  # OLMo-1B: one kernel launch per layer per dispatch


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ measurement
def graph_ms(torch, calls, reps=20):
    """Device ms per call: capture the calls (one per input set, cycling
    sets so the working set outruns the 50 MB L2) into a CUDA graph and
    time its replays with CUDA events; median over `reps` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:  # warm-up outside capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
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


def visible_rows(p, s, window):
    """Inclusive key range a query at position p reads."""
    lo = max(0, p - window + 1) if window else 0
    return lo, min(p, s - 1)


def bound(kind, b, s, kvh, g, hd, c, pos, window, dtype):
    """Least time on the card: (bytes each input/output moves once) over
    HBM bandwidth vs (flops these positions need) over the dtype's peak."""
    es = 4 if dtype == "float32" else 2
    h = kvh * g
    kv_rows = flops = 0
    for p in pos:
        lo, _ = visible_rows(p, s, window)
        _, hi = visible_rows(p + c - 1, s, window)
        kv_rows += hi - lo + 1
        for i in range(c):
            klo, khi = visible_rows(p + i, s, window)
            flops += 4 * h * hd * max(0, khi - klo + 1)
    nbytes = kv_rows * kvh * hd * es * 2 + 2 * b * c * h * hd * es + 4 * b
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- phases
def phase_build(runtime):
    t0 = time.perf_counter()
    logs = runtime.build_kernels()
    secs = time.perf_counter() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {len(logs)} kernel sources compiled in {secs:.1f} s")


def phase_kernels(torch, F, dec_ops, pre_ops, dec_ref, pre_ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, kvh, g, hd, c, dtype, sets=1):
        out = []
        for _ in range(sets):
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            out.append((rnd(b, c, kvh * g, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)))
        return out

    def plain(q, k, v, pos, window):
        b, c, h, hd = q.shape
        kvh = k.shape[2]
        if c == 1:
            o = dec_ref.decode_attention_reference(
                q.reshape(b, kvh, h // kvh, hd), k, v, pos, window=window)
            return o.reshape(b, 1, h, hd)
        qg = q.reshape(b, c, kvh, h // kvh, hd).permute(0, 2, 1, 3, 4)
        o = pre_ref.prefill_attention_reference(qg, k, v, pos, window=window)
        return o.permute(0, 2, 1, 3, 4).reshape(b, c, h, hd)

    def library(q, k, v, mask):  # timed at OLMo-1B's shapes only: MHA, G = 1
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        )

    cases = [
        # name, B, S, KVH, G, hd, C, pos, window
        ("olmo_1b", 4, 1024, 16, 1, 128, 1, [63, 300, 700, 1023], None),
        ("olmo_1b", 4, 1024, 16, 1, 128, 32, [0, 200, 640, 992], None),
        ("qwen2_5_14b", 4, 1024, 8, 5, 128, 1, [0, 513, 64, 1000], None),
        ("qwen2_5_14b", 4, 1024, 8, 5, 128, 32, [100, 992, 0, 431], None),
        ("olmo_1b_window256", 4, 1024, 16, 1, 128, 1, [63, 300, 700, 1023], 256),
        ("olmo_1b_window256", 4, 1024, 16, 1, 128, 32, [0, 200, 640, 992], 256),
        ("hd64_window", 2, 300, 2, 4, 64, 3, [10, 297], 64),
        ("hd64_window", 2, 300, 2, 4, 64, 1, [299, 17], 100),
        ("hd32_gqa", 2, 200, 4, 2, 32, 8, [0, 190], None),
        ("hd32_gqa", 2, 200, 4, 2, 32, 1, [150, 199], None),
        ("masked_rows", 1, 100, 1, 1, 64, 5, [98], 3),
    ]
    entries = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for name, b, s, kvh, g, hd, c, pos, window in cases:
            op = dec_ops.decode_attention if c == 1 else pre_ops.prefill_attention
            kname = "decode_attention" if c == 1 else "prefill_attention"
            pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
            (q, k, v), = inputs(b, s, kvh, g, hd, c, dtype)
            got = op(q, k, v, pos_t, window=window)
            torch.cuda.synchronize()
            want = plain(q, k, v, pos_t, window)
            err = (got.float() - want.float()).abs().max().item()
            ok = err <= TOL[dname] and torch.isfinite(got.float()).all().item()
            log(f"kernel {kname} {name} B={b} S={s} KVH={kvh} G={g} hd={hd} C={c} "
                f"window={window} {dname}: max_abs_err={err:.3e} (atol {TOL[dname]})")
            if not ok:
                raise AssertionError(f"{kname} {name} {dname}: max_abs_err {err} > {TOL[dname]}")
            if name != "olmo_1b" or dname != "float32":
                continue
            # timing at the main path's shapes, 4 input sets per graph
            sets = inputs(b, s, kvh, g, hd, c, dtype, sets=4)
            kv_pos = torch.arange(s, device=dev)
            q_pos = pos_t[:, None] + torch.arange(c, device=dev)
            mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]  # (B,1,C,S)
            lib = library(q, k, v, mask).transpose(1, 2)
            lib_err = (lib.float() - want.float()).abs().max().item()
            ms = graph_ms(torch, [lambda t=t: op(*t, pos_t) for t in sets])
            plain_ms = graph_ms(torch, [lambda t=t: plain(*t, pos_t, None) for t in sets])
            lib_ms = graph_ms(torch, [lambda t=t: library(*t, mask) for t in sets])
            bound_ms, bound_by = bound(kname, b, s, kvh, g, hd, c, pos, window, dname)
            log(f"time {kname} {name} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa {lib_ms:.4f} ms (err vs plain {lib_err:.2e}), bound {bound_ms:.4f} ms "
                f"({bound_by})")
            entries[kname] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": lib_ms}
    return entries


def phase_serve(torch, np, get, TransformerLM, ServeEngine, ContinuousBatcher, Request,
                dec_ops, pre_ops):
    cfg = get("olmo_1b")
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"serve: OLMo-1B full width ({sum(p.numel() for p in model.parameters())} params, "
        f"f32) initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens = [700, 64, 413, 257, 590, 128]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    new = 16
    engine = ServeEngine(model, max_seq=1024, prefill_chunk=32, num_slots=4)
    first = {}
    dec_ops.decode_attention.launches = 0
    pre_ops.prefill_attention.launches = 0
    start = time.perf_counter()

    def on_token(uid, tok):
        first.setdefault(uid, time.perf_counter() - start)

    toks = engine.generate({"tokens": prompts}, new, on_token=on_token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {"decode_attention": dec_ops.decode_attention.launches,
                "prefill_attention": pre_ops.prefill_attention.launches}
    st = engine.last_stats
    log(f"serve: dispatches decode={st['decode_dispatches']} prefill={st['prefill_dispatches']}; "
        f"launches {launches}; wall {wall:.3f} s")
    want = {"decode_attention": LAYERS * st["decode_dispatches"],
            "prefill_attention": LAYERS * st["prefill_dispatches"]}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"kernel launches {launches} != expected {want}")
    if toks.shape != (len(lens), new) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad output tokens: shape {toks.shape}")
    decode_tokens = len(lens) * (new - 1)  # the first token of each comes from prefill
    ttft = sorted(first.values())
    log(f"serve: decode {decode_tokens / st['decode_s']:.1f} tok/s "
        f"({decode_tokens} tokens in {st['decode_s']:.3f} s), prefill "
        f"{st['prefill_tokens'] / st['prefill_s']:.1f} tok/s ({st['prefill_tokens']} "
        f"tokens in {st['prefill_s']:.3f} s), TTFT p50 {statistics.median(ttft):.3f} s "
        f"max {ttft[-1]:.3f} s")

    # the same requests through the plain attention path, recording margins
    model.cfg = dataclasses.replace(cfg, attn_backend="plain")
    margins: dict = {}

    def greedy_with_margin(req, row):
        top2 = np.partition(row, -2)[-2:]
        if not np.isfinite(row).all():
            raise AssertionError(f"non-finite logits for request {req.uid}")
        margins.setdefault(req.uid, []).append(float(top2[1] - top2[0]))
        return int(np.argmax(row))

    batcher = ContinuousBatcher(model, num_slots=4, max_seq=1024, prefill_chunk=32,
                                sample_fn=greedy_with_margin)
    for uid, p in enumerate(prompts):
        batcher.submit(Request(uid=uid, tokens=p, max_new=new))
    plain_out = {r.uid: r.out for r in batcher.run()}
    model.cfg = cfg
    compared = 0
    for uid in range(len(lens)):
        for t in range(new):
            if margins[uid][t] < MARGIN:
                log(f"serve: request {uid} comparison ends at step {t}: plain top-2 "
                    f"margin {margins[uid][t]:.2e} < {MARGIN}")
                break
            if plain_out[uid][t] != int(toks[uid, t]):
                raise AssertionError(
                    f"request {uid} step {t}: kernel token {toks[uid, t]} != plain "
                    f"{plain_out[uid][t]} (margin {margins[uid][t]:.3e})")
            compared += 1
    log(f"serve: kernel path == plain path on {compared}/{len(lens) * new} greedy tokens")
    del model, engine, batcher
    torch.cuda.empty_cache()
    return launches


def phase_small_reference(torch, get, TransformerLM):
    """Smoke configs on the card (kernel backend) vs the same weights on
    the CPU (plain backend): prefill + decode logits within 1e-4."""
    for arch in ("olmo_1b", "qwen2_5_14b"):
        cfg = get(arch, smoke=True)
        gpu = TransformerLM(cfg, device="cuda", seed=1)
        cpu = TransformerLM(dataclasses.replace(cfg, attn_backend="plain"), device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        g = torch.Generator().manual_seed(2)
        b, s, c = 3, 64, 7
        toks = torch.randint(0, cfg.vocab_size, (b, c), generator=g)
        tids = torch.tensor([0, 1, cfg.num_tasks])  # the last is a clamped null id
        pos = torch.tensor([0, 9, 50], dtype=torch.int32)
        valid = torch.tensor([[1] * 7, [1, 1, 1, 0, 0, 0, 0], [0] * 7], dtype=torch.bool)
        errs = []
        for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
            caches = m.init_cache(b, s)
            lp, caches = m.prefill_step(
                {"tokens": toks.to(dev), "task_ids": tids.to(dev)}, caches, pos.to(dev),
                valid.to(dev))
            p2 = (pos + valid.sum(1)).to(torch.int32)
            ld, _ = m.decode_step(
                {"tokens": toks[:, :1].to(dev), "task_ids": tids.to(dev)}, caches,
                p2.to(dev), live=torch.tensor([True, True, False], device=dev))
            errs.append((lp.float().cpu(), ld.float().cpu()))
        err = max((errs[0][i] - errs[1][i]).abs().max().item() for i in range(2))
        log(f"small reference {arch}: card (kernel) vs CPU (plain) max logits err {err:.2e}")
        if not err <= 1e-4:
            raise AssertionError(f"{arch}: card vs CPU logits differ by {err}")


def phase_profile(torch, np, get, TransformerLM, ContinuousBatcher, Request):
    """Where a dispatch's time goes at OLMo-1B full width: host wall time
    of an admission round (prefill of four prompts) and of 8 decode ticks,
    without and with torch.profiler, against the device time of the
    kernels the profiler saw, with the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = TransformerLM(get("olmo_1b"), device="cuda", seed=0)
    rng = np.random.default_rng(1)
    lens = (700, 300, 500, 100)

    def batcher():
        bt = ContinuousBatcher(model, num_slots=4, max_seq=1024, prefill_chunk=32)
        for uid, n in enumerate(lens):
            bt.submit(Request(uid=uid, tokens=rng.integers(0, model.cfg.vocab_size, n)
                              .astype(np.int32),
                              max_new=64))
        return bt

    def window(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def ticks(bt, n=8):
        for _ in range(n):
            bt.tick()

    for name, setup, run in (
        ("prefill round", batcher, lambda bt: bt._admit()),
        ("8 decode ticks", lambda: _admitted(batcher()), ticks),
    ):
        bt = setup()
        wall = window(lambda: run(bt))
        bt = setup()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_prof = window(lambda: run(bt))
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_us = {e.key: e.self_device_time_total for e in kern}
        busy = sum(dev_us.values()) / 1e6
        log(f"profile {name}: wall {wall * 1e3:.2f} ms (profiler off), "
            f"{wall_prof * 1e3:.2f} ms (on); device busy {busy * 1e3:.2f} ms "
            f"= {busy / wall_prof:.1%} of the traced wall; kernels {len(dev_us)} kinds, "
            f"{sum(e.count for e in kern)} launches")
        for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
            log(f"profile {name}:   {us / 1e3:8.3f} ms  {key[:90]}")
    del model
    torch.cuda.empty_cache()


def _admitted(bt):
    bt._admit()  # prefill every prompt; the decode ticks start from here
    bt.tick()
    return bt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.kernels import runtime
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.prefill_attention import ops as pre_ops
    from repro_torch.kernels.prefill_attention import ref as pre_ref
    from repro_torch.models import TransformerLM
    from repro_torch.serve import ContinuousBatcher, Request, ServeEngine

    # full f32 products everywhere: no TF32, no reduced-precision bf16 sums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build(runtime)
    entries = phase_kernels(torch, F, dec_ops, pre_ops, dec_ref, pre_ref)
    phase_small_reference(torch, get, TransformerLM)
    launches = phase_serve(torch, np, get, TransformerLM, ServeEngine, ContinuousBatcher,
                           Request, dec_ops, pre_ops)
    phase_profile(torch, np, get, TransformerLM, ContinuousBatcher, Request)
    log(f"smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    meta = {
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:99",
                             "decode_attention_pallas"),
        "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                              "src/repro/kernels/prefill_attention/kernel.py:108",
                              "prefill_attention_pallas"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "jax": jax_fn,
         "launches": launches[name], **entries[name]}
        for name, (src, rep, jax_fn) in meta.items()
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
