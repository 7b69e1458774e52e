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
                every head-dim instantiation; the paged kernels over a pool
                of 16-token blocks with shuffled ids (1024 logical rows per
                slot); f32 (atol 2e-5) and bf16 (atol 2e-2). At the OLMo-1B
                f32 shapes it times each kernel, its plain version and the
                library calls computing the same function (library_ms, a
                yardstick the port never calls: scaled_dot_product_attention,
                after gather_pages when paged), and computes the bound.
  3. serve    — OLMo-1B at full width (f32, random weights from seed 0, one
                model for every serve phase) through ServeEngine.generate:
                6 requests with ragged 64..700-token prompts over 4 slots,
                16 new tokens each, on the dense cache. Launch counters,
                zeroed just before, must show 16 kernel launches per
                dispatch. The same requests through the plain attention
                path must give the same greedy tokens (a request's
                comparison ends at the first step whose plain top-2 logit
                margin is below 1e-3). Smoke configs on the card must match
                a CPU run within 1e-4 (logits), dense and paged.
  4. paged    — the same 6 requests over a paged pool of 1024 tokens, a
                quarter of the dense cache (PagingSpec.sized(16, 1024,
                1024)): admission must wait on blocks at least once; 16 paged-kernel launches per
                dispatch; greedy parity with the plain path (same paging)
                and with the dense phase's tokens under the margin rule.
  5. prefix   — 8 requests sharing one 500-token system prompt, distinct
                40..200-token tails, 16 new tokens each, 4 slots, paged pool
                of 4096 tokens with the prefix cache: the second admission
                wave hits the first wave's registrations and copy-on-writes
                the partly shared 32nd block. Prints the hit ratio, the COW
                count and the prefill tokens saved against the same
                requests without the cache; fails if either is 0, on launch
                counts, or on greedy parity with the plain path and with
                the no-cache run.
  6. profile  — host wall time of a prefill round and of 8 decode ticks at
                OLMo-1B full width, dense and paged, against the device
                time torch.profiler sees, with the top kernels (measurement
                only).

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


def bound(b, s, kvh, g, hd, c, pos, window, dtype, block=None):
    """Least time on the card: (bytes each input/output moves once) over
    HBM bandwidth vs (flops these positions need) over the dtype's peak.
    Paged (``block`` rows per page, s = max_blocks * block logical rows):
    the pages holding the visible rows, read whole, plus the block table."""
    es = 4 if dtype == "float32" else 2
    h = kvh * g
    kv_rows = flops = 0
    for p in pos:
        lo, _ = visible_rows(p, s, window)
        _, hi = visible_rows(p + c - 1, s, window)
        if block:
            kv_rows += (hi // block - lo // block + 1) * block
        else:
            kv_rows += hi - lo + 1
        for i in range(c):
            klo, khi = visible_rows(p + i, s, window)
            flops += 4 * h * hd * max(0, khi - klo + 1)
    nbytes = kv_rows * kvh * hd * es * 2 + 2 * b * c * h * hd * es + 4 * b
    if block:
        nbytes += 4 * b * (s // block)
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


def phase_kernels(torch, F, dec_ops, pre_ops, dec_ref, pre_ref, gather_pages):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, kvh, g, hd, c, dtype, block=None, sets=1):
        """(q, k, v, table) per set: dense caches (B, S, KVH, hd) and table
        None, or (paged, block rows per page) pools of B * S / block + 1
        blocks with shuffled physical ids, slot 0 mapping only its first
        half (unmapped pages point at the null block 0)."""
        out = []
        for _ in range(sets):
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            q = rnd(b, c, kvh * g, hd)
            if block is None:
                out.append((q, rnd(b, s, kvh, hd), rnd(b, s, kvh, hd), None))
                continue
            mb = s // block
            nb = b * mb + 1
            ids = torch.randperm(nb - 1, generator=gen, device=dev) + 1
            table = ids.reshape(b, mb).to(torch.int32)
            table[0, mb // 2:] = 0
            out.append((q, rnd(nb, block, kvh, hd), rnd(nb, block, kvh, hd),
                        table.contiguous()))
        return out

    def plain(q, k, v, table, pos, window):
        b, c, h, hd = q.shape
        kvh = k.shape[2]
        if table is not None:
            k, v = gather_pages(k, table), gather_pages(v, table)
        if c == 1:
            o = dec_ref.decode_attention_reference(
                q.reshape(b, kvh, h // kvh, hd), k, v, pos, window=window)
            return o.reshape(b, 1, h, hd)
        qg = q.reshape(b, c, kvh, h // kvh, hd).permute(0, 2, 1, 3, 4)
        o = pre_ref.prefill_attention_reference(qg, k, v, pos, window=window)
        return o.permute(0, 2, 1, 3, 4).reshape(b, c, h, hd)

    def library(q, k, v, table, mask):  # timed at OLMo-1B's shapes only: MHA, G = 1
        if table is not None:  # two calls: the gather, then SDPA
            k, v = gather_pages(k, table), gather_pages(v, table)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        )

    def kernel_op(c, block):
        if block is None:
            return ((dec_ops.decode_attention, "decode_attention") if c == 1
                    else (pre_ops.prefill_attention, "prefill_attention"))
        return ((dec_ops.paged_decode_attention, "paged_decode_attention") if c == 1
                else (pre_ops.paged_prefill_attention, "paged_prefill_attention"))

    def call(op, q, k, v, table, pos, window=None):
        if table is None:
            return op(q, k, v, pos, window=window)
        return op(q, k, v, table, pos, window=window)

    cases = [
        # name, B, S (logical rows per slot), KVH, G, hd, C, pos, window, block
        ("olmo_1b", 4, 1024, 16, 1, 128, 1, [63, 300, 700, 1023], None, None),
        ("olmo_1b", 4, 1024, 16, 1, 128, 32, [0, 200, 640, 992], None, None),
        ("qwen2_5_14b", 4, 1024, 8, 5, 128, 1, [0, 513, 64, 1000], None, None),
        ("qwen2_5_14b", 4, 1024, 8, 5, 128, 32, [100, 992, 0, 431], None, None),
        ("olmo_1b_window256", 4, 1024, 16, 1, 128, 1, [63, 300, 700, 1023], 256, None),
        ("olmo_1b_window256", 4, 1024, 16, 1, 128, 32, [0, 200, 640, 992], 256, None),
        ("hd64_window", 2, 300, 2, 4, 64, 3, [10, 297], 64, None),
        ("hd64_window", 2, 300, 2, 4, 64, 1, [299, 17], 100, None),
        ("hd32_gqa", 2, 200, 4, 2, 32, 8, [0, 190], None, None),
        ("hd32_gqa", 2, 200, 4, 2, 32, 1, [150, 199], None, None),
        ("masked_rows", 1, 100, 1, 1, 64, 5, [98], 3, None),
        # paged: 16-token pages, slot 0 maps only its first 512 rows
        ("olmo_1b", 4, 1024, 16, 1, 128, 1, [63, 300, 700, 1023], None, 16),
        ("olmo_1b", 4, 1024, 16, 1, 128, 32, [0, 200, 640, 992], None, 16),
        ("qwen2_5_14b_window256", 4, 1024, 8, 5, 128, 1, [0, 513, 64, 1000], 256, 16),
        ("qwen2_5_14b_window256", 4, 1024, 8, 5, 128, 32, [100, 992, 0, 431], 256, 16),
        ("hd64_stale_pos", 3, 96, 2, 4, 64, 1, [396, 40, 95], 16, 8),  # slot 0 sees no key
        ("hd32_block8", 2, 200, 4, 2, 32, 3, [5, 197], None, 8),
    ]
    entries = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for name, b, s, kvh, g, hd, c, pos, window, block in cases:
            op, kname = kernel_op(c, block)
            pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
            (q, k, v, table), = inputs(b, s, kvh, g, hd, c, dtype, block)
            got = call(op, q, k, v, table, pos_t, window)
            torch.cuda.synchronize()
            want = plain(q, k, v, table, pos_t, window)
            err = (got.float() - want.float()).abs().max().item()
            ok = err <= TOL[dname] and torch.isfinite(got.float()).all().item()
            log(f"kernel {kname} {name} B={b} S={s} KVH={kvh} G={g} hd={hd} C={c} "
                f"window={window} block={block} {dname}: max_abs_err={err:.3e} "
                f"(atol {TOL[dname]})")
            if not ok:
                raise AssertionError(f"{kname} {name} {dname}: max_abs_err {err} > {TOL[dname]}")
            if name != "olmo_1b" or dname != "float32":
                continue
            # timing at the main path's shapes, 4 input sets per graph
            sets = inputs(b, s, kvh, g, hd, c, dtype, block, sets=4)
            kv_pos = torch.arange(s, device=dev)
            q_pos = pos_t[:, None] + torch.arange(c, device=dev)
            mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]  # (B,1,C,S)
            lib = library(q, k, v, table, mask).transpose(1, 2)
            lib_err = (lib.float() - want.float()).abs().max().item()
            ms = graph_ms(torch, [lambda t=t: call(op, *t, pos_t) for t in sets])
            plain_ms = graph_ms(torch, [lambda t=t: plain(*t, pos_t, None) for t in sets])
            lib_ms = graph_ms(torch, [lambda t=t: library(*t, mask) for t in sets])
            bound_ms, bound_by = bound(b, s, kvh, g, hd, c, pos, window, dname, block)
            lib_name = ("gather_pages + scaled_dot_product_attention" if block
                        else "scaled_dot_product_attention")
            log(f"time {kname} {name} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library ({lib_name}) {lib_ms:.4f} ms (err vs plain {lib_err:.2e}), "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            entries[kname] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": lib_ms, "library": lib_name}
    return entries


COUNTED = ("decode_attention", "prefill_attention", "paged_decode_attention",
           "paged_prefill_attention")


def zero_counts(ops):
    for name in COUNTED:
        ops[name].launches = 0


def read_counts(ops):
    return {name: ops[name].launches for name in COUNTED}


def check_launches(phase, launches, st, paged):
    """16 launches of the decode kernel per decode dispatch and of the
    prefill kernel per prefill dispatch, of the layout's kernels only."""
    pre = "paged_" if paged else ""
    want = {name: 0 for name in COUNTED}
    want[pre + "decode_attention"] = LAYERS * st["decode_dispatches"]
    want[pre + "prefill_attention"] = LAYERS * st["prefill_dispatches"]
    log(f"{phase}: dispatches decode={st['decode_dispatches']} "
        f"prefill={st['prefill_dispatches']}; launches {launches}")
    if launches != want or min(want[pre + "decode_attention"],
                               want[pre + "prefill_attention"]) == 0:
        raise AssertionError(f"{phase}: kernel launches {launches} != expected {want}")


def serve_timed(torch, engine, prompts, new, ops, task_ids=None):
    """One ServeEngine.generate call with the launch counts zeroed just
    before and read just after; returns (tokens, launches, ttft list, wall)."""
    first = {}
    batch = {"tokens": prompts}
    if task_ids is not None:
        batch["task_ids"] = task_ids
    torch.cuda.synchronize()
    zero_counts(ops)
    start = time.perf_counter()

    def on_token(uid, tok):
        first.setdefault(uid, time.perf_counter() - start)

    toks = engine.generate(batch, new, on_token=on_token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    return toks, read_counts(ops), sorted(first.values()), wall


def report_rates(phase, st, n_req, new, ttft, wall):
    decode_tokens = n_req * (new - 1)  # each request's first token comes from prefill
    rates = {
        "decode_tok_s": decode_tokens / st["decode_s"],
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1], "wall_s": wall,
    }
    log(f"{phase}: decode {rates['decode_tok_s']:.1f} tok/s ({decode_tokens} tokens in "
        f"{st['decode_s']:.3f} s), prefill {rates['prefill_tok_s']:.1f} tok/s "
        f"({st['prefill_tokens']} tokens in {st['prefill_s']:.3f} s), TTFT p50 "
        f"{rates['ttft_p50_s']:.3f} s max {rates['ttft_max_s']:.3f} s, wall {wall:.3f} s")
    return rates


def plain_run(np, model, cfg, prompts, new, ContinuousBatcher, Request, **batcher_kw):
    """The same requests through the plain attention path, greedy, with
    each step's top-2 logit margin recorded: (outputs, margins) by uid."""
    model.cfg = dataclasses.replace(cfg, attn_backend="plain")
    margins: dict = {}

    def greedy_with_margin(req, row):
        if not np.isfinite(row).all():
            raise AssertionError(f"non-finite logits for request {req.uid}")
        top2 = np.partition(row, -2)[-2:]
        margins.setdefault(req.uid, []).append(float(top2[1] - top2[0]))
        return int(np.argmax(row))

    try:
        batcher = ContinuousBatcher(model, num_slots=4, max_seq=1024, prefill_chunk=32,
                                    sample_fn=greedy_with_margin, **batcher_kw)
        for uid, p in enumerate(prompts):
            batcher.submit(Request(uid=uid, tokens=p, max_new=new))
        out = {r.uid: r.out for r in batcher.run()}
    finally:
        model.cfg = cfg
    return out, margins


def compare(phase, what, toks, ref, margins, new):
    """Greedy parity under the margin rule: a request's comparison ends at
    the first step whose plain top-2 margin is below MARGIN."""
    compared = 0
    for uid in range(len(toks)):
        for t in range(new):
            if margins[uid][t] < MARGIN:
                log(f"{phase}: request {uid} comparison with {what} ends at step {t}: "
                    f"plain top-2 margin {margins[uid][t]:.2e} < {MARGIN}")
                break
            if int(ref[uid][t]) != int(toks[uid][t]):
                raise AssertionError(
                    f"{phase}: request {uid} step {t}: kernel token {toks[uid][t]} != "
                    f"{what} {ref[uid][t]} (margin {margins[uid][t]:.3e})")
            compared += 1
    log(f"{phase}: kernel path == {what} on {compared}/{len(toks) * new} greedy tokens")
    return compared


def check_tokens(phase, toks, n, new, vocab):
    if toks.shape != (n, new) or toks.min() < 0 or toks.max() >= vocab:
        raise AssertionError(f"{phase}: bad output tokens: shape {toks.shape}")


SERVE_LENS = [700, 64, 413, 257, 590, 128]
NEW = 16


def phase_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request, ops):
    """Dense cache: the PR 11 main path."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SERVE_LENS]
    engine = ServeEngine(model, max_seq=1024, prefill_chunk=32, num_slots=4)
    toks, launches, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops)
    st = engine.last_stats
    check_launches("serve", launches, st, paged=False)
    check_tokens("serve", toks, len(prompts), NEW, cfg.vocab_size)
    rates = report_rates("serve", st, len(prompts), NEW, ttft, wall)
    ref, margins = plain_run(np, model, cfg, prompts, NEW, ContinuousBatcher, Request)
    compare("serve", "plain path", toks, ref, margins, NEW)
    return {"launches": launches, "tokens": toks, "prompts": prompts, "rates": rates}


def phase_paged_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request, PagingSpec,
                      ops, dense):
    """The dense phase's requests over a pool of a quarter of their slots'
    worth of tokens: 16-token blocks, 1024 pool tokens (256 MB of f32 KV
    against the dense phase's 1 GB). Any four of these requests need at
    most 128 blocks, so a pool of 2048 tokens would hold every admission
    round and never apply backpressure; with 64 blocks the 413-token
    request waits for the first two to finish."""
    cfg = model.cfg
    prompts = dense["prompts"]
    spec = PagingSpec.sized(16, 1024, 1024)
    engine = ServeEngine(model, max_seq=1024, prefill_chunk=32, num_slots=4, paging=spec)
    toks, launches, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops)
    st = engine.last_stats
    check_launches("paged", launches, st, paged=True)
    check_tokens("paged", toks, len(prompts), NEW, cfg.vocab_size)
    log(f"paged: pool {spec.num_blocks - 1} blocks of {spec.block_size} tokens; admission "
        f"waited on blocks {st['admission_waits']} time(s)")
    if st["admission_waits"] == 0:
        raise AssertionError("paged: no admission waited on blocks")
    rates = report_rates("paged", st, len(prompts), NEW, ttft, wall)
    rates["admission_waits"] = st["admission_waits"]
    ref, margins = plain_run(np, model, cfg, prompts, NEW, ContinuousBatcher, Request,
                             paging=spec)
    compare("paged", "plain path (paged)", toks, ref, margins, NEW)
    compare("paged", "dense kernel path", toks, dense["tokens"], margins, NEW)
    return {"launches": launches, "rates": rates}


def phase_prefix_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request, PagingSpec,
                       ops):
    """Many chats behind one system prompt: 8 requests of one task share a
    500-token prefix (31 full 16-token blocks and 4 rows of the 32nd), with
    distinct 40..200-token tails; 4 slots, so the second admission wave
    hits the first wave's registrations and copy-on-writes block 32."""
    cfg = model.cfg
    rng = np.random.default_rng(1)
    system = rng.integers(0, cfg.vocab_size, 500).astype(np.int32)
    tails = rng.integers(40, 201, 8)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, n).astype(np.int32)])
               for n in tails]
    task_ids = np.zeros(len(prompts), np.int32)
    spec = PagingSpec.sized(16, 1024, 4096)
    engine = ServeEngine(model, max_seq=1024, prefill_chunk=32, num_slots=4, paging=spec,
                         prefix_cache=True)
    toks, launches, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops, task_ids)
    st, ps = engine.last_stats, engine.last_prefix_stats
    check_launches("prefix", launches, st, paged=True)
    check_tokens("prefix", toks, len(prompts), NEW, cfg.vocab_size)
    rates = report_rates("prefix", st, len(prompts), NEW, ttft, wall)
    # the same requests without the cache: every prompt token computed
    nocache = ServeEngine(model, max_seq=1024, prefill_chunk=32, num_slots=4, paging=spec)
    base_toks, _, base_ttft, base_wall = serve_timed(torch, nocache, prompts, NEW, ops,
                                                     task_ids)
    base = nocache.last_stats
    saved = base["prefill_tokens"] - ps["prefill_tokens"]
    log(f"prefix: hit ratio {ps['hit_ratio']:.4f} ({ps['hit_tokens']} of "
        f"{ps['lookup_tokens']} prompt tokens), cow_copies {ps['cow_copies']}, prefill "
        f"tokens {ps['prefill_tokens']} vs {base['prefill_tokens']} without the cache "
        f"({saved} saved); prefill dispatches {st['prefill_dispatches']} vs "
        f"{base['prefill_dispatches']}; without the cache TTFT p50 "
        f"{statistics.median(base_ttft):.3f} s max {base_ttft[-1]:.3f} s, wall "
        f"{base_wall:.3f} s")
    if ps["cow_copies"] == 0 or saved <= 0:
        raise AssertionError(f"prefix: cow_copies {ps['cow_copies']}, tokens saved {saved}")
    ref, margins = plain_run(np, model, cfg, prompts, NEW, ContinuousBatcher, Request,
                             paging=spec, prefix_cache=True)
    compare("prefix", "plain path (prefix cache)", toks, ref, margins, NEW)
    compare("prefix", "kernel path without the cache", toks, base_toks, margins, NEW)
    rates.update(hit_ratio=ps["hit_ratio"], cow_copies=ps["cow_copies"],
                 prefill_tokens=ps["prefill_tokens"],
                 prefill_tokens_no_cache=base["prefill_tokens"],
                 ttft_p50_s_no_cache=statistics.median(base_ttft))
    return {"launches": launches, "rates": rates}


def phase_small_reference(torch, get, TransformerLM, PagingSpec):
    """Smoke configs on the card (kernel backend) vs the same weights on
    the CPU (plain backend): prefill + decode logits within 1e-4, over the
    dense cache and over a paged pool with shuffled block ids."""
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
        spec = PagingSpec.sized(8, s, 3 * s)
        table = (torch.randperm(spec.num_blocks - 1, generator=g)[: b * spec.max_blocks_per_slot]
                 + 1).reshape(b, -1).to(torch.int32)
        for layout, paging in (("dense", None), ("paged", spec)):
            errs = []
            for m, dev in ((gpu, "cuda"), (cpu, "cpu")):
                caches = m.init_cache(b, s, paging)
                bt = None if paging is None else table.to(dev)
                lp, caches = m.prefill_step(
                    {"tokens": toks.to(dev), "task_ids": tids.to(dev)}, caches, pos.to(dev),
                    valid.to(dev), block_tables=bt)
                p2 = (pos + valid.sum(1)).to(torch.int32)
                ld, _ = m.decode_step(
                    {"tokens": toks[:, :1].to(dev), "task_ids": tids.to(dev)}, caches,
                    p2.to(dev), live=torch.tensor([True, True, False], device=dev),
                    block_tables=bt)
                # rows of slot 2 (no valid token, dead) are discarded by callers
                errs.append((lp[:2].float().cpu(), ld[:2].float().cpu()))
            err = max((errs[0][i] - errs[1][i]).abs().max().item() for i in range(2))
            log(f"small reference {arch} {layout}: card (kernel) vs CPU (plain) max logits "
                f"err {err:.2e}")
            if not err <= 1e-4:
                raise AssertionError(f"{arch} {layout}: card vs CPU logits differ by {err}")


def phase_profile(torch, np, model, ContinuousBatcher, Request, PagingSpec):
    """Where a dispatch's time goes at OLMo-1B full width: host wall time
    of an admission round (prefill of four prompts) and of 8 decode ticks,
    over the dense cache and over a paged pool (16-token blocks, 4096
    tokens), without and with torch.profiler, against the device time of
    the kernels the profiler saw, with the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    lens = (700, 300, 500, 100)

    def batcher(paging=None):
        bt = ContinuousBatcher(model, num_slots=4, max_seq=1024, prefill_chunk=32,
                               paging=paging)
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

    spec = PagingSpec.sized(16, 1024, 4096)
    for name, setup, run in (
        ("prefill round", batcher, lambda bt: bt._admit()),
        ("8 decode ticks", lambda: _admitted(batcher()), ticks),
        ("prefill round (paged)", lambda: batcher(spec), lambda bt: bt._admit()),
        ("8 decode ticks (paged)", lambda: _admitted(batcher(spec)), ticks),
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
    from repro_torch.serve import ContinuousBatcher, PagingSpec, Request, ServeEngine

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
    ops = {"decode_attention": dec_ops.decode_attention,
           "prefill_attention": pre_ops.prefill_attention,
           "paged_decode_attention": dec_ops.paged_decode_attention,
           "paged_prefill_attention": pre_ops.paged_prefill_attention}
    t0 = time.perf_counter()
    phase_build(runtime)
    entries = phase_kernels(torch, F, dec_ops, pre_ops, dec_ref, pre_ref, runtime.gather_pages)
    phase_small_reference(torch, get, TransformerLM, PagingSpec)
    t1 = time.perf_counter()
    model = TransformerLM(get("olmo_1b"), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"serve: OLMo-1B full width ({sum(p.numel() for p in model.parameters())} params, "
        f"f32) initialised in {time.perf_counter() - t1:.1f} s; one model for every "
        "serve phase")
    dense = phase_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request, ops)
    paged = phase_paged_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request,
                              PagingSpec, ops, dense)
    prefix = phase_prefix_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request,
                                PagingSpec, ops)
    phase_profile(torch, np, model, ContinuousBatcher, Request, PagingSpec)
    log(json.dumps({"serve_rates": {"dense": dense["rates"], "paged": paged["rates"],
                                    "prefix": prefix["rates"]}}))
    log(f"smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    # launches of each kernel on its main path: the dense phase for the
    # dense kernels, the paged and prefix phases (summed) for the paged ones
    launches = {
        name: dense["launches"][name] + paged["launches"][name] + prefix["launches"][name]
        for name in COUNTED
    }
    meta = {
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:99",
                             "decode_attention_pallas"),
        "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                              "src/repro/kernels/prefill_attention/kernel.py:108",
                              "prefill_attention_pallas"),
        "paged_decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:207",
                                   "paged_decode_attention_pallas"),
        "paged_prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                                    "src/repro/kernels/prefill_attention/kernel.py:218",
                                    "paged_prefill_attention_pallas"),
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
