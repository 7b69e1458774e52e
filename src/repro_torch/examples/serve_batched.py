"""Serve a small model two ways over the same vectorized decode step. The
counterpart of the reference's ``examples/serve_batched.py``:

  1. ``ServeEngine`` — a uniform batch of requests (chunked prefill + one
     decode dispatch per token for the whole batch), with per-task
     personalization picked up from each request's task id.
  2. ``ContinuousBatcher`` — staggered requests over a fixed slot pool: one
     tick advances every live slot at its own position, prompts are
     prefilled a whole chunk per dispatch, and outputs match (1) exactly
     under greedy decoding.
  3. ``ContinuousBatcher`` with a PAGED KV cache: attention caches become a
     shared block pool + per-slot block tables (``repro_torch.serve.paging``),
     so the same 4 requests run on a quarter of the dense KV memory with
     identical greedy output.
  4. Prefill modes: every prompt chunk above was computed by the
     parallel-within-chunk prefill step (one dispatch = C tokens in
     parallel); ``prefill_mode="scan"`` replays the per-token oracle and the
     outputs must match token-for-token.
  5. Attention backends: the model above serves through the plain attention
     path (the reference's default ``jnp`` path); rebuilding it with
     ``dataclasses.replace(cfg, attn_backend="kernel")`` serves decode and
     prefill from the hand-written CUDA kernels (on CUDA tensors; their
     plain versions on CPU tensors) with identical greedy output.
  6. Prefix cache: 4 requests sharing a 28-token system prompt served
     through 2 slots with ``prefix_cache=True`` — the second admission
     wave serves the shared tokens from the radix-cached blocks
     (copy-on-writing the partially shared tail block), prints the
     measured cache-hit ratio, and still matches the no-sharing engine
     token-for-token.

Plus a numerical cross-check of the attention kernels against the serving
path's plain attention at per-slot positions: the flash-decode kernel, as
the reference checks, and the prefill, paged decode and paged prefill
kernels beside it.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.convert import load_numpy_params
from repro_torch.experiments.common import add_device_arg, full_f32, synchronize
from repro_torch.kernels.runtime import require_device
from repro_torch.models import TransformerLM
from repro_torch.models.attention import cached_attend, decode_attend
from repro_torch.serve import ContinuousBatcher, PagingSpec, Request, ServeEngine

BATCH, PROMPT, NEW = 4, 32, 32


def _submit(batcher, prompts, task_ids):
    for i in range(len(prompts)):
        batcher.submit(Request(uid=i, tokens=prompts[i], max_new=NEW,
                               task_id=int(task_ids[i])))


def _cross_check(rng, cfg, dev) -> dict:
    """Max |kernel - plain| of the four attention kernels, each called
    through the serving path's ``cached_attend(backend="kernel")`` against
    ``decode_attend`` on the same inputs: per-slot positions, as the
    batcher sends them; the paged pools hold the dense caches' rows under
    a shuffled block table."""
    b, s, kvh, hd = 2, 256, cfg.num_kv_heads, cfg.head_dim
    h = cfg.num_heads

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    q, k, v = normal(b, 1, h, hd), normal(b, s, kvh, hd), normal(b, s, kvh, hd)
    pos = torch.as_tensor([200, 57], dtype=torch.int32, device=dev)  # slots at different depths
    out = {"decode": float((decode_attend(q, k, v, pos)
                            - cached_attend(q, k, v, pos, backend="kernel")).abs().max())}
    chunk = normal(b, 8, h, hd)
    pos_c = torch.as_tensor([192, 40], dtype=torch.int32, device=dev)
    out["prefill"] = float((decode_attend(chunk, k, v, pos_c)
                            - cached_attend(chunk, k, v, pos_c, backend="kernel")).abs().max())
    bs = 16
    per_slot = s // bs
    ids = torch.as_tensor(1 + rng.permutation(b * per_slot), dtype=torch.int32, device=dev)
    table = ids.reshape(b, per_slot)  # block 0 stays the null block
    pools = []
    for cache in (k, v):
        pool = torch.zeros((b * per_slot + 1, bs, kvh, hd), device=dev)
        pool[table.long()] = cache.reshape(b, per_slot, bs, kvh, hd)
        pools.append(pool)
    for name, qq, pp in (("paged_decode", q, pos), ("paged_prefill", chunk, pos_c)):
        got = cached_attend(qq, *pools, pp, backend="kernel", block_tables=table)
        out[name] = float((decode_attend(qq, k, v, pp) - got).abs().max())
    return out


def main(argv=None, params=None) -> dict:
    """``params``: optional JAX params tree with numpy leaves for the model
    (``repro_torch.convert``); without it the model seeds its own init.
    Returns the numbers and parity booleans it prints."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    full_f32()
    dev = require_device(args.device)

    # reduced GQA config, on the plain attention path (the reference's default)
    cfg = dataclasses.replace(get("qwen2_5_14b", smoke=True), attn_backend="plain")
    model = TransformerLM(cfg, device=dev, seed=0)
    if params is not None:
        load_numpy_params(model, params)
    engine = ServeEngine(model, max_seq=96)
    res = {}

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int64).astype(np.int32)
    task_ids = np.arange(BATCH, dtype=np.int32) % cfg.num_tasks

    t0 = time.perf_counter()
    out = engine.generate({"tokens": prompts, "task_ids": task_ids}, num_tokens=NEW)
    dt = time.perf_counter() - t0
    res["engine_tok_s"] = BATCH * NEW / dt
    res["first_continuation"] = out[0][:16].tolist()
    print(f"generated {out.shape} tokens for {BATCH} batched requests "
          f"in {dt:.1f}s ({res['engine_tok_s']:.1f} tok/s on {dev.type})")
    print("first request's continuation:", res["first_continuation"])

    # ---- continuous batching: staggered requests, one dispatch per tick ----
    batcher = ContinuousBatcher(model, num_slots=2, max_seq=96)
    _submit(batcher, prompts, task_ids)
    t0 = time.perf_counter()
    done = batcher.run()
    dt = time.perf_counter() - t0
    by_uid = {r.uid: r.out for r in done}
    res["batcher_match"] = all(by_uid[i] == out[i].tolist() for i in range(BATCH))
    res.update(ticks=batcher.ticks, decode_dispatches=batcher.decode_dispatches,
               prefill_dispatches=batcher.prefill_dispatches)
    print(f"continuous batcher: {BATCH} requests over 2 slots in {dt:.1f}s — "
          f"{batcher.ticks} ticks, {batcher.decode_dispatches} decode dispatches "
          f"({batcher.decode_dispatches / batcher.ticks:.0f}/tick), "
          f"{batcher.prefill_dispatches} chunked prefill dispatches")
    print(f"batcher output == engine output (greedy, token-for-token): "
          f"{res['batcher_match']}")

    # ---- paged KV cache: same requests, a quarter of the KV memory ----
    # each request needs 64 tokens = 8 blocks of 8; a 48-block pool holds both
    # live slots with room to spare, vs 2 slots x 96 dense
    spec = PagingSpec.sized(block_size=8, max_seq=96, pool_tokens=48 * 8)
    paged = ContinuousBatcher(model, num_slots=2, max_seq=96, paging=spec)
    _submit(paged, prompts, task_ids)
    done_paged = {r.uid: r.out for r in paged.run()}
    res["paged_match"] = all(done_paged[i] == out[i].tolist() for i in range(BATCH))
    res["free_blocks"] = paged.allocator.free_blocks
    print(f"paged batcher (block_size={spec.block_size}, "
          f"{spec.num_blocks - 1} blocks): outputs match dense engine: "
          f"{res['paged_match']}; blocks free after run: "
          f"{paged.allocator.free_blocks}/{spec.num_blocks - 1}")

    # ---- prefill modes: parallel-within-chunk vs the per-token scan oracle ----
    t0 = time.perf_counter()
    oracle = ContinuousBatcher(model, num_slots=2, max_seq=96, prefill_mode="scan")
    _submit(oracle, prompts, task_ids)
    done_scan = {r.uid: r.out for r in oracle.run()}
    dt = time.perf_counter() - t0
    res["scan_match"] = all(done_scan[i] == by_uid[i] for i in range(BATCH))
    print(f"per-token-scan prefill oracle in {dt:.1f}s: outputs match the "
          f"parallel prefill path: {res['scan_match']}")

    # ---- attention backend: serve straight from the hand-written kernels ----
    kernel_model = TransformerLM(dataclasses.replace(cfg, attn_backend="kernel"), device=dev)
    kernel_model.load_state_dict(model.state_dict())
    flash = ContinuousBatcher(kernel_model, num_slots=2, max_seq=96)
    _submit(flash, prompts, task_ids)
    t0 = time.perf_counter()
    done_flash = {r.uid: r.out for r in flash.run()}
    dt = time.perf_counter() - t0
    res["kernel_match"] = all(done_flash[i] == out[i].tolist() for i in range(BATCH))
    route = "CUDA kernels" if dev.type == "cuda" else f"their plain versions on {dev.type}"
    print(f"attn_backend='kernel' (flash decode + chunked flash prefill, "
          f"{route}) in {dt:.1f}s: outputs match the plain backend: "
          f"{res['kernel_match']}")

    # ---- SLA scheduler: chunked prefill-decode interleaving + streaming ----
    # a token-budget scheduler co-schedules prompt chunks with decode in ONE
    # fused dispatch per tick: long prompts can no longer stall decoding
    # slots (head-of-line blocking), tokens stream per tick via on_token,
    # and requests can be cancelled mid-flight
    streamed = []
    sla = ContinuousBatcher(
        model, num_slots=2, max_seq=96, policy="sjf", chunk_budget=8,
        on_token=lambda r, t: streamed.append((r.uid, t)),
    )
    _submit(sla, prompts, task_ids)
    sla.step()          # one fused tick: prompt chunks + decode together
    sla.cancel(3)       # mid-flight cancellation frees the slot immediately
    done_sla = {r.uid: r for r in sla.run()}
    res["sla_match"] = all(done_sla[i].out == out[i].tolist() for i in range(3))
    res.update(mixed_dispatches=sla.mixed_dispatches, streamed=len(streamed),
               cancelled_emitted=len(done_sla[3].out))
    print(f"sjf + chunk_budget=8: {sla.mixed_dispatches} fused "
          f"prefill+decode dispatches, {len(streamed)} tokens streamed "
          f"per-tick, request 3 cancelled mid-flight "
          f"(emitted {res['cancelled_emitted']} tokens); "
          f"surviving outputs still match greedy engine: {res['sla_match']}")

    # ---- prefix cache: shared system prompt served once, aliased after ----
    # 4 requests open with the same 28-token system prompt (deliberately NOT
    # block-aligned) + distinct 4-token user suffixes. Served through 2 slots
    # in admission waves with prefix_cache=True: the first wave computes and
    # registers the prompt blocks in the radix cache, the second wave serves
    # the shared 28 tokens straight from those blocks — copy-on-writing the
    # partially shared 4th block — with greedy output identical to the dense
    # engine that recomputes everything.
    shared_sys = rng.integers(0, cfg.vocab_size, (28,), dtype=np.int64)
    px_tokens = np.stack([
        np.concatenate([shared_sys, rng.integers(0, cfg.vocab_size, (4,), dtype=np.int64)])
        for _ in range(BATCH)
    ]).astype(np.int32)
    px_prompts = {"tokens": px_tokens,
                  "task_ids": np.zeros(BATCH, np.int32)}  # the trie is per task id
    px_ref = engine.generate(px_prompts, num_tokens=16)
    px_engine = ServeEngine(model, max_seq=96, paging=spec, prefix_cache=True, num_slots=2)
    px_out = px_engine.generate(px_prompts, num_tokens=16)
    stats = px_engine.last_prefix_stats
    res["prefix_match"] = bool((px_out == px_ref).all())
    res.update({k: stats[k] for k in ("hit_ratio", "hit_tokens", "lookup_tokens",
                                      "cow_copies", "prefill_tokens")})
    print(f"prefix cache (28-token shared system prompt, 2-slot waves): "
          f"cache-hit ratio {stats['hit_ratio']:.2f} "
          f"({stats['hit_tokens']}/{stats['lookup_tokens']} prompt tokens "
          f"served from cached blocks), {stats['cow_copies']} copy-on-write "
          f"block copies, {stats['prefill_tokens']} tokens computed; outputs "
          f"match the no-sharing engine: {res['prefix_match']}")

    # ---- kernel cross-check: serving attention == the attention kernels ----
    res["cross_check"] = _cross_check(rng, cfg, dev)
    synchronize(dev)
    print(f"flash-decode kernel vs serving path (per-slot pos): "
          f"max |diff| = {res['cross_check']['decode']:.2e}")
    print("prefill, paged decode, paged prefill kernels vs serving path: max |diff| = "
          + ", ".join(f"{res['cross_check'][k]:.2e}"
                      for k in ("prefill", "paged_decode", "paged_prefill")))
    return res


if __name__ == "__main__":
    main()
