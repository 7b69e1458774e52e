#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; each raises on failure, and then no result line is printed:

  1. build    — compile every kernel source with nvcc for sm_90a, one
                process per source, all together.
  2. kernels  — each hand-written kernel against its plain PyTorch version
                on the card, at the serving path's shapes: OLMo-1B
                (B=4, S=1024, KVH=16, G=1, hd=128, ragged pos; prefill
                C=32), Qwen2.5-14B GQA (KVH=8, G=5), multitask-LM's decode
                and prefill (KVH=4, G=4, hd=64; prefill C=32: 128 rows in
                one block), Mixtral-8x22B's (KVH=8, G=6, S=8192, the
                4096-token window with positions past it; prefill C=32:
                192 rows), Zamba2-7B's shared attention (MHA, KVH=32,
                G=1, hd=112: the first head dim that is no power of two;
                S=2048; decode and prefill C=32, dense and paged, each
                timed in f32 against its bound and plain version),
                Pixtral-12B's (KVH=8, G=4, hd=160, padded to 256 in the
                decode block; S=2048; decode and prefill C=32: 128 slab
                rows; dense and paged, each timed in f32 against its bound,
                plain version and scaled_dot_product_attention with
                enable_gqa), a
                sliding window, and every head-dim instantiation; the paged kernels over a pool of 16-token
                blocks with shuffled ids (1024 logical rows per slot); f32
                (atol 2e-5) and bf16 (atol 2e-2). At the OLMo-1B f32
                shapes it times each kernel, its plain version and the
                library calls computing the same function (library_ms, a
                yardstick the port never calls: scaled_dot_product_attention,
                after gather_pages when paged), and computes the bound,
                beside the wrapper's nsplit. After phase 7 it
                reads, with torch.profiler, the device time of each CUDA
                kernel one such call launches (partial + combine)
                and of the kernels the library call runs. The graph-mix
                kernel against its plain version at the multitask-LM adapter store's full width (m=256 tasks,
                d=426,240) in f32 and bf16, at ragged m in {1, 12, 100} and
                d in {1000, 4099}, and under the bsr, bol and consensus
                matrices of band_graph(256, 2); f32 atol 1e-4 / rtol 1e-5,
                bf16 atol = rtol = 1e-2 against the f32 plain result rounded
                to bf16. At full width in f32 it times the kernel, the plain
                version and torch.matmul(mu.t(), theta) (library_ms, TF32
                off), and computes the bound (flops).
  3. serve    — OLMo-1B at full width (f32, random weights from seed 0, one
                model for every serve phase) through ServeEngine.generate:
                6 requests with ragged 64..700-token prompts over 4 slots,
                16 new tokens each, on the dense cache, each decode tick and
                prefill chunk one CUDA-graph replay (the default). Launch
                counters, zeroed just before, must show 16 kernel launches
                per dispatch, plus 16 for the one warm-up run of each step
                before its capture (replays add what their capture
                recorded). The same requests with cuda_graphs=False must
                give identical greedy tokens, and every logits row a
                sampler sees within 1e-5 of the eager one (dense and
                paged phases), and through the plain
                attention path (eager) the same greedy tokens (a request's
                comparison ends at the first step whose plain top-2 logit
                margin is below 1e-3). Every serve phase logs its capture
                time, its eager rates and torch.cuda.memory_allocated()
                after it. Smoke configs on the card must match a CPU run
                within 1e-4 (logits), dense and paged.
  4. paged    — the same 6 requests over a paged pool of 1024 tokens, a
                quarter of the dense cache (PagingSpec.sized(16, 1024,
                1024)): admission must wait on blocks at least once; 16 paged-kernel launches per
                dispatch (and per warm-up); graph tokens == eager tokens;
                greedy parity with the plain path (same paging) and with
                the dense phase's tokens under the margin rule.
  5. prefix   — 8 requests sharing one 500-token system prompt, distinct
                40..200-token tails, 16 new tokens each, 4 slots, paged pool
                of 4096 tokens with the prefix cache: the second admission
                wave hits the first wave's registrations and copy-on-writes
                the partly shared 32nd block. Prints the hit ratio, the COW
                count and the prefill tokens saved against the same
                requests without the cache; fails if either is 0, on launch
                counts, on graph tokens != eager tokens, or on greedy
                parity with the plain path and with the no-cache run.
  6. profile  — host wall time of a prefill round and of 8 decode ticks at
                OLMo-1B full width, dense and paged, with CUDA graphs and
                eagerly (the graphs captured before the window), against
                the device time torch.profiler sees, with the top kernels,
                the attention kernels' executions and device time, and the
                CUDA API calls the host made (cudaGraphLaunch, kernel
                launches, copies) per dispatch. Fails if a graph window
                launches a kernel from the host or does not make one
                cudaGraphLaunch per dispatch; logs whether the profiler saw
                16 partial + 16 merge attention kernels per tick.
  7. adapters — multitask-LM at full width (12 layers, d_model 1024, 256
                tasks, rank 8; f32, random weights from seed 0, dense cache,
                4 slots) serving 8 requests of 8 tasks (ids 0..255, prompts
                of 64..700 tokens, 16 new tokens each) under a
                TaskAdapterStore over band_graph(256, 2), bsr mixing,
                randomized factors (scale 1e-2), an update every 2 finishes
                with delays up to 2. Fails unless: 12 attention launches per
                dispatch (and per warm-up); the same requests eagerly, under
                a store built from the same seed, give identical tokens;
                10 graph-mix launches counted from the store's
                construction (1 at construction, 1 in randomize, 2 per
                update); the same greedy tokens as the plain attention path
                with the plain graph mix (margin rule); a zero store gives
                exactly the no-store tokens; the random adapters change some
                token; the kernel store's raw and serving trees equal the
                plain store's (atol 1e-4, rtol 1e-5). Prints decode and
                prefill tok/s and TTFT with and without the store, the host
                seconds in update(), and a profile of 8 decode ticks with
                and without the store.

  8. faults   — run between phases 5 and 6, on phase 3's OLMo-1B, CUDA graphs
                on: (a) phase 3's requests with an armed, empty FaultPlan (so
                the quarantine reads every dispatch's logits): tokens,
                decode and prefill dispatches, captures and launches equal
                phase 3's; (b) phase 4's requests with the quarantine alone:
                phase 4's tokens (its decode tok/s is the quarantine's
                price); (c) a scripted plan over phase 4's pool — the decode
                dispatch of tick 20 fails twice, the first prefill dispatch
                once, request 0's first logits row is poisoned: request 0
                ends failed ("non-finite"), the others give phase 4's
                tokens, 3 dispatch faults, 2 captures, check_invariants()
                clean with no live reference; (d) preemption: 2 slots,
                priority policy, the 700-token prompt with 64 new tokens
                at priority 10 (48 blocks), then, after two steps, the
                413-token prompt with 16 at priority 0 (27 blocks) over a
                1024-token pool of 63 blocks: one swap-out, one swap-in and
                one preemption, tokens equal to a 2048-token pool's without
                preemption, with graphs and eagerly, every pool's data_ptr
                unchanged, check_invariants() clean; it logs the
                synchronized swap-out and swap-in times, the snapshot's size
                and rate. Launch counts are checked in every run.
  9. paper    — run right after phase 2, before any model is built: the
                paper's own solvers at its workload (Appendix I: m=100
                tasks, d=100, n=500 per task, the 10-NN graph of 10
                clusters, numpy seed 0; eta, tau from Corollary 2), plain
                torch in f32 (TF32 off), through repro_torch.core: bsr, bol
                (exact and inexact prox), gd, admm, consensus_sgd,
                bol_delayed (fixed and random delays, Gamma 3, on the graph
                over its largest degree with tau times it: the same
                objective with rows summing to at most 1, as Theorem 7
                asks), ssr / sol / minibatch_prox on numpy-drawn replayed
                minibatches and again on minibatch_sampler with a CUDA
                generator, sdca (5 rounds), logistic bsr / bol (labels: the
                sign of y), alternating graph learning (3 rounds). Each run
                is timed, synchronized, on the card and on the machine's
                CPU; f* is the float64 closed form. Fails unless: every
                run the CPU can repeat exactly (all but sdca, random
                delays and the generator-sampled runs) gives on the card
                the CPU's objective trace within rtol 1e-4 and its final
                iterate within atol 1e-4; every gap to f* is at most the
                JAX reference's on the same workload and iterations
                (scripts/paper_reference.py) plus 3e-4, or 1.5 times it
                plus 3e-4 for runs whose draws the reference cannot
                replay; the learned graph's within/across-cluster
                affinity ratio is the reference's within 1e-3; and a bol
                call makes as many host syncs (torch's sync debug mode,
                after a first call that also reports one-time syncs) at 10
                iterations as at 40. Logs, on the card and on the CPU, ms
                per iteration (a run of the set count less one of 2
                iterations) and the set-up of a call, the gaps, where the
                syncs happen, and one {"paper": ...} JSON line.
 10. train    — run after phase 7, before the profiler breakdown; f32, TF32
                off, the port's trainer (AdamW at TRAIN_LR, the graph-mixed
                update over band_graph(num_tasks, 1), eta 0.1, tau 1):
                (a) multitask-LM at full width (256.47 M parameters, 256
                tasks) on numpy weights (train_weights), TokenPipeline
                batches of 8 x 128, 2 microbatches, 4 steps: the loss,
                nll and task-leaf norms within rtol 1e-4 of the JAX
                reference's (TRAIN_REF, from scripts/train_reference.py);
                (b) batch 32 x 256, 2 warm-up and 10 timed steps,
                synchronized, with remat on and off: ms/step, tokens/s,
                MFU against the f32 CUDA-core peak (6 N T + attention),
                peak memory; host syncs per step the same over 5 and 10
                steps; causal_attend against SDPA at that shape (logged);
                (c) OLMo-1B at full width (tied embeddings, parameter-free
                LayerNorm), 3 steps of 8 x 256: finite losses, peak
                memory; (d) `python -m repro_torch.launch.train --arch
                multitask_lm --no-smoke --steps 3 --batch 16 --seq 128
                --ckpt ...` as a subprocess exits 0, and its checkpoint,
                and that of the same run in this process, load with
                load_pytree into fresh models whose logits equal the
                trained model's (in-process: exactly; the launcher's:
                within 1e-3); (e) a multitask-LM batcher captured (CUDA
                graphs, kernel backend) and serving 4 greedy requests,
                then 2 train steps, then the requests again with no
                recapture: tokens == a fresh batcher's (logits rows
                within 1e-5), == the plain path's (margin rule), some
                logit moved by 1e-3, every parameter's data_ptr
                unchanged. Logs one {"train": ...} JSON line.
 11. moe      — run after phase 10, every earlier model freed (memory logged
                before and after): (a) Mixtral-8x22B at full width (d_model
                6144, d_ff 16384, 8 experts top-2, 48/8 heads, vocab 32768)
                and 4 of its 56 layers (the card holds ~41.7 GB of f32
                weights), capacity_factor 1.25, random weights from seed 0,
                max_seq 8192, prefill chunk 32, 4 slots: 6 requests of
                4500, 700, 64, 413, 257, 590 prompt tokens, 16 new tokens
                each, dense and paged (16-token blocks, a 32768-token
                pool), each with CUDA graphs and with cuda_graphs=False:
                4 attention launches per dispatch (and per warm-up), graph
                tokens == eager tokens, dense step logits with graphs
                within 1e-5 of eager, the same greedy tokens as the plain
                path (dense) and paged as dense (margin rule); the
                4500-token request's first-token logits with the window
                and without must differ by more than 1e-3 (the window
                masks on the card); a profile of 8 graph decode ticks, its
                device ms per tick against the bound of reading every
                weight (the capacity dispatch reads every expert) and the
                visible K/V once; (b) two requests (64, 100 tokens) at
                dropless capacity: prefill_mode "scan" gives the parallel
                mode's tokens (margin rule); (c) phi4-mini at full width
                (32 layers, tied embeddings at vocab 200064, f32): 4
                requests, 32 launches per dispatch, the plain path's
                tokens; (d) make_train_step with SGD and the graph-mixed
                update on Mixtral-8x22B at full width and 1 layer, 2 steps
                of batch 2 x 256: finite loss and aux, aux > 0, the router
                and task.router_bias moved (nonzero gradients); ms per
                step and peak memory logged. Logs one {"moe": ...} JSON
                line.

 12. hybrid   — run after phase 11, every earlier model freed: Zamba2-7B at
                full width and depth (81 layers: 68 mamba2 layers and 13
                invocations of ONE shared attention + MLP block; d_model
                3584, 32 heads of hd 112, ssm_state 64, vocab 32000; 5.74 B
                params, ~23 GB of f32 weights, nothing cut), random weights
                from seed 0, max_seq 2048, prefill chunk 32, 4 slots:
                (a) 6 requests of 64, 150, 350, 600, 128 and 295 prompt
                tokens (HYBRID_LENS, which phases 13-16 serve too), 16 new
                tokens each, dense and paged (16-token
                blocks, an 8192-token pool), each with CUDA graphs and with
                cuda_graphs=False: 13 attention launches per dispatch (and
                per warm-up), graph tokens == eager tokens, dense step
                logits with graphs within 1e-5 of eager, the plain path's
                tokens (dense) and paged == dense (margin rule), and the
                two requests admitted into reused slots (4 and 5) give the
                tokens they give alone in a fresh batcher (margin rule);
                (b) decode and prefill tok/s, TTFT p50 / max, peak memory;
                (c) a profile of 8 graph decode ticks: device ms per tick
                against the byte bound of reading every weight once per use
                (the shared block once per invocation), the recurrent
                states read and written and the visible K/V; (d) a
                preemption over 2 slots: a 700-token hog (64 new,
                priority 10) and a 413-token request (16 new, priority 0)
                in a 1024-token pool: one swap-out (the hog's pages and its
                68 layers' recurrent columns) and one swap-in, tokens ==
                a 4096-token pool's, caches unmoved; (e) 2 SGD steps with
                the graph-mixed update on the same model at full width and
                depth (the depth cut, and the cut logged, only if the step
                would pass 75 GB), batch 2 x 256, remat on: finite loss,
                a_log, dt_bias, conv_w and the shared block's weights moved,
                ms per step and peak memory logged; then a 2-layer Zamba2 at
                full width (a mamba2 layer and the shared block): the
                card's first-step loss within 1e-4 relative of the same port
                step on the host CPU, the same weights and batch. Logs one
                {"hybrid": ...} JSON line.
 13. mla      — run after phase 12, every earlier model freed: DeepSeek-V2-
                236B at full width (MLA: d_model 5120, 128 heads, kv_lora
                512, qk 128 + 64, v 128; 160 routed and 2 shared experts of
                d_ff 1536, top-6; vocab 102400) and MLA_LAYERS of its 60
                layers (~69 GB of f32 weights; depth is the only cut),
                random weights from seed 0, max_seq 2048, prefill chunk
                32, 4 slots: (a) phase 12's 6 requests, 16 new tokens
                each, dense and paged (16-token blocks, an 8192-token
                pool), each with CUDA graphs and with cuda_graphs=False: no
                attention-kernel launch (MLA is plain torch on every
                backend, as in the reference), graph tokens == eager
                tokens, dense step logits with graphs within 1e-5 of eager,
                paged == dense (margin rule); (b) decode and prefill tok/s,
                TTFT; (c) a profile of 8 graph decode ticks against the
                byte bound (every weight once: the capacity dispatch reads
                all 160 experts; the latent caches); (d) 2 SGD steps with
                the graph-mixed update on a 1-layer DeepSeek-V2 at full
                width, batch 2 x 256: finite loss and aux, aux > 0, the
                router, task.router_bias and w_uk moved; ms per step, peak
                memory. Logs one {"mla": ...} JSON line.
 14. xlstm    — run after phase 13: xLSTM-350M whole (24 layers = 3 x (7
                mLSTM + 1 sLSTM), d_model 1024, 4 heads, vocab 50304;
                519 M parameters, f32, nothing cut), the same 6 requests
                over 4 slots: (a) graphs and eager: no attention-kernel
                launch, graph tokens == eager tokens, step logits within
                1e-5, requests 4 and 5 (admitted into reused slots) ==
                each alone in a fresh batcher (margin rule); (b) a
                TaskAdapterStore of "out" pairs over band_graph(16, 2),
                rank 8, an update every 2 finishes: its graph-mix launches
                counted (2 + 2 per update), zero store == no store, the
                store's trees == a plain store's; (c) a profile of 8 graph
                decode ticks against the byte bound (the weights once, the
                4 x 21 mLSTM states read and written); (d) one SGD step at
                full width and depth, batch 2 x 128, remat on: finite
                loss, ms per step, peak memory; (e) one step of the same
                model, weights and batch with xlstm_parallel=True (the
                chunkwise-parallel mLSTM, chunk 64): its loss within 1e-4
                relative of (d)'s first step's, its ms logged beside (d)'s.
                Logs one {"xlstm": ...} JSON line.
 15. vlm      — run after phase 14: Pixtral-12B at full width and depth (40
                layers, d_model 5120, 32 heads of hd 160, 8 KV heads, d_ff
                14336, vocab 131072; 12.77 B params, ~51.1 GB of f32
                weights; the depth is cut, and the cut logged, only if the
                weights and caches would pass 75 GB), random weights from
                seed 0, max_seq 2048, prefill chunk 32, 4 slots: (a) phase
                12's 6 prompt lengths, each prompt with seeded vision
                embeddings over its first half, 16 new tokens, dense and
                paged, each with CUDA graphs and with cuda_graphs=False: 40
                attention launches at hd 160 per dispatch (and per
                warm-up), graph tokens == eager tokens, dense step logits
                with graphs within 1e-5 of eager, the plain path's tokens
                (dense) and paged == dense (margin rule), and request 0
                served text only changes some of its tokens; (b) decode and
                prefill tok/s, TTFT, peak memory; (c) a profile of 8 graph
                decode ticks against the byte bound; (d) 2 SGD steps with
                the graph-mixed update on a 2-layer Pixtral at full width,
                batch 2 x 256 with vision inputs over each row's first
                quarter: finite loss, wq, the embedding and
                task.head_bias moved; ms per step, peak memory. Logs one
                {"vlm": ...} JSON line.
 16. audio    — run after phase 15: MusicGen-large whole (48 layers, d_model
                2048, 32 heads of hd 64 (MHA), GELU, LayerNorm, 4 codebooks
                of 2048; 2.45 B params, ~9.8 GB f32, nothing cut): (a) the
                same 6 prompt lengths as (S0, 4) codebook rows, dense and
                paged, graphs and eager: 48 attention launches per
                dispatch, graph rows == eager rows, step logits within
                1e-5, the plain path's rows (dense) and paged == dense
                (margin rule, per step over every codebook); two prompts
                behind one 256-row codebook prefix through the prefix cache
                (one slot, paged): hit rows > 0, their no-cache tokens; (b)
                rates in frames (steps) per second, TTFT; (c) a profile of
                8 graph decode ticks against the byte bound; (d) 2 SGD
                steps at full depth, batch 2 x 256: finite loss, moved
                weights, ms per step, peak memory. Logs one {"audio": ...}
                JSON line.
 17. analysis — last, after the profiler breakdown: the port's own analysis
                (repro_torch.analysis) on the card: the lint (R001-R006)
                over src/repro_torch and the graph audit with the kernel
                backend (olmo_1b smoke dense and paged, at full width, and
                multitask_lm smoke and full width under an adapter store:
                A001 one capture per step kind, A002 as many aten ops and
                kernels at chunk 4 as at 8, A004 one cudaGraphLaunch and two
                cudaMemcpyAsync per replayed dispatch, A005 in place, A006
                the COW copy, A007 no host sync under
                set_sync_debug_mode("error"), one graph-mix launch per dtype
                group), the A003 ids probe in a child process. The lint and
                the audit run in a spawned process of their own: after the
                earlier phases' profiler sessions, torch.profiler in this
                process drops device records (A002's chunk saw 184-193 of
                its 231 kernels, a decode tick 164-170 of 211; a fresh
                process sees them all). Fails on any active finding, a
                probe process that did not exit 0, or a kernel of the five
                not launched inside the audited run. Logs the launches and
                one {"analysis": ...} JSON line.
 18. experiments — run right after phase 9, before any model of the
                serving phases is built and before any torch.profiler
                session: the paper's experiments and the five examples
                through their entry points (src/repro_torch/experiments,
                src/repro_torch/examples) on the card, each held to the
                JAX reference's numbers at the same workload (EXP_REF, from
                scripts/experiments_reference.py): (a) Figure 2 at m 100,
                d 100, n 500, 300 iterations, C = 10 (phase 9's data: f*
                must equal phase 9's): local, centralized, bsr, bol, admm
                with the reference's population risk (1e-3 relative), gap
                to f* (+ 3e-4) and rounds to 1e-3 (within 2); sdca's gap at
                most 1.5 times the reference's + 3e-4; Figure 3 at budget
                10000 over b in {40, 80, 100, 200, 500} (fresh samples from
                the card's generators: each excess risk over the noise
                variance at most 1.5 times the reference's + 3e-4); Table 1
                at 400 iterations (theory rows equal, measured rounds within
                2); the delay bench at its defaults (fixed delays: the
                reference's |W - W*| + 3e-4 and its empirical rate; Gamma =
                0, random delays in {0, 1} as in the reference: the slack
                rule); the orderings the reference shows (graph methods
                under Local, the ablation's variants); (b) the LM ablation
                at 200 steps and train_multitask_lm --full (~110 M
                parameters, 30 steps), both from the port's CPU init as
                the reference's runs (final losses within 1e-3 relative),
                quickstart, consensus_vs_multitask and learn_the_graph
                against the reference's numbers, serve_batched's six
                parity booleans, its counters equal to the reference's and
                its kernel cross-check (kernels 1-4 against the serving
                path's plain attention, atol 2e-5); (c) the runner's
                kernels entry: kernel 5 once against its plain version.
                Logs per-solver ms per iteration, the ablation's steps/s,
                the examples' tok/s and one {"experiments": ...} JSON
                line; the examples' own output goes to
                build/reports/phase18.log.
 19. distributed — run right after phase 18, on a card the parent has
                freed: W = torch.cuda.device_count() ranks spawned through
                torch.multiprocessing, one per card, over NCCL (a FileStore
                rendezvous), under a hard limit of DIST_TIMEOUT_S whose
                expiry fails the smoke, as does any rank that fails. Rank 0
                logs W, the backend and torch.cuda.nccl.version(). (a)
                mix_all_gather and mix_ring at m = W against mu^T theta
                (float64, on the host), bol_sharded (ring and all-gather)
                and bsr_sharded at m = W against the port's single-device
                bol / bsr on the card (DIST_TOL); at W = 1 these are
                one-task problems ("world 1: plumbing only"); (b) host
                syncs per bol_sharded / bsr_sharded call (torch sync debug
                mode), the same at 10 and 40 iterations; (c) the sharded
                train step (repro_torch.sharding: DTensor parameters, AdamW
                moments and batch in the rules' placements on a (W, 1)
                mesh, each weight gathered over fsdp only and the compute
                tensor-parallel) at multitask-LM full width (AdamW, the mix
                over band_graph(256, 1), 32 x 256), DIST_TRAIN["steps"] steps
                from the plain step's weights: losses and every parameter
                within DIST_TOL relative of the plain step on the card
                (over W > 1 ranks each parameter's norm: AdamW turns the
                data-parallel sum's rounding of near-zero gradients into
                steps of up to lr), the task leaves still DTensors in the
                rules' placements; ms a step and peak memory of both (the
                plain step's weights kept on the host); (d) the same on a
                (1, W) mesh with the residual stream and the logits
                constrained to DIST_TP_SPEC (tensor-parallel over the model
                axis; at W = 1 plumbing); (e) in a process of its own (a
                fake process group, never beside the NCCL ranks): the dry
                run (repro_torch.launch.dryrun) of DIST_DRYRUN on the 16 x
                16 mesh, each logged as a {"dryrun": ...} JSON line, and of
                (c)'s step on a (1, 1) fake mesh, whose argument_bytes +
                temp_bytes must lie within DIST_MEMORY_RTOL of (c)'s
                measured peak. Logs one {"distributed": ...} JSON line.

Output: the card's name and power limit first, per-phase lines, the
{"paper": ...}, {"experiments": ...}, {"distributed": ...}, {"serve_rates": ...},
{"train": ...}, {"moe": ...},
{"hybrid": ...}, {"mla": ...}, {"xlstm": ...}, {"vlm": ...},
{"audio": ...} and {"analysis": ...} JSON lines, then one
{"kernels": [...]} JSON line with the five kernels, and last
{"ok": true, "device": {...}}.
Exits non-zero without a result when there is no CUDA device or no
src/repro_torch beside this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32, dense bf16
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MIX_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}  # (atol, rtol)
MARGIN = 1e-3
GRAPH_TOL = 1e-5  # step logits, CUDA graphs against eager, f32
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


def kernel_ms(torch, fn, want=1, reps=4, tries=3):
    """Device ms per call of each CUDA kernel ``fn`` launches, by kernel
    name, from torch.profiler over ``reps`` eager calls after a warm-up, and
    whether the records were whole. A session whose records are not (fewer
    than ``want`` kernels, or a count that is no multiple of ``reps``: a
    trace can lose a kernel's records after earlier profiler sessions in
    the process) is made again, at most ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        whole = len(kern) >= want and all(e.count % reps == 0 for e in kern)
        if whole:
            break
    return {e.key: e.self_device_time_total / 1e3 / reps for e in kern}, whole


def short_name(key):
    """A kernel's name without its namespace, return type and arguments."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].split("::")[-1][:80]


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


def phase_kernels(torch, F, dec_ops, pre_ops, dec_ref, pre_ref, gather_pages, breakdown):
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

    def library(q, k, v, table, mask):  # GQA (Pixtral's G 4) through enable_gqa
        if table is not None:  # two calls: the gather, then SDPA
            k, v = gather_pages(k, table), gather_pages(v, table)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=q.shape[2] != k.shape[2],
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
        # multitask-LM: decode (G 4, hd 64), and prefill with 128 slab rows in
        # one block (8 m16 tiles)
        ("multitask_lm", 4, 1024, 4, 4, 64, 1, [63, 300, 700, 1023], None, None),
        ("multitask_lm", 4, 1024, 4, 4, 64, 32, [0, 200, 640, 992], None, None),
        # paged: 16-token pages, slot 0 maps only its first 512 rows
        ("olmo_1b", 4, 1024, 16, 1, 128, 1, [63, 300, 700, 1023], None, 16),
        ("olmo_1b", 4, 1024, 16, 1, 128, 32, [0, 200, 640, 992], None, 16),
        ("qwen2_5_14b_window256", 4, 1024, 8, 5, 128, 1, [0, 513, 64, 1000], 256, 16),
        ("qwen2_5_14b_window256", 4, 1024, 8, 5, 128, 32, [100, 992, 0, 431], 256, 16),
        ("hd64_stale_pos", 3, 96, 2, 4, 64, 1, [396, 40, 95], 16, 8),  # slot 0 sees no key
        ("hd32_block8", 2, 200, 4, 2, 32, 3, [5, 197], None, 8),
        # Mixtral-8x22B: G 6, the 4096-token window over 8192 rows, positions
        # past it; prefill C 32 (192 slab rows, several row tiles); dense and paged
        ("mixtral_8x22b", 4, 8192, 8, 6, 128, 1, [4500, 8191, 100, 4095], 4096, None),
        ("mixtral_8x22b", 4, 8192, 8, 6, 128, 32, [0, 4480, 8160, 4000], 4096, None),
        ("mixtral_8x22b", 4, 8192, 8, 6, 128, 1, [4500, 8191, 100, 4095], 4096, 16),
        ("mixtral_8x22b", 4, 8192, 8, 6, 128, 32, [0, 4480, 8160, 4000], 4096, 16),
        # Zamba2-7B's shared attention: MHA at hd 112 (no power of two), max_seq
        # 2048, dense and paged; timed in f32 against the bound
        ("zamba2_7b", 4, 2048, 32, 1, 112, 1, [63, 700, 1500, 2047], None, None),
        ("zamba2_7b", 4, 2048, 32, 1, 112, 32, [0, 700, 1500, 2016], None, None),
        ("zamba2_7b", 4, 2048, 32, 1, 112, 1, [63, 700, 1500, 2047], None, 16),
        ("zamba2_7b", 4, 2048, 32, 1, 112, 32, [0, 700, 1500, 2016], None, 16),
        # Pixtral-12B: GQA (KVH 8, G 4) at hd 160 (padded to 256 in the decode
        # block), max_seq 2048; prefill C 32: 128 slab rows (four row tiles in
        # f32, two in bf16); dense and paged; timed in f32 against the bound
        ("pixtral_12b", 4, 2048, 8, 4, 160, 1, [63, 700, 1500, 2047], None, None),
        ("pixtral_12b", 4, 2048, 8, 4, 160, 32, [0, 700, 1500, 2016], None, None),
        ("pixtral_12b", 4, 2048, 8, 4, 160, 1, [63, 700, 1500, 2047], None, 16),
        ("pixtral_12b", 4, 2048, 8, 4, 160, 32, [0, 700, 1500, 2016], None, 16),
    ]
    entries = {}
    timed = {"zamba2_7b": ("zamba2_hd112", {}), "pixtral_12b": ("pixtral_hd160", {})}
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
            if name in timed and dname == "float32":
                # the kernel at hd 112 / 160 against its bound and plain version, 4 input sets
                sets = inputs(b, s, kvh, g, hd, c, dtype, block, sets=4)
                kv_pos = torch.arange(s, device=dev)
                q_pos = pos_t[:, None] + torch.arange(c, device=dev)
                mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]  # (B,1,C,S)
                ms = graph_ms(torch, [lambda t=t: call(op, *t, pos_t) for t in sets])
                plain_ms = graph_ms(torch, [lambda t=t: plain(*t, pos_t, None) for t in sets])
                lib_ms = graph_ms(torch, [lambda t=t: library(*t, mask) for t in sets])
                bound_ms, bound_by = bound(b, s, kvh, g, hd, c, pos, window, dname, block)
                nsplit = (pre_ops.num_splits(q, kvh, s) if c > 1
                          else dec_ops.num_splits(q, kvh, s, paged=block is not None))
                log(f"time {kname} {name} hd {hd} f32: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}): {bound_ms / ms:.1%} of the bound; nsplit {nsplit}")
                timed[name][1][kname] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                         "library_ms": lib_ms, "bound_ms": bound_ms,
                                         "bound_by": bound_by, "nsplit": nsplit}
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
            extra = {"nsplit": pre_ops.num_splits(q, kvh, s) if c > 1
                     else dec_ops.num_splits(q, kvh, s, paged=block is not None)}
            log(f"time {kname} {name} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library ({lib_name}) {lib_ms:.4f} ms (err vs plain {lib_err:.2e}), "
                f"bound {bound_ms:.4f} ms ({bound_by}); wrapper's nsplit {extra['nsplit']}")
            entries[kname] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": lib_ms, "library": lib_name, **extra}
            # the kernels one call launches, and what the library runs: read
            # with torch.profiler after the last serve phase (phase_breakdown),
            # since a profiler session slows the launches of the runs after it
            breakdown.append((kname, entries[kname],
                              lambda q=q, k=k, v=v, table=table, op=op, pos_t=pos_t:
                              call(op, q, k, v, table, pos_t),
                              lambda q=q, k=k, v=v, table=table, mask=mask:
                              library(q, k, v, table, mask)))
    for key, rows in timed.values():  # each kernel's row carries its hd-112 / 160 timing
        for kname, entry in rows.items():
            entries[kname][key] = entry
    return entries


def phase_breakdown(torch, breakdown):
    """Device ms per call of each CUDA kernel a timed kernel call launches
    (partial + combine) and of the kernels its library call runs, from
    torch.profiler; added to the kernel's entry. Measurement only: records
    still incomplete after the retries are logged as such."""
    for kname, entry, kernel_call, library_call in breakdown:
        launched, whole = kernel_ms(torch, kernel_call, want=2)
        library_kernels, lib_whole = kernel_ms(torch, library_call)
        entry["launched"] = {short_name(k): t for k, t in launched.items()}
        entry["library_kernels"] = {short_name(k): t for k, t in library_kernels.items()}
        log(f"breakdown {kname} olmo_1b f32: eager device ms per call: "
            + ", ".join(f"{k} {t:.4f}" for k, t in entry["launched"].items())
            + "; library runs "
            + ", ".join(f"{k} {t:.4f}" for k, t in entry["library_kernels"].items())
            + ("" if whole and lib_whole else "; profiler records incomplete"))


def adapter_width(cfg) -> int:
    """Per-task floats of the adapter store: four (d, r) / (r, d) factors
    per layer (attention and MLP branches), the head bias and the final
    gain — the d of its one f32 graph-mix block."""
    return 4 * cfg.num_layers * cfg.d_model * cfg.adapter_rank + cfg.vocab_size + cfg.d_model


def phase_graph_mix(torch, mix_ops, mix_ref, band_graph, cfg):
    """The graph-mix kernel against its plain version on the card; times it
    at the adapter store's full width (cfg: multitask_lm) in f32."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    m, d_full = cfg.num_tasks, adapter_width(cfg)
    g = band_graph(m, 2)
    families = {"bsr": g.bsr_mixing(1.0, 1.0, 1.0), "bol": g.bol_mixing(1.0, 1.0, 0.1),
                "consensus": g.consensus_mixing()}

    def rand_mu(k):
        return torch.rand((k, k), generator=gen, device=dev) / k

    cases = [("full_width", rand_mu(m), m, d_full)]
    cases += [("ragged", rand_mu(k), k, d) for k in (1, 12, 100) for d in (1000, 4099)]
    cases += [(f"band256_{name}", torch.as_tensor(mu, dtype=torch.float32, device=dev), m, d)
              for name, mu in families.items() for d in (4096, 4099)]
    entry = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        atol, rtol = MIX_TOL[dname]
        for name, mu, k, d in cases:
            theta = torch.randn((k, d), generator=gen, device=dev).to(dtype)
            got = mix_ops.graph_mix(mu, theta)
            torch.cuda.synchronize()
            want = mix_ref.graph_mix_reference(mu, theta)  # f32 sum, rounded to dtype
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ok = torch.isfinite(got.float()).all().item() and bool(
                (diff <= atol + rtol * want.float().abs()).all())
            log(f"kernel graph_mix {name} m={k} d={d} {dname}: max_abs_err={err:.3e} "
                f"(atol {atol}, rtol {rtol})")
            if not ok:
                raise AssertionError(f"graph_mix {name} m={k} d={d} {dname}: max_abs_err {err}")
            if name != "full_width" or dname != "float32":
                continue
            # one input set is 436 MB of theta (and as much out): far above the L2
            ms = graph_ms(torch, [lambda: mix_ops.graph_mix(mu, theta)])
            plain_ms = graph_ms(torch, [lambda: mix_ref.graph_mix_reference(mu, theta)])
            lib = torch.matmul(mu.t(), theta)
            lib_err = (lib - want).abs().max().item()
            lib_ms = graph_ms(torch, [lambda: torch.matmul(mu.t(), theta)])
            nbytes = 4 * (k * k + 2 * k * d)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = 2 * k * k * d / PEAK_FLOPS["float32"]
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            log(f"time graph_mix full_width m={k} d={d} f32: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library (torch.matmul(mu.t(), theta)) {lib_ms:.4f} ms "
                f"(err vs plain {lib_err:.2e}), bound {bound_ms:.4f} ms ({bound_by}; "
                f"{nbytes / 1e6:.1f} MB, {2 * k * k * d / 1e9:.2f} GFLOP)")
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms,
                     "library": "torch.matmul(mu.t(), theta)"}
    return entry


# ------------------------------------------------------- phase 9: the paper
# The paper's own workload (Appendix I; src/repro_torch/configs/multitask_linreg.py):
# m = 100 tasks, d = 100, n = 500 samples per task, the 10-NN graph of 10 clusters.
PAPER_SEED = 0
PAPER_BATCH = 50  # minibatch per task of the sampled solvers
PAPER_DELAY = 3  # Gamma of delayed BOL
# iterations (rounds for sdca and graph learning) of each run
PAPER_ITERS = {
    "bsr": 300, "bol": 40, "bol_inexact": 20, "gd": 500, "admm": 300, "consensus_sgd": 300,
    "bol_delayed_fixed": 100, "bol_delayed_random": 100, "ssr": 300, "sol": 100,
    "minibatch_prox": 30, "ssr_generator": 300, "sol_generator": 100,
    "minibatch_prox_generator": 30, "sdca": 5, "bsr_logistic": 200, "bol_logistic": 20,
    "graph_learning": 3,
}
# seeds of the numpy-drawn minibatch indices the replayed solvers consume
PAPER_REPLAY_SEED = {"ssr": 1, "sol": 2, "minibatch_prox": 3}
PAPER_SOLVER_ITERS = 40  # bol iterations per graph-learning round
PAPER_TRACE_RTOL = 1e-4  # card against the machine's CPU: objective traces
PAPER_W_ATOL = 1e-4  # and final iterates
PAPER_GAP_TOL = 3e-4  # 1e-4 of f* (3.23): a gap may exceed the reference's by this
# runs whose draws the reference cannot replay (its permutations, delays and
# keys are JAX's): gap <= PAPER_RANDOM_SLACK * the reference's gap + PAPER_GAP_TOL
PAPER_RANDOM_SLACK = 1.5
PAPER_REPLAYED = ("ssr", "sol", "minibatch_prox")
PAPER_UNREPLAYABLE = ("bol_delayed_random", "sdca", "ssr_generator", "sol_generator",
                      "minibatch_prox_generator")
# what the JAX reference reaches on this workload (scripts/paper_reference.py):
# the gap to f* of each run, and the learned graph's cluster contrast
# (JAX 0.9.0, CPU, float32, f* 3.2288806438446045)
PAPER_REF = {
    "bsr": 2.384185791015625e-07, "bol": 0.0, "bol_inexact": 0.00026988983154296875,
    "gd": 4.76837158203125e-07, "admm": 0.006670713424682617,
    "consensus_sgd": 6.681599855422974, "bol_delayed_fixed": 2.384185791015625e-07,
    "bol_delayed_random": 2.384185791015625e-07, "ssr": 0.874521017074585,
    "sol": 1.6410658359527588, "minibatch_prox": 0.5761933326721191,
    "ssr_generator": 0.875478982925415, "sol_generator": 1.5777428150177002,
    "minibatch_prox_generator": 0.5497541427612305, "sdca": 5.185518503189087,
    "bsr_logistic": -2.9802322387695312e-08, "bol_logistic": 0.0,
    "graph_learning": 14.366122224252907,
}
# f* of the logistic problem: the reference's bsr after 3000 iterations
PAPER_F_LOGISTIC = 0.48871082067489624


def paper_data(np, core, data, device):
    """The paper's workload on ``device``: data, the three problems and f*."""
    rng = np.random.default_rng(PAPER_SEED)
    tasks = data.generate_clustered_tasks(rng, m=100, d=100, num_clusters=10, knn=10)
    x, y = tasks.sample(rng, 500, device=device)
    b, s = tasks.bs_constants()
    eta, tau = core.theory.corollary2_parameters(tasks.graph, b, max(s, 1e-2), 8.0, 500)
    problem = core.MultiTaskProblem(tasks.graph, core.SQUARED, eta, tau)
    # Theorem 7 asks rows of A to sum to at most 1: the graph over its largest
    # degree with tau times that degree is the same objective, so the same f*
    deg = float(tasks.graph.adjacency.sum(axis=1).max())
    delayed = core.MultiTaskProblem(core.TaskGraph(tasks.graph.adjacency / deg), core.SQUARED,
                                    eta, tau * deg)
    logistic = core.MultiTaskProblem(tasks.graph, core.LOGISTIC, eta, tau)
    return {"tasks": tasks, "x": x, "y": y, "y_cls": (y > 0).float() * 2 - 1, "B": b, "S": s,
            "problem": problem, "delayed": delayed, "logistic": logistic}


def paper_replay(torch, np, x, y, name, iters):
    """A sampler that ignores its generator and hands out, in turn, the
    minibatches of indices drawn with numpy from PAPER_REPLAY_SEED[name]."""
    m, n, d = x.shape
    idx = torch.as_tensor(np.random.default_rng(PAPER_REPLAY_SEED[name]).integers(
        0, n, (iters, m, PAPER_BATCH)), device=x.device)
    step = iter(range(iters))

    def sample(generator, b):
        i = idx[next(step)]
        return torch.gather(x, 1, i[:, :, None].expand(m, b, d)), torch.gather(y, 1, i)

    return sample


def paper_call(torch, np, core, s, name, iters):
    """Run ``name`` for ``iters`` on the device of s's tensors; (w, trace)."""
    p, x, y = s["problem"], s["x"], s["y"]
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(0)
    ev = lambda w: p.erm_objective(w, x, y)  # noqa: E731
    base = name.removesuffix("_generator")
    if base in PAPER_REPLAYED:
        sampler = (core.minibatch_sampler(x, y) if name.endswith("_generator")
                   else paper_replay(torch, np, x, y, base, iters))
        if base == "ssr":
            r = core.ssr(p, sampler, PAPER_BATCH, iters, gen, ev, p.smoothness_loss(x), s["B"],
                         d=x.shape[-1])
        elif base == "sol":
            r = core.sol(p, sampler, PAPER_BATCH, iters, gen, ev, d=x.shape[-1])
        else:
            r = core.minibatch_prox(p, sampler, PAPER_BATCH, iters, gen, ev, s["B"],
                                    max(s["S"], 1e-2), 8.0, inner_iters=15, d=x.shape[-1])
    elif name == "bsr":
        r = core.bsr(p, x, y, iters)
    elif name == "bol":
        r = core.bol(p, x, y, iters)
    elif name == "bol_inexact":
        r = core.bol(p, x, y, iters, exact_prox=False, inner_steps=40)
    elif name == "gd":
        r = core.gd(p, x, y, iters)
    elif name == "admm":
        r = core.admm(p, x, y, iters, rho=0.05)
    elif name == "consensus_sgd":
        r = core.consensus_sgd(p, x, y, iters)
    elif name.startswith("bol_delayed"):
        r = core.bol_delayed(s["delayed"], x, y, iters, PAPER_DELAY, generator=gen,
                             fixed_delay=name.endswith("fixed"))
    elif name == "sdca":
        r = core.sdca(p, x, y, iters, generator=gen)
    elif name == "bsr_logistic":
        r = core.bsr(s["logistic"], x, s["y_cls"], iters)
    elif name == "bol_logistic":
        r = core.bol(s["logistic"], x, s["y_cls"], iters, exact_prox=False, inner_steps=30)
    elif name == "graph_learning":
        w, graph, hist = core.alternating_graph_learning(
            x, y, p.eta, p.tau, num_rounds=iters, solver_iters=PAPER_SOLVER_ITERS)
        return w, torch.tensor([h["objective"] for h in hist]), graph
    else:
        raise ValueError(name)
    return r.w, r.objective_trace, None


def cluster_contrast(np, tasks, graph):
    """Mean learned affinity within the true clusters over that across them."""
    same = tasks.cluster_of[:, None] == tasks.cluster_of[None, :]
    np.fill_diagonal(same, False)
    across = ~same & ~np.eye(tasks.m, dtype=bool)
    return float(graph.adjacency[same].mean() / graph.adjacency[across].mean())


def sync_sites(torch, fn):
    """Where fn's host syncs happen: the Python file:line of each one torch
    reports in its sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def paper_gap_ok(name, gap, ref):
    """The gap to f* against the reference's on the same workload (see PAPER_REF)."""
    slack = PAPER_RANDOM_SLACK if name in PAPER_UNREPLAYABLE else 1.0
    return -PAPER_GAP_TOL <= gap <= slack * max(ref, 0.0) + PAPER_GAP_TOL


def phase_paper(torch, np, core, data, device="cuda"):
    """Phase 9: every solver of the paper on the card, held to the same call
    on the machine's CPU, to f*, and to the gaps the reference reaches."""
    t_phase = time.perf_counter()
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    card, host = paper_data(np, core, data, dev), paper_data(np, core, data, "cpu")
    t0 = time.perf_counter()
    w_star = core.centralized_solution(host["problem"], host["x"], host["y"])  # float64 solve
    closed_s = time.perf_counter() - t0
    f_star = {side: s["problem"].erm_objective(w_star.to(s["x"].device), s["x"], s["y"]).item()
              for side, s in (("card", card), ("cpu", host))}
    log(f"paper: m=100 d=100 n=500, 10-NN graph ({card['problem'].graph.num_edges} edges), "
        f"eta {card['problem'].eta:.6f} tau {card['problem'].tau:.6f}; f* {f_star['card']:.7f} "
        f"on the card, {f_star['cpu']:.7f} on the CPU (closed form, float64, {closed_s:.2f} s)")
    for name in PAPER_ITERS:  # warm-up: library handles, allocator, first launches
        paper_call(torch, np, core, card, name, 2)
    sync()
    solvers = {}
    for name, iters in PAPER_ITERS.items():
        runs, rec = {}, {"iters": iters}
        for side, s in (("card", card), ("cpu", host)):
            secs = []
            # the 2-iteration calls (the fastest of three: the host's share
            # varies) give the set-up of a call apart from its iterations
            for n in (iters, 2, 2, 2):
                sync()
                t0 = time.perf_counter()
                w, trace, graph = paper_call(torch, np, core, s, name, n)
                sync()
                secs.append(time.perf_counter() - t0)
                if n == iters:
                    runs[side] = (w.cpu(), trace.cpu().double().numpy(), graph)
            short = min(secs[1:])
            per_iter = (secs[0] - short) / (iters - 2)
            rec[f"{side}_ms_per_iter"] = per_iter * 1e3
            rec[f"{side}_setup_ms"] = (short - 2 * per_iter) * 1e3
        (w_c, tr_c, g_c), (w_h, tr_h, g_h) = runs["card"], runs["cpu"]
        if not (np.isfinite(tr_c).all() and torch.isfinite(w_c).all()):
            raise AssertionError(f"paper {name}: non-finite result on the card")
        ref = rec["reference"] = PAPER_REF[name]
        if name == "graph_learning":
            rec["contrast"] = cluster_contrast(np, card["tasks"], g_c)
            rec["objective"] = float(tr_c[-1])
            ok = abs(rec["contrast"] - ref) <= 1e-3 * ref
        else:
            f0 = PAPER_F_LOGISTIC if name.endswith("logistic") else None
            rec["gap"] = float(tr_c[-1]) - (f0 if f0 is not None else f_star["card"])
            rec["gap_cpu"] = float(tr_h[-1]) - (f0 if f0 is not None else f_star["cpu"])
            ok = paper_gap_ok(name, rec["gap"], ref) and paper_gap_ok(name, rec["gap_cpu"], ref)
        if name not in PAPER_UNREPLAYABLE:  # the same arithmetic on both sides
            rec["trace_rel_err"] = float(np.max(np.abs(tr_c - tr_h) / np.abs(tr_h)))
            rec["w_err"] = (w_c - w_h).abs().max().item()
            ok = ok and rec["trace_rel_err"] <= PAPER_TRACE_RTOL and rec["w_err"] <= PAPER_W_ATOL
        log(f"paper {name}: {iters} iterations, card {rec['card_ms_per_iter']:.3f} ms/iter "
            f"+ {rec['card_setup_ms']:.1f} ms set-up, CPU {rec['cpu_ms_per_iter']:.3f} ms/iter "
            f"+ {rec['cpu_setup_ms']:.1f} ms; "
            + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()
                        if k in ("gap", "gap_cpu", "reference", "contrast", "objective",
                                 "trace_rel_err", "w_err")))
        if not ok:
            raise AssertionError(f"paper {name}: {rec}")
        solvers[name] = rec
    syncs = {}
    if dev.type == "cuda":
        p, x, y = card["problem"], card["x"], card["y"]
        # the first call under the debug mode also reports one-time syncs
        sites = {t: sync_sites(torch, lambda t=t: core.bol(p, x, y, t)) for t in (1, 10, 40)}
        syncs = {str(t): len(v) for t, v in sites.items()}
        log(f"paper: host syncs per bol call by iterations (torch sync debug mode): {syncs}; "
            f"sites {sites}")
        if len(sites[10]) != len(sites[40]):
            raise AssertionError(f"paper: host syncs grow with the iterations: {sites}")
    secs = time.perf_counter() - t_phase
    log(f"paper: phase passed in {secs:.1f} s")
    return {"f_star": f_star, "closed_form_s": closed_s, "syncs_per_bol_call": syncs,
            "solvers": solvers, "seconds": secs}


# ------------------------------------------------- phase 18: the experiments
# The paper's experiments and the five examples through their entry points
# (src/repro_torch/experiments, src/repro_torch/examples) at Appendix I's
# size; Figure 2 at C = 10 only (phase 9's data and seed).
EXP_SIZE = ["--m", "100", "--d", "100", "--n", "500"]
EXP_ARGS = {
    "fig2_erm": EXP_SIZE + ["--iters", "300", "--clusters", "10"],
    "fig3_stochastic": EXP_SIZE + ["--budget", "10000"],
    "table1_complexity": EXP_SIZE + ["--iters", "400"],
    "delay_bench": [],
    "ablation_mtl_lm": ["--steps", "200"],
}
EXP_TRAIN_ARGS = ["--full"]  # examples/train_multitask_lm: 162.7 M parameters, 30 steps
EXP_FULL_CLUSTERS = [1, 5, 10, 50]  # `python -m repro_torch.experiments --full`
# what the JAX reference gives at these workloads (scripts/experiments_reference.py;
# JAX 0.9.0, CPU, float32, 2026-10-18): per experiment its rows' numbers, per example
# the numbers it prints; the LM runs from exp_init_tree's weights
EXP_REF = {'fig2_erm': {'f_star': 3.2288806438446045,
              'rows': {'local/10': [3.5511615398124725, None, 0],
                       'centralized/10': [3.372683556892301, 3.2288806438446045, 1],
                       'bsr/10': [3.3726838104799413, 3.2288808822631836, 46],
                       'bol/10': [3.3726835757762035, 3.2288806438446045, 8],
                       'admm/10': [3.409067942459428, 3.235551357269287, -1],
                       'sdca/10': [3.3641148776709735, 3.2333498001098633, -1]}},
 'fig3_stochastic': {'rows': {'ssr/40': 3.2306932716229504,
                              'sol/40': 4.883170003128488,
                              'ssr/80': 3.3179973248906673,
                              'sol/80': 4.069411828829177,
                              'ssr/100': 3.3560277578064226,
                              'sol/100': 3.882998312925709,
                              'ssr/200': 3.487054481173413,
                              'sol/200': 3.53425382266924,
                              'ssr/500': 3.72137176751686,
                              'sol/500': 3.3060121899880732,
                              'local_ref/500': 3.5511615398124725,
                              'centralized_ref/500': 3.372683556892301},
                     'sigma_scale': {'40': 0.01,
                                     '80': 0.01,
                                     '100': 0.01,
                                     '200': 0.01,
                                     '500': 0.01}},
 'table1_complexity': {'rows': {'local': [0, '', 0.0],
                                'centralized': [1, '', 47578.680535343476],
                                'erm_bsr': [14.026288374413255, 46, 100.0],
                                'erm_bol': [3.7027150927586034, 8, 5.830000000000001],
                                'stoch_ssr': [14.026288374413255, '', 100.0],
                                'stoch_sol': [3.7027150927586034, '', 5.830000000000001]}},
 'delay_bench': {'rows': {'0': [2.44608054345008e-06, None, 0.6666666666666667],
                          '2': [2.4439186745439656e-06, None, 0.8735804647362989],
                          '5': [2.440934395053773e-06, 0.8835408091545105, 0.9346552651840672],
                          '10': [2.436793920423952e-06, 0.9822419881820679,
                                 0.9638106118842875]}},
 'ablation_mtl_lm': {'rows': {'local': [3.2575364112854004, 0.1128258928656578],
                              'graph': [3.269531726837158, 0.03278183192014694],
                              'consensus': [3.276426315307617, 0.0009518439183011651]}},
 'quickstart': {'rho': 0.08031732486267688,
                'eta': 0.27493775059503717,
                'tau': 1.0343693424736682,
                'f_star': 3.177704334259033,
                'methods': {'local': [3.624780793270209, 9.704024314880371],
                            'centralized': [3.209349576291209, 3.177704334259033],
                            'BSR (batch, solve regularizer)': [3.2093496374855803,
                                                               3.1777048110961914],
                            'BOL (batch, optimize loss)': [3.209349545082195,
                                                           3.1777045726776123]}},
 'consensus_vs_multitask': {'consensus_spread': 4.9e-08,
                            'spreads': [[0.1, 0.9222, 0.9222], [1.0, 0.5636, 0.5636],
                                        [10.0, 0.2701, 0.2701], [1000.0, 0.0089, 0.0089]],
                            'limit': [[1, 1.81474], [100, 0.09167], [10000, 0.00097]]},
 'learn_the_graph': {'risks': {'oracle graph': 3.240180467187298,
                               'no coupling': 3.5805169795497105,
                               'learned graph': 3.4450670350687043},
                     'within': 0.6602043840068356,
                     'across': 0.42239439723308475,
                     'history': [{'round': 0, 'objective': 3.38547682762146, 'edges': 190},
                                 {'round': 1, 'objective': 3.3160791397094727, 'edges': 190},
                                 {'round': 2, 'objective': 3.2759671211242676, 'edges': 190},
                                 {'round': 3, 'objective': 3.250070095062256, 'edges': 189}]},
 'train_multitask_lm': {'params': 162679552,
                        'history': [{'step': 0, 'loss': 10.873015403747559},
                                    {'step': 3, 'loss': 10.847860336303711},
                                    {'step': 6, 'loss': 10.91865348815918},
                                    {'step': 9, 'loss': 10.8557710647583},
                                    {'step': 12, 'loss': 10.89168930053711},
                                    {'step': 15, 'loss': 10.843873977661133},
                                    {'step': 18, 'loss': 10.839582443237305},
                                    {'step': 21, 'loss': 10.764557838439941},
                                    {'step': 24, 'loss': 10.692988395690918},
                                    {'step': 27, 'loss': 10.626649856567383},
                                    {'step': 29, 'loss': 10.596442222595215}],
                        'spread': 9.185850649373606e-05,
                        'neighbor': 6.41356673440896e-05},
 'serve_batched': {'first_continuation': [257, 89, 257, 35, 495, 24, 113, 64, 61, 198, 472,
                                          393, 100, 371, 425, 257],
                   'ticks': 62,
                   'decode_dispatches': 62,
                   'prefill_dispatches': 4,
                   'free_blocks': 48,
                   'mixed_dispatches': 70,
                   'streamed': 96,
                   'cancelled_emitted': 0,
                   'hit_ratio': 0.4375,
                   'hit_tokens': 56,
                   'lookup_tokens': 128,
                   'cow_copies': 2,
                   'prefill_tokens': 72,
                   'batcher_match': True,
                   'paged_match': True,
                   'scan_match': True,
                   'kernel_match': True,
                   'sla_match': True,
                   'prefix_match': True,
                   'decode_err': 2.086162567138672e-07}}
EXP_MIN_REL = 1e-3  # repeatable population risks and objectives against EXP_REF
EXP_LOSS_RTOL = 1e-4  # the LM runs' losses against EXP_REF, the same initial weights
EXP_DRAWN_ORDER = 0.05  # an ordering of runs with the card's own draws needs this margin
EXP_ROUNDS = 2  # measured rounds to 1e-3 may differ from the reference's by this


def exp_init_tree(convert, TransformerLM, cfg):
    """The initial weights of an LM experiment or example on both sides: the
    port's seeded init (seed 0) on the host CPU, as the JAX params tree with
    numpy leaves. A CUDA generator draws another stream than the CPU's, so
    the card's runs load these instead of seeding on the card, and
    scripts/experiments_reference.py starts the reference's runs from them."""
    return convert.params_to_numpy(TransformerLM(cfg, device="cpu", seed=0))


def exp_close(x, ref, rel=EXP_MIN_REL, atol=0.0):
    return abs(x - ref) <= rel * abs(ref) + atol


def exp_gap_ok(gap, ref, slack=1.0):
    """PAPER_GAP_TOL and PAPER_RANDOM_SLACK's rule for a gap to f*."""
    return -PAPER_GAP_TOL <= gap <= slack * max(ref, 0.0) + PAPER_GAP_TOL


def exp_rounds_ok(got, ref):
    """Rounds to 1e-3 within EXP_ROUNDS of the reference's; -1 (never) only
    where the reference has -1 too."""
    return got == ref if -1 in (got, ref) else abs(got - ref) <= EXP_ROUNDS


def exp_orderings(got, ref, pairs, margin=EXP_MIN_REL):
    """The pairs (a, b) with ref[a] < ref[b] by more than ``margin`` of
    ref[b], and whether got keeps each: the orderings the reference shows."""
    return {f"{a} < {b}": got[a] < got[b] for a, b in pairs
            if ref[a] < ref[b] * (1.0 - margin)}


def exp_quiet(fn, *a, **kw):
    """fn's result; what it printed goes to build/reports/phase18.log."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **kw)
    log_path = ROOT / "build" / "reports" / "phase18.log"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "a") as f:
        f.write(buf.getvalue())
    return res


def phase_exp_figures(experiments, f_star, dev, check):
    """18(a): Figures 2 and 3, Table 1 and the delay bench on the card."""
    ref, dev_arg, out = EXP_REF, ["--device", dev], {}
    t0 = time.perf_counter()
    secs = {}
    rows = exp_quiet(experiments.fig2_erm.main, EXP_ARGS["fig2_erm"] + dev_arg, timings=secs)
    secs, iters = secs[10], int(EXP_ARGS["fig2_erm"][EXP_ARGS["fig2_erm"].index("--iters") + 1])
    by = {r[0]: r for r in rows}
    fs, f2 = by["centralized"][4], ref["fig2_erm"]
    check(abs(fs - f_star) <= 1e-6 * abs(f_star), f"fig2 f* {fs!r} != phase 9's {f_star!r}")
    fig2 = {}
    for name, r in by.items():
        want = f2["rows"][f"{name}/10"]  # population risk, final objective, rounds to 1e-3
        rec = fig2[name] = {"pop_risk": r[3], "iters_to_tol": r[5], "reference": want}
        unrepeatable = name == "sdca"  # its permutations are JAX's in the reference
        if not unrepeatable:
            check(exp_close(r[3], want[0]), f"fig2 {name}: population risk {r[3]} vs {want[0]}")
            check(exp_rounds_ok(r[5], want[2]), f"fig2 {name}: rounds {r[5]} vs {want[2]}")
        if name != "local":
            rec["gap"] = r[4] - fs
            check(exp_gap_ok(rec["gap"], want[1] - f2["f_star"],
                             PAPER_RANDOM_SLACK if unrepeatable else 1.0),
                  f"fig2 {name}: gap {rec['gap']} vs {want[1] - f2['f_star']}")
        if name in secs:
            rec["ms_per_iter"] = secs[name] / iters * 1e3
        log(f"experiments fig2 C=10 {name}: pop_risk {r[3]:.6f} (reference {want[0]:.6f}), "
            + (f"gap {rec['gap']:.3e} (reference {want[1] - f2['f_star']:.3e}), "
               if "gap" in rec else "")
            + f"rounds to 1e-3 {r[5]} ({want[2]})"
            + (f", {rec['ms_per_iter']:.3f} ms/iter" if "ms_per_iter" in rec else ""))
    risks = {k: v["pop_risk"] for k, v in fig2.items()}
    want = {n.split("/")[0]: v[0] for n, v in f2["rows"].items()}
    order = exp_orderings(risks, want, [(m, "local") for m in ("centralized", "bsr", "bol",
                                                                 "admm")])
    order |= exp_orderings(risks, want, [("sdca", "local")], EXP_DRAWN_ORDER)
    check(all(order.values()), f"fig2 orderings {order}")
    out["fig2_erm"] = {"f_star": fs, "rows": fig2, "orderings": order,
                       "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    secs = {}
    rows = exp_quiet(experiments.fig3_stochastic.main, EXP_ARGS["fig3_stochastic"] + dev_arg,
                     timings=secs)
    f3, noise_var = ref["fig3_stochastic"]["rows"], 3.0
    fig3 = {}
    for method, b, rounds, risk in rows:
        key, want = f"{method}/{b}", f3[f"{method}/{b}"]
        rec = fig3[key] = {"rounds": rounds, "pop_risk": risk, "reference": want}
        if method.endswith("_ref"):  # the n=500 references: the same arithmetic
            check(exp_close(risk, want), f"fig3 {key}: {risk} vs {want}")
        else:  # fresh samples from the card's generators: the slack rule on the excess
            check(exp_gap_ok(risk - noise_var, want - noise_var, PAPER_RANDOM_SLACK),
                  f"fig3 {key}: excess risk {risk - noise_var} vs {want - noise_var}")
            rec["ms_per_iter"] = secs[(method, b)] / rounds * 1e3
        log(f"experiments fig3 {key}: {rounds} rounds, pop_risk {risk:.6f} (reference "
            f"{want:.6f})" + (f", {rec['ms_per_iter']:.3f} ms/iter" if "ms_per_iter" in rec
                              else ""))
    risks = {k: v["pop_risk"] for k, v in fig3.items()}
    order = exp_orderings(risks, f3, [(k, "local_ref/500") for k in fig3
                                      if not k.endswith("_ref/500")], EXP_DRAWN_ORDER)
    check(all(order.values()), f"fig3 orderings {order}")
    out["fig3_stochastic"] = {"rows": fig3, "orderings": order,
                              "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    rows = exp_quiet(experiments.table1_complexity.main,
                     EXP_ARGS["table1_complexity"] + dev_arg)
    t1 = {}
    for r in rows:
        want = ref["table1_complexity"]["rows"][r[0]]  # theory rounds, measured, vectors
        t1[r[0]] = {"theory_rounds": r[1], "measured": r[2], "reference": want}
        check(exp_close(r[1], want[0], 1e-9) and exp_close(r[3], want[2], 1e-9),
              f"table1 {r[0]}: theory {r[1]}, {r[3]} vs {want}")
        check(r[2] == want[1] if "" in (r[2], want[1]) else exp_rounds_ok(r[2], want[1]),
              f"table1 {r[0]}: measured rounds {r[2]} vs {want[1]}")
    log("experiments table1: measured rounds to 1e-3 "
        + ", ".join(f"{k} {v['measured']} ({v['reference'][1]})" for k, v in t1.items()
                    if v["measured"] != ""))
    out["table1_complexity"] = {"rows": t1, "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    rows = exp_quiet(experiments.delay_bench.main, EXP_ARGS["delay_bench"] + dev_arg)
    delay = {}
    for g, err, rate, theo in rows:
        want = ref["delay_bench"]["rows"][str(g)]  # |W - W*|, empirical rate, Theorem 7's
        delay[g] = {"err": err, "empirical_rate": rate, "theorem7_rate": theo,
                    "reference": want}
        # Gamma = 0 draws random delays in {0, 1} (the reference's quirk): the
        # slack rule. The empirical rate is not compared: at these defaults the
        # gap reaches float32 rounding before iteration 100, so it is a ratio of
        # rounding noise on both sides (ROADMAP §3)
        check(theo == want[2] and exp_gap_ok(err, want[0], PAPER_RANDOM_SLACK if g == 0 else 1.0),
              f"delay Gamma={g}: |W - W*| {err}, theorem 7 {theo} vs {want}")
        log(f"experiments delay Gamma={g}: |W-W*| {err:.3e} ({want[0]:.3e}), empirical rate "
            f"{rate:.4f} ({want[1]}), theorem 7 {theo:.4f}")
    out["delay_bench"] = {"rows": delay, "seconds": time.perf_counter() - t0}
    return out


def phase_exp_models(experiments, examples, convert, TransformerLM, get, ops, dev, check):
    """18(b): the LM ablation and the five examples on the card."""
    ref, dev_arg, out = EXP_REF, ["--device", dev], {}
    t0 = time.perf_counter()
    abl = experiments.ablation_mtl_lm
    tree = exp_init_tree(convert, TransformerLM, abl.ablation_config(8))
    secs = {}
    rows = exp_quiet(abl.main, EXP_ARGS["ablation_mtl_lm"] + dev_arg, params=tree, timings=secs)
    steps = int(EXP_ARGS["ablation_mtl_lm"][1])
    ablation = {}
    for name, loss, spread in rows:
        want = ref["ablation_mtl_lm"]["rows"][name]  # final loss, adapter spread
        ablation[name] = {"final_loss": loss, "spread": spread, "reference": want,
                          "steps_per_s": steps / secs[name]}
        check(exp_close(loss, want[0], EXP_LOSS_RTOL) and exp_close(spread, want[1], atol=1e-6),
              f"ablation {name}: loss {loss}, spread {spread} vs {want}")
        log(f"experiments ablation {name}: final loss {loss:.6f} ({want[0]:.6f}), adapter "
            f"spread {spread:.6f} ({want[1]:.6f}), {steps / secs[name]:.1f} steps/s")
    order = exp_orderings({k: v["final_loss"] for k, v in ablation.items()},
                          {k: v[0] for k, v in ref["ablation_mtl_lm"]["rows"].items()},
                          [("local", "consensus"), ("graph", "consensus"), ("local", "graph")])
    check(all(order.values()), f"ablation orderings {order}")
    out["ablation_mtl_lm"] = {"rows": ablation, "orderings": order,
                              "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    q, want = exp_quiet(examples.quickstart.main, dev_arg), ref["quickstart"]
    check(all(exp_close(q[k], want[k], 1e-9) for k in ("rho", "eta", "tau")),
          f"quickstart rho/eta/tau {q} vs {want}")
    for name, (risk, obj) in q["methods"].items():
        w_risk, w_obj = want["methods"][name]
        check(exp_close(risk, w_risk) and exp_gap_ok(obj - q["f_star"], w_obj - want["f_star"]),
              f"quickstart {name}: {risk}, {obj} vs {w_risk}, {w_obj}")
    c = exp_quiet(examples.consensus_vs_multitask.main, dev_arg)
    want = ref["consensus_vs_multitask"]
    # the reference's spreads are parsed from its 4-decimal output: half a unit of slack
    check(c["consensus_spread"] <= 1e-6
          and all(exp_close(o, w[1], atol=5e-5) and exp_close(i, w[2], atol=5e-5)
                  for (_, o, i), w in zip(c["spreads"], want["spreads"]))
          and all(exp_close(d, w[1], atol=5e-6) for (_, d), w in zip(c["limit"], want["limit"])),
          f"consensus_vs_multitask {c} vs {want}")
    g, want = exp_quiet(examples.learn_the_graph.main, dev_arg), ref["learn_the_graph"]
    check(all(exp_close(g["risks"][k], want["risks"][k]) for k in want["risks"])
          and exp_close(g["within"], want["within"]) and exp_close(g["across"], want["across"])
          and [h["edges"] for h in g["history"]] == [h["edges"] for h in want["history"]]
          and all(exp_close(h["objective"], w["objective"])
                  for h, w in zip(g["history"], want["history"])),
          f"learn_the_graph {g} vs {want}")
    learned = ref["learn_the_graph"]["risks"]["learned graph"]
    log(f"experiments examples: quickstart f* {q['f_star']:.6f} "
        f"({ref['quickstart']['f_star']:.6f}), consensus spread {c['consensus_spread']:.2e}, "
        f"learned graph risk {g['risks']['learned graph']:.6f} ({learned:.6f}), within / "
        f"across {g['within']:.4f} / {g['across']:.4f}")

    ex = examples.train_multitask_lm
    tree = exp_init_tree(convert, TransformerLM, ex.example_config("--full" in EXP_TRAIN_ARGS))
    t, want = exp_quiet(ex.main, EXP_TRAIN_ARGS + dev_arg, params=tree), ref["train_multitask_lm"]
    losses = [h["loss"] for h in t["history"]]
    check(t["params"] == want["params"]
          and [h["step"] for h in t["history"]] == [h["step"] for h in want["history"]]
          and all(exp_close(a, w["loss"], EXP_LOSS_RTOL) for a, w in zip(losses, want["history"]))
          and exp_close(t["spread"], want["spread"], atol=1e-7)
          and exp_close(t["neighbor"], want["neighbor"], atol=1e-7),
          f"train_multitask_lm {t} vs {want}")
    log(f"experiments train_multitask_lm --full: {t['params']} parameters, losses "
        f"{losses[0]:.6f} .. {losses[-1]:.6f} (reference {want['history'][0]['loss']:.6f} .. "
        f"{want['history'][-1]['loss']:.6f}), {t['seconds']:.2f} s, {t['tok_s']:.1f} tok/s")

    cfg = dataclasses.replace(get("qwen2_5_14b", smoke=True), attn_backend="plain")
    tree = exp_init_tree(convert, TransformerLM, cfg)
    zero_counts(ops)
    s = exp_quiet(examples.serve_batched.main, dev_arg, params=tree)
    launched = read_counts(ops)
    want = ref["serve_batched"]
    flags = {k: s[k] for k in ("batcher_match", "paged_match", "scan_match", "kernel_match",
                               "sla_match", "prefix_match")}
    counters = ("ticks", "decode_dispatches", "prefill_dispatches", "free_blocks",
                "mixed_dispatches", "streamed", "cancelled_emitted", "hit_tokens",
                "lookup_tokens", "cow_copies", "prefill_tokens")
    check(all(v is True for v in flags.values()), f"serve_batched parities {flags}")
    check(all(s[k] == want[k] for k in counters),
          f"serve_batched counters { {k: (s[k], want[k]) for k in counters} }")
    check(max(s["cross_check"].values()) <= TOL["float32"],
          f"serve_batched kernel cross-check {s['cross_check']}")
    # the cross-check calls each attention kernel once; the rest served part 5
    serving = {k: v - (k != "graph_mix") for k, v in launched.items()}
    check(serving["decode_attention"] > 0 and serving["prefill_attention"] > 0
          and all(launched[k] == 1 for k in ("paged_decode_attention",
                                             "paged_prefill_attention")),
          f"serve_batched launches {launched}")
    log(f"experiments serve_batched: parities {flags}; counters == the reference's; "
        f"first continuation == the reference's: "
        f"{s['first_continuation'] == want['first_continuation']}; kernel cross-check "
        f"{s['cross_check']}; launches {launched} (serving: {serving}); engine "
        f"{s['engine_tok_s']:.1f} tok/s")
    out["examples"] = {
        "quickstart": q, "consensus_vs_multitask": c, "learn_the_graph": g,
        "train_multitask_lm": {k: t[k] for k in ("params", "spread", "neighbor", "seconds",
                                                 "tok_s")} | {"losses": losses},
        "serve_batched": s, "seconds": time.perf_counter() - t0}
    out["launches"] = serving
    return out


def phase_experiments(experiments, examples, convert, TransformerLM, get, ops, smi, f_star,
                      dev="cuda"):
    """Phase 18: the paper's experiments, the LM ablation, the five examples
    and the graph-mix kernel entry through their entry points on the card,
    held to the JAX reference's numbers (EXP_REF)."""
    t_phase = time.perf_counter()
    bad = []

    def check(ok, what):
        if not ok:
            bad.append(what)
            log(f"experiments: FAILED {what}")

    out = {"device": smi}
    out.update(phase_exp_figures(experiments, f_star, dev, check))
    out.update(phase_exp_models(experiments, examples, convert, TransformerLM, get, ops, dev,
                                check))
    # (c) the runner's kernels entry: kernel 5 against its plain version
    ops["graph_mix"].launches = 0
    res = exp_quiet(experiments.run.main, ["--only", "kernels", "--device", dev])
    derived = res["kernels"][1]
    err = float(derived.split("graph_mix_max_err=")[1].split(",")[0])
    out["kernels_entry"] = {"derived": derived, "max_abs_err": err,
                            "launches": ops["graph_mix"].launches}
    check(err <= MIX_TOL["float32"][0] and "route=cuda kernel" in derived
          and ops["graph_mix"].launches == 1, f"run --only kernels: {out['kernels_entry']}")
    log(f"experiments kernels entry: {derived}, {ops['graph_mix'].launches} graph-mix launch")
    out["seconds"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError(f"experiments: {len(bad)} checks failed: {bad}")
    log(f"experiments: phase passed in {out['seconds']:.1f} s")
    return out


COUNTED = ("decode_attention", "prefill_attention", "paged_decode_attention",
           "paged_prefill_attention", "graph_mix")


def zero_counts(ops):
    for name in COUNTED:
        ops[name].launches = 0


def read_counts(ops):
    return {name: ops[name].launches for name in COUNTED}


def check_launches(phase, launches, st, paged, layers=LAYERS, graph_mix=0):
    """One launch of the decode kernel per layer per decode dispatch and of
    the prefill kernel per layer per prefill dispatch, of the layout's
    kernels only, and ``graph_mix`` launches of the graph-mix kernel. With
    CUDA graphs each step also ran once, every lane dead, before its
    capture (one more per layer), and each replay counts what its capture
    recorded: the counts are the kernels the card executed."""
    if st["captures"] not in (0, 2):
        raise AssertionError(f"{phase}: {st['captures']} captures, want 0 or 2")
    warm = st["captures"] // 2  # one warm-up before each step's capture
    pre = "paged_" if paged else ""
    want = {name: 0 for name in COUNTED}
    want[pre + "decode_attention"] = layers * (st["decode_dispatches"] + warm)
    want[pre + "prefill_attention"] = layers * (st["prefill_dispatches"] + warm)
    want["graph_mix"] = graph_mix
    log(f"{phase}: dispatches decode={st['decode_dispatches']} "
        f"prefill={st['prefill_dispatches']}, captures {st['captures']}; launches {launches}")
    # layers 0: a model with no GQA attention layer (MLA, xLSTM) launches none
    if launches != want or (layers and min(want[pre + "decode_attention"],
                                           want[pre + "prefill_attention"]) == 0):
        raise AssertionError(f"{phase}: kernel launches {launches} != expected {want}")


def vision_batch(extras):
    """A VLM's per-request extras (dicts, or None for text only) as the
    engine's prompt-batch lists, zeros under a False mask for text rows;
    {} without extras."""
    if extras is None:
        return {}
    return {"vision_embeds": [e["vision_embeds"] for e in extras],
            "vision_mask": [e["vision_mask"] for e in extras]}


def serve_timed(torch, engine, prompts, new, ops, task_ids=None, zero=True, extras=None):
    """One ServeEngine.generate call with the launch counts zeroed just
    before (unless the caller zeroed them earlier: ``zero=False``) and read
    just after; ``extras``: a VLM's per-request vision inputs. Returns
    (tokens, launches, ttft list, wall)."""
    first = {}
    batch = {"tokens": prompts, **vision_batch(extras)}
    if task_ids is not None:
        batch["task_ids"] = task_ids
    torch.cuda.synchronize()
    if zero:
        zero_counts(ops)
    start = time.perf_counter()

    def on_token(uid, tok):
        first.setdefault(uid, time.perf_counter() - start)

    toks = engine.generate(batch, new, on_token=on_token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    return toks, read_counts(ops), sorted(first.values()), wall


def report_rates(phase, st, n_req, new, ttft, wall, unit="tok"):
    """Decode and prefill rates, TTFT, wall and capture time; ``unit``
    "frames" for an audio model, whose step emits one row of K codebook
    tokens (the rates count steps: frames per second)."""
    decode_tokens = n_req * (new - 1)  # each request's first token comes from prefill
    rates = {
        "decode_tok_s": decode_tokens / st["decode_s"],
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1], "wall_s": wall,
        "capture_s": st["capture_s"], "unit": unit,
    }
    log(f"{phase}: decode {rates['decode_tok_s']:.1f} {unit}/s ({decode_tokens} {unit} in "
        f"{st['decode_s']:.3f} s), prefill {rates['prefill_tok_s']:.1f} {unit}/s "
        f"({st['prefill_tokens']} {unit} in {st['prefill_s']:.3f} s), TTFT p50 "
        f"{rates['ttft_p50_s']:.3f} s max {rates['ttft_max_s']:.3f} s, wall {wall:.3f} s; "
        f"capture {st['capture_s']:.3f} s ({st['captures']} graphs)")
    return rates


def eager_parity(torch, phase, engine, prompts, new, ops, toks, task_ids=None, extras=None,
                 unit="tok"):
    """The same requests through ``engine`` (built with cuda_graphs=False):
    greedy tokens identical to the graph run's ``toks``, every request;
    returns the eager run's rates."""
    etoks, _, ettft, ewall = serve_timed(torch, engine, prompts, new, ops, task_ids,
                                         extras=extras)
    if not (etoks.shape == toks.shape and (etoks == toks).all()):
        bad = sorted({int(i) for i in (etoks != toks).nonzero()[0]})
        raise AssertionError(f"{phase}: graph tokens != eager tokens for requests {bad}")
    log(f"{phase}: CUDA-graph tokens == eager tokens on all {toks.size} greedy tokens")
    return report_rates(f"{phase} (eager)", engine.last_stats, len(prompts), new, ettft, ewall,
                        unit)


def logits_parity(np, phase, model, ContinuousBatcher, Request, prompts, max_seq=1024,
                  extras=None, **batcher_kw):
    """Every logits row every dispatch hands the sampler (greedy), with
    CUDA graphs against eager, for the same requests: within GRAPH_TOL.
    Returns the largest absolute difference."""
    runs = []
    for graphs in (True, False):
        rows = {}

        def keep(req, row, rows=rows):
            rows[(req.uid, len(req.out))] = row.copy()
            return np.argmax(row, axis=-1)

        bt = ContinuousBatcher(model, num_slots=4, max_seq=max_seq, prefill_chunk=32,
                               sample_fn=keep, cuda_graphs=graphs, **batcher_kw)
        for uid, p in enumerate(prompts):
            bt.submit(Request(uid=uid, tokens=p, max_new=NEW,
                              extras=None if extras is None else extras[uid]))
        bt.run()
        bt.close()
        runs.append(rows)
    if runs[0].keys() != runs[1].keys():
        raise AssertionError(f"{phase}: graph and eager runs sampled different steps")
    worst = max(float(np.abs(runs[0][k] - runs[1][k]).max()) for k in runs[0])
    log(f"{phase}: step logits with CUDA graphs vs eager: max abs diff {worst:.3e} over "
        f"{len(runs[0])} rows of {runs[0][0, 0].size} (limit {GRAPH_TOL})")
    if not worst <= GRAPH_TOL:
        raise AssertionError(f"{phase}: graph logits differ from eager by {worst}")
    return worst


def log_memory(torch, phase):
    """Device memory still allocated after a phase (its batchers, caches
    and graph pools released): a pool that outlives its batcher shows."""
    mb = torch.cuda.memory_allocated() / 1e6
    log(f"{phase}: torch.cuda.memory_allocated() {mb:.1f} MB after the phase")
    return mb


@contextlib.contextmanager
def plain_backend(model):
    """The model (and an adapter store built on it) on the plain versions
    of every kernel while the block runs."""
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, attn_backend="plain")
    try:
        yield
    finally:
        model.cfg = saved


def greedy_run(np, model, prompts, new, ContinuousBatcher, Request, task_ids=None,
               max_seq=1024, extras=None, **batcher_kw):
    """The requests through a 4-slot batcher, greedy, with each step's
    top-2 logit margin recorded (an audio row's: the smallest over its
    codebooks): (outputs, margins) by uid."""
    margins: dict = {}

    def greedy_with_margin(req, row):
        if not np.isfinite(row).all():
            raise AssertionError(f"non-finite logits for request {req.uid}")
        top2 = np.partition(row, -2, axis=-1)[..., -2:]
        margins.setdefault(req.uid, []).append(float((top2[..., 1] - top2[..., 0]).min()))
        return np.argmax(row, axis=-1)

    batcher = ContinuousBatcher(model, num_slots=4, max_seq=max_seq, prefill_chunk=32,
                                sample_fn=greedy_with_margin, **batcher_kw)
    for uid, p in enumerate(prompts):
        tid = 0 if task_ids is None else int(task_ids[uid])
        batcher.submit(Request(uid=uid, tokens=p, max_new=new, task_id=tid,
                               extras=None if extras is None else extras[uid]))
    out = {r.uid: r.out for r in batcher.run()}
    batcher.close()
    return out, margins


def plain_run(np, model, prompts, new, ContinuousBatcher, Request, task_ids=None,
              max_seq=1024, extras=None, **batcher_kw):
    """The same requests through the plain attention path, greedy, with
    each step's top-2 logit margin recorded: (outputs, margins) by uid."""
    with plain_backend(model):  # the oracle runs eagerly
        return greedy_run(np, model, prompts, new, ContinuousBatcher, Request, task_ids,
                          max_seq, extras, cuda_graphs=False, **batcher_kw)


def compare(phase, what, toks, ref, margins, new):
    """Greedy parity under the margin rule: a request's comparison ends at
    the first step whose plain top-2 margin is below MARGIN (an audio step
    is a row of K codebook tokens, compared whole)."""
    compared = 0
    for uid in range(len(toks)):
        for t in range(new):
            if margins[uid][t] < MARGIN:
                log(f"{phase}: request {uid} comparison with {what} ends at step {t}: "
                    f"plain top-2 margin {margins[uid][t]:.2e} < {MARGIN}")
                break
            if plain_value(ref[uid][t]) != plain_value(toks[uid][t]):
                raise AssertionError(
                    f"{phase}: request {uid} step {t}: kernel token {toks[uid][t]} != "
                    f"{what} {ref[uid][t]} (margin {margins[uid][t]:.3e})")
            compared += 1
    log(f"{phase}: kernel path == {what} on {compared}/{len(toks) * new} greedy tokens")
    return compared


def plain_value(tok):
    """A greedy step as a Python value: an int, or an audio row's list."""
    return tok.tolist() if hasattr(tok, "tolist") else tok


def check_tokens(phase, toks, n, new, vocab, codebooks=1):
    want = (n, new) if codebooks == 1 else (n, new, codebooks)
    if toks.shape != want or toks.min() < 0 or toks.max() >= vocab:
        raise AssertionError(f"{phase}: bad output tokens: shape {toks.shape}")


SERVE_LENS = [700, 64, 413, 257, 590, 128]
NEW = 16


def phase_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request, ops):
    """Dense cache: the PR 11 main path."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SERVE_LENS]
    kw = dict(max_seq=1024, prefill_chunk=32, num_slots=4)
    engine = ServeEngine(model, **kw)
    toks, launches, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops)
    st = engine.last_stats
    check_launches("serve", launches, st, paged=False)
    check_tokens("serve", toks, len(prompts), NEW, cfg.vocab_size)
    rates = report_rates("serve", st, len(prompts), NEW, ttft, wall)
    rates["eager"] = eager_parity(torch, "serve", ServeEngine(model, cuda_graphs=False, **kw),
                                  prompts, NEW, ops, toks)
    rates["logits_diff_graph_vs_eager"] = logits_parity(np, "serve", model, ContinuousBatcher,
                                                        Request, prompts)
    ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request)
    compare("serve", "plain path", toks, ref, margins, NEW)
    rates["memory_mb"] = log_memory(torch, "serve")
    return {"launches": launches, "tokens": toks, "prompts": prompts, "rates": rates,
            "stats": st}


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
    kw = dict(max_seq=1024, prefill_chunk=32, num_slots=4, paging=spec)
    engine = ServeEngine(model, **kw)
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
    rates["eager"] = eager_parity(torch, "paged", ServeEngine(model, cuda_graphs=False, **kw),
                                  prompts, NEW, ops, toks)
    rates["logits_diff_graph_vs_eager"] = logits_parity(np, "paged", model, ContinuousBatcher,
                                                        Request, prompts, paging=spec)
    ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request,
                             paging=spec)
    compare("paged", "plain path (paged)", toks, ref, margins, NEW)
    compare("paged", "dense kernel path", toks, dense["tokens"], margins, NEW)
    rates["memory_mb"] = log_memory(torch, "paged")
    return {"launches": launches, "rates": rates, "tokens": toks}


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
    kw = dict(max_seq=1024, prefill_chunk=32, num_slots=4, paging=spec, prefix_cache=True)
    engine = ServeEngine(model, **kw)
    toks, launches, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops, task_ids)
    st, ps = engine.last_stats, engine.last_prefix_stats
    check_launches("prefix", launches, st, paged=True)
    check_tokens("prefix", toks, len(prompts), NEW, cfg.vocab_size)
    rates = report_rates("prefix", st, len(prompts), NEW, ttft, wall)
    rates["eager"] = eager_parity(torch, "prefix", ServeEngine(model, cuda_graphs=False, **kw),
                                  prompts, NEW, ops, toks, task_ids)
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
    ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request,
                             paging=spec, prefix_cache=True)
    compare("prefix", "plain path (prefix cache)", toks, ref, margins, NEW)
    compare("prefix", "kernel path without the cache", toks, base_toks, margins, NEW)
    rates.update(hit_ratio=ps["hit_ratio"], cow_copies=ps["cow_copies"],
                 prefill_tokens=ps["prefill_tokens"],
                 prefill_tokens_no_cache=base["prefill_tokens"],
                 ttft_p50_s_no_cache=statistics.median(base_ttft))
    rates["memory_mb"] = log_memory(torch, "prefix")
    return {"launches": launches, "rates": rates}


FAULT_DECODE_TICK = 20  # a mid-run decode tick of the paged requests
FAULT_NAN_UID = 0  # the 700-token request: its 45 blocks free up early
HOG_NEW = 64  # 700 + 64 tokens: 48 blocks of the 63 a 1024-token pool has


def batcher_stats(bt):
    return {"captures": bt.captures, "decode_dispatches": bt.decode_dispatches,
            "prefill_dispatches": bt.prefill_dispatches}


def decode_rate(bt, reqs):
    """Decode tok/s of a batcher run: tokens the decode ticks emitted (all
    but each request's first, which its prefill gives) over decode_s."""
    tokens = sum(max(len(r.out) - 1, 0) for r in reqs)
    return tokens / bt.decode_s, tokens


def timed_swap(torch, fn, sink):
    """A swap direction with each call synchronized on both sides; appends
    (host seconds, the pages' shape, the snapshot's bytes (pages and state
    columns), pinned) to ``sink`` and keeps no reference to the snapshot, so
    its pinned memory returns to torch's cache when the request lets go of
    it."""
    def call(caches, blocks, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(caches, blocks, *args)
        torch.cuda.synchronize()
        pages, columns = args[0] if len(args) == 2 else out  # swap_in(.., saved, slot)
        parts = [*pages, *columns]
        sink.append((time.perf_counter() - t0, [tuple(p.shape) for p in pages],
                     sum(t.numel() * t.element_size() for t in parts),
                     all(t.is_pinned() for t in parts)))
        return out
    return call


def phase_faults(torch, np, model, ServeEngine, ContinuousBatcher, Request, PagingSpec,
                 FaultPlan, ops, dense, paged):
    """Fault tolerance at OLMo-1B full width, CUDA graphs on: an empty plan
    on the dense phase's requests (tokens, dispatches and launches equal to
    phase 3's), a scripted plan over phase 4's pool (a twice-failing decode
    dispatch mid-run, a failing first prefill dispatch, a poisoned lane:
    only that request fails, the others keep phase 4's tokens), the
    quarantine alone on phase 4's requests (its price in decode tok/s), and
    a preemption: a priority-10 hog swapped out for a priority-0 request
    and restored, against a roomy pool and an eager run."""
    prompts = dense["prompts"]
    mem_before = torch.cuda.memory_allocated() / 1e6
    launches_sum = {name: 0 for name in COUNTED}
    rates = {}

    def add(launches):
        for name in COUNTED:
            launches_sum[name] += launches[name]

    # 1. an armed, empty plan: the quarantine reads every dispatch's logits
    engine = ServeEngine(model, max_seq=1024, prefill_chunk=32, num_slots=4, faults=FaultPlan())
    toks, launches, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops)
    st = engine.last_stats
    check_launches("faults (empty plan)", launches, st, paged=False)
    add(launches)
    same = {k: (st[k], dense["stats"][k]) for k in ("decode_dispatches", "prefill_dispatches",
                                                     "captures")}
    if (not np.array_equal(toks, dense["tokens"]) or launches != dense["launches"]
            or any(a != b for a, b in same.values()) or st["dispatch_faults"]
            or st["quarantined"]):
        raise AssertionError(f"faults (empty plan): differs from phase 3: dispatches {same}, "
                             f"launches {launches} vs {dense['launches']}, tokens equal "
                             f"{np.array_equal(toks, dense['tokens'])}")
    log(f"faults (empty plan): tokens, dispatches {same} and launches == phase 3's")
    rates["empty_plan"] = report_rates("faults (empty plan)", st, len(prompts), NEW, ttft, wall)

    spec = PagingSpec.sized(16, 1024, 1024)

    def paged_run(name, **kw):
        bt = ContinuousBatcher(model, num_slots=4, max_seq=1024, prefill_chunk=32, paging=spec,
                               **kw)
        for uid, p in enumerate(prompts):
            bt.submit(Request(uid=uid, tokens=p, max_new=NEW))
        torch.cuda.synchronize()
        zero_counts(ops)
        t0 = time.perf_counter()
        done = {r.uid: r for r in bt.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(ops)
        check_launches(name, launches, batcher_stats(bt), paged=True)
        add(launches)
        summary = bt.check_invariants()
        bt.close()
        tok_s, n = decode_rate(bt, done.values())
        log(f"{name}: decode {tok_s:.1f} tok/s ({n} tokens in {bt.decode_s:.3f} s; phase 4 "
            f"{paged['rates']['decode_tok_s']:.1f}), wall {wall:.3f} s, captures "
            f"{bt.captures}; check_invariants {summary}")
        return bt, done, summary, tok_s

    # 2. the quarantine alone: phase 4's schedule, plus one logits read a dispatch
    del engine
    bt, done, summary, tok_s = paged_run("faults (quarantine only)", quarantine=True)
    got = np.stack([np.asarray(done[uid].out, np.int32) for uid in range(len(prompts))])
    if not np.array_equal(got, paged["tokens"]) or bt.quarantined:
        raise AssertionError("faults (quarantine only): tokens differ from phase 4's")
    rates["quarantine_decode_tok_s"] = tok_s

    # 3. a scripted plan over phase 4's pool
    plan = (FaultPlan().script("dispatch", where="decode", tick=FAULT_DECODE_TICK, count=2)
            .script("dispatch", where="prefill", count=1)
            .script("nan", uid=FAULT_NAN_UID, count=1))
    bt, done, summary, tok_s = paged_run("faults (scripted)", faults=plan)
    bad = done[FAULT_NAN_UID]
    log(f"faults (scripted): plan log {plan.log}; request {FAULT_NAN_UID}: failed {bad.failed} "
        f"({bad.error})")
    if not (bad.failed and "non-finite" in bad.error):
        raise AssertionError(f"faults (scripted): request {FAULT_NAN_UID} was not quarantined")
    others = [uid for uid in range(len(prompts)) if uid != FAULT_NAN_UID]
    differ = [uid for uid in others
              if done[uid].failed or list(done[uid].out) != list(paged["tokens"][uid])]
    if (differ or bt.dispatch_faults != 3 or bt.captures != 2 or bt.quarantined != 1
            or summary["live_refs"] != 0 or summary["live_slots"] or summary["queued"]):
        raise AssertionError(f"faults (scripted): tokens differ from phase 4's for {differ}, "
                             f"dispatch_faults {bt.dispatch_faults}, captures {bt.captures}, "
                             f"quarantined {bt.quarantined}, invariants {summary}")
    log(f"faults (scripted): requests {others} == phase 4's tokens; dispatch_faults 3, "
        "captures 2, quarantined 1, live_refs 0")
    rates["scripted_decode_tok_s"] = tok_s
    del bt

    # 4. preemption: a hog swapped out for a short request of higher priority
    hog, short = prompts[0], prompts[2]

    def pressure(pool_tokens, preempt, graphs):
        bt = ContinuousBatcher(model, num_slots=2, max_seq=1024, prefill_chunk=32,
                               paging=PagingSpec.sized(16, 1024, pool_tokens), policy="priority",
                               preempt=preempt, cuda_graphs=graphs)
        ptrs = [(k.data_ptr(), v.data_ptr()) for k, v in bt.caches]
        on_card = bt.caches[0][0].is_cuda
        outs, ins = [], []
        if preempt:
            bt._swap_out_fn = timed_swap(torch, bt._swap_out_fn, outs)
            bt._swap_in_fn = timed_swap(torch, bt._swap_in_fn, ins)
        torch.cuda.synchronize()
        zero_counts(ops)
        reqs = [Request(uid=0, tokens=hog, max_new=HOG_NEW, priority=10),
                Request(uid=1, tokens=short, max_new=NEW, priority=0)]
        bt.submit(reqs[0])
        bt.step()
        bt.step()
        bt.submit(reqs[1])
        bt.run()
        torch.cuda.synchronize()
        launches = read_counts(ops)
        name = (f"faults (preemption, {pool_tokens}-token pool, "
                f"{'graphs' if graphs else 'eager'})")
        check_launches(name, launches, batcher_stats(bt), paged=True)
        add(launches)
        summary = bt.check_invariants()
        moved = ptrs != [(k.data_ptr(), v.data_ptr()) for k, v in bt.caches]
        bt.close()
        log(f"{name}: swap_outs {bt.swap_outs}, swap_ins {bt.swap_ins}, hog preemptions "
            f"{reqs[0].preemptions}; check_invariants {summary}; pools moved {moved}")
        if moved or summary["live_slots"] or summary["queued"] or summary["live_refs"]:
            raise AssertionError(f"{name}: pools moved {moved} or invariants {summary}")
        if (preempt and ((bt.swap_outs, bt.swap_ins, reqs[0].preemptions) != (1, 1, 1)
                         or len(outs) != 1 or len(ins) != 1)):
            raise AssertionError(f"{name}: swap_outs {bt.swap_outs}, swap_ins {bt.swap_ins}, "
                                 f"preemptions {reqs[0].preemptions}")
        if any(on_card and not pinned for *_, pinned in outs + ins):
            raise AssertionError(f"{name}: the swap snapshot is not pinned")
        return [list(r.out) for r in reqs], outs, ins

    want, _, _ = pressure(2048, False, True)
    timings = {}
    # the graph run's swap-out is the process's first: it allocates the
    # pinned snapshot; the eager run's reuses it from torch's cache
    for graphs in (True, False):
        got, ((out_s, shape, nbytes, _),), ((in_s, *_),) = pressure(1024, True, graphs)
        mode = "graphs" if graphs else "eager"
        if got != want:
            raise AssertionError(f"faults (preemption, {mode}): tokens differ from the roomy "
                                 "pool's")
        timings[mode] = {"swap_out_ms": out_s * 1e3, "swap_in_ms": in_s * 1e3,
                         "snapshot_mib": nbytes / 2**20, "swap_out_gb_s": nbytes / out_s / 1e9,
                         "swap_in_gb_s": nbytes / in_s / 1e9}
        log(f"faults (preemption, {mode}): tokens == the roomy pool's on both requests; "
            f"snapshot {shape}, {nbytes / 2**20:.1f} MiB pinned; synchronized swap-out "
            f"{out_s * 1e3:.2f} ms ({nbytes / out_s / 1e9:.2f} GB/s), swap-in "
            f"{in_s * 1e3:.2f} ms ({nbytes / in_s / 1e9:.2f} GB/s)")
    rates["preemption"] = timings
    rates["memory_before_mb"] = mem_before
    rates["memory_mb"] = log_memory(torch, "faults")
    return {"launches": launches_sum, "rates": rates}


ADAPTER_LENS = [700, 64, 413, 257, 590, 128, 300, 500]
ADAPTER_TASKS = [0, 37, 74, 111, 148, 185, 222, 255]
ADAPTER_SCALE = 1e-2  # std of the randomized adapter factors


def phase_adapters(torch, np, model, ServeEngine, TaskAdapterStore, band_graph, tree_lib,
                   ContinuousBatcher, Request, ops):
    """Mixed-tenant multi-LoRA serving at the multitask-LM's full width:
    8 requests of 8 tasks under a graph-mixed, randomized adapter store
    whose delayed updates run as the requests finish (update_every 2), over
    the dense cache."""
    cfg = model.cfg
    n_req = len(ADAPTER_LENS)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in ADAPTER_LENS]
    task_ids = np.asarray(ADAPTER_TASKS, np.int32)
    graph = band_graph(cfg.num_tasks, 2)
    store_kw = dict(mixing="bsr", eta=1.0, tau=1.0, alpha=1.0, update_every=2, max_delay=2,
                    seed=0)

    def engine(store=None, cuda_graphs=None):
        return ServeEngine(model, max_seq=1024, prefill_chunk=32, num_slots=4,
                           adapters=store, cuda_graphs=cuda_graphs)

    # the same requests without a store: the yardstick of the store's cost
    base_eng = engine()
    base, _, base_ttft, base_wall = serve_timed(torch, base_eng, prompts, NEW, ops, task_ids)
    base_rates = report_rates("adapters (no store)", base_eng.last_stats, n_req, NEW, base_ttft,
                              base_wall)
    zero_store = TaskAdapterStore(model, graph, **store_kw)
    zero = engine(zero_store).generate({"tokens": prompts, "task_ids": task_ids}, NEW)
    if not np.array_equal(zero, base):
        raise AssertionError("adapters: a zero store changed the no-store tokens")
    log(f"adapters: zero store == no store on all {base.size} greedy tokens "
        f"({zero_store.updates} updates of the zero store)")
    del zero_store

    # the main path: counts zeroed before the store is built
    torch.cuda.synchronize()
    zero_counts(ops)
    t0 = time.perf_counter()
    store = TaskAdapterStore(model, graph, **store_kw)
    store.randomize(scale=ADAPTER_SCALE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    update_s = []
    update = store.update

    def timed_update():
        t = time.perf_counter()
        update()
        update_s.append(time.perf_counter() - t)

    store.update = timed_update
    eng = engine(store)
    toks, launches, ttft, wall = serve_timed(torch, eng, prompts, NEW, ops, task_ids,
                                             zero=False)
    st = eng.last_stats
    want_mix = 1 + 1 + 2 * (n_req // store.update_every)
    check_launches("adapters", launches, st, paged=False, layers=cfg.num_layers,
                   graph_mix=want_mix)
    check_tokens("adapters", toks, n_req, NEW, cfg.vocab_size)
    rates = report_rates("adapters", st, n_req, NEW, ttft, wall)
    changed = int((toks != base).sum())
    log(f"adapters: store of {cfg.num_tasks} tasks x {adapter_width(cfg)} floats "
        f"({sum(t.numel() * t.element_size() for t in tree_lib.leaves(store.raw)) / 1e6:.1f} "
        f"MB raw), built and randomized in {setup_s:.3f} s; {store.updates} updates, host "
        f"s in update() {sum(update_s):.4f} ({', '.join(f'{x:.4f}' for x in update_s)}); "
        f"random adapters changed {changed} of {toks.size} tokens against no store")
    if store.updates != n_req // store.update_every or changed == 0:
        raise AssertionError(f"adapters: {store.updates} updates, {changed} tokens changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    update()
    torch.cuda.synchronize()
    one_update_ms = (time.perf_counter() - t0) * 1e3
    peak_mb = (torch.cuda.max_memory_allocated() - before) / 1e6
    log(f"adapters: one more update(), synchronized: {one_update_ms:.2f} ms wall, peak "
        f"{peak_mb:.1f} MB above the {before / 1e6:.1f} MB allocated before it")

    # the same requests eagerly, under a store built and randomized from the
    # same seed (the graph run's store has since been updated)
    eager_store = TaskAdapterStore(model, graph, **store_kw)
    eager_store.randomize(scale=ADAPTER_SCALE)
    rates["eager"] = eager_parity(torch, "adapters", engine(eager_store, cuda_graphs=False),
                                  prompts, NEW, ops, toks, task_ids)
    del eager_store

    with plain_backend(model):  # the same store seed, mixed by the plain version
        plain_store = TaskAdapterStore(model, graph, **store_kw)
        plain_store.randomize(scale=ADAPTER_SCALE)
        ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request,
                                 task_ids=task_ids, adapters=plain_store)
        plain_store.update()  # the kernel store ran one more update() above
    compare("adapters", "plain path (plain graph mix)", toks, ref, margins, NEW)
    atol, rtol = MIX_TOL["float32"]
    worst = 0.0
    for name in ("raw", "serving"):
        for got, want in zip(tree_lib.leaves(getattr(store, name)),
                             tree_lib.leaves(getattr(plain_store, name))):
            diff = (got - want).abs()
            worst = max(worst, diff.max().item())
            if not bool((diff <= atol + rtol * want.abs()).all()):
                raise AssertionError(f"adapters: kernel store {name} differs from the plain "
                                     f"store's by {diff.max().item()}")
    log(f"adapters: kernel store raw and serving == plain store's within atol {atol} rtol "
        f"{rtol} (max abs diff {worst:.2e}) after {store.updates} updates each")

    def admitted(with_store, graphs):
        bt = ContinuousBatcher(model, num_slots=4, max_seq=1024, prefill_chunk=32,
                               adapters=store if with_store else None, cuda_graphs=graphs)
        for uid in range(4):  # max_new 64: no request finishes, so no update runs
            bt.submit(Request(uid=uid, tokens=prompts[uid], max_new=64,
                              task_id=int(task_ids[uid])))
        return _admitted(bt)

    profiles = {}
    for with_store in (True, False):
        name = f"8 decode ticks ({'store' if with_store else 'no store'})"
        for graphs in (True, False):
            profiles[profile_key(name, graphs)] = profile_window(
                torch, name, lambda w=with_store, g=graphs: admitted(w, g), _ticks, graphs,
                layers=cfg.num_layers)
    rates.update(update_host_s=sum(update_s), updates=len(update_s),
                 one_update_ms=one_update_ms, update_peak_mb=peak_mb, tokens_changed=changed,
                 no_store=base_rates, profile=profiles)
    rates["memory_mb"] = log_memory(torch, "adapters")
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
    tokens), each with CUDA graphs (captured before the window) and
    eagerly, without and with torch.profiler, against the device time of
    the kernels the profiler saw, with the top kernels by device time."""
    lens = (700, 300, 500, 100)

    def batcher(paging=None, graphs=True):
        rng = np.random.default_rng(1)  # the same prompts in every window
        bt = ContinuousBatcher(model, num_slots=4, max_seq=1024, prefill_chunk=32,
                               paging=paging, cuda_graphs=graphs)
        for uid, n in enumerate(lens):
            bt.submit(Request(uid=uid, tokens=rng.integers(0, model.cfg.vocab_size, n)
                              .astype(np.int32),
                              max_new=64))
        bt.capture()  # outside the window (no-op eagerly)
        return bt

    spec = PagingSpec.sized(16, 1024, 4096)
    out = {}
    for name, setup, run in (
        ("prefill round", lambda g: batcher(graphs=g), lambda bt: bt._admit()),
        ("8 decode ticks", lambda g: _admitted(batcher(graphs=g)), _ticks),
        ("prefill round (paged)", lambda g: batcher(spec, g), lambda bt: bt._admit()),
        ("8 decode ticks (paged)", lambda g: _admitted(batcher(spec, g)), _ticks),
    ):
        for graphs in (True, False):
            out[profile_key(name, graphs)] = profile_window(
                torch, name, lambda s=setup, g=graphs: s(g), run, graphs)
    return out


def profile_key(name, graphs):
    return f"{name} [{'graphs' if graphs else 'eager'}]"


LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def profile_window(torch, name, setup, run, graphs, layers=LAYERS):
    """Host wall time of ``run(setup())`` without and with torch.profiler
    (a fresh ``setup()`` for each), against the device time of the kernels
    the profiler saw, with the top kernels by device time and the CUDA API
    calls the host made per dispatch. A decode window with graphs must make
    one cudaGraphLaunch per tick and launch no kernel from the host (the
    port's own kernels, launched through a statically linked runtime, leave
    no API record; the counters and the executed kernels show them); the
    attention kernels the profiler saw executing are logged against 16
    partial + 16 merge per tick. Returns the window's numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    label = profile_key(name, graphs)

    def window(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def dispatches(bt):
        return bt.decode_dispatches + bt.prefill_dispatches

    bt = setup()
    wall = window(lambda: run(bt))
    bt.close()
    bt = setup()
    n0, ticks0 = dispatches(bt), bt.decode_dispatches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = window(lambda: run(bt))
    n, ticks = dispatches(bt) - n0, bt.decode_dispatches - ticks0
    bt.close()
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    api = {e.key: e.count for e in events
           if e.device_type != DeviceType.CUDA and e.key.startswith("cu")}
    dev_us = {e.key: e.self_device_time_total for e in kern}
    busy = sum(dev_us.values()) / 1e6
    executed = sum(e.count for e in kern)
    host_launches = sum(api.get(k, 0) for k in LAUNCH_APIS)
    log(f"profile {label}: wall {wall * 1e3:.2f} ms (profiler off), "
        f"{wall_prof * 1e3:.2f} ms (on); device busy {busy * 1e3:.2f} ms "
        f"= {busy / wall_prof:.1%} of the traced wall; kernels {len(dev_us)} kinds, "
        f"{executed} executed over {n} dispatches ({executed / max(n, 1):.1f} each)")
    log(f"profile {label}: host CUDA API calls per dispatch: "
        + ", ".join(f"{k} {c / max(n, 1):.2f}" for k, c in sorted(api.items())))
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile {label}:   {us / 1e3:8.3f} ms  {key[:90]}")
    attention = {}
    for e in kern:  # the port's attention kernels, wherever they rank
        if any(k_ in e.key for k_ in ("prefill_partial", "prefill_combine", "decode_partial",
                                      "decode_combine")):
            attention[short_name(e.key)] = e.count
            log(f"profile {label}: attention {e.self_device_time_total / 1e3:8.3f} ms in "
                f"{e.count} launches  {short_name(e.key)}")
    if ticks and ticks == n:  # a decode window
        seen = [sum(c for k, c in attention.items() if part in k) / ticks
                for part in ("decode_partial", "decode_combine")]
        log(f"profile {label}: attention kernels executed per tick: {seen[0]:g} partial + "
            f"{seen[1]:g} merge (want {layers} + {layers})"
            + ("" if seen == [layers, layers] else "; profiler records incomplete"))
        if graphs and (api.get("cudaGraphLaunch", 0) != ticks or host_launches):
            raise AssertionError(
                f"profile {label}: {api.get('cudaGraphLaunch', 0)} cudaGraphLaunch and "
                f"{host_launches} kernel launches from the host over {ticks} ticks; want one "
                "graph launch per tick and none")
    return {"wall_ms": wall * 1e3, "wall_profiled_ms": wall_prof * 1e3,
            "device_busy_ms": busy * 1e3, "dispatches": n, "kernels_executed": executed,
            "host_api_per_dispatch": {k: c / max(n, 1) for k, c in api.items()},
            "attention_executed": attention}


def _ticks(bt, n=8):
    for _ in range(n):
        bt.tick()


def _admitted(bt):
    bt._admit()  # prefill every prompt; the decode ticks start from here
    bt.tick()
    return bt


TRAIN_SEED = 0  # numpy seed of the lockstep weights and of every token pipeline
TRAIN_LR = 1e-3  # adamw at a constant rate (cosine_schedule's step 0 has lr 0)
TRAIN_ETA, TRAIN_TAU = 0.1, 1.0  # GraphMultiTask over band_graph(num_tasks, 1)
TRAIN_LOCKSTEP = {"batch": 8, "seq": 128, "microbatches": 2, "steps": 4}
TRAIN_TASK_SCALE = 0.1  # std of the lockstep's per-task leaves (mixing acts from step 0)
TRAIN_RTOL = 1e-4  # the card's loss, nll and task-leaf norms against TRAIN_REF
# scripts/train_reference.py: the JAX package on the CPU (float32, matmul
# precision "highest") at multitask-LM full width, TRAIN_LOCKSTEP, the
# weights of train_weights: per step the loss, nll and Frobenius norm of
# each task leaf after the step
TRAIN_REF = {
    "loss": [10.851442337036133, 10.908153533935547, 10.815141677856445, 10.78341293334961],
    "nll": [10.851442337036133, 10.908153533935547, 10.815141677856445, 10.78341293334961],
    "task_norms": {
        "final_gain": [30.591598510742188, 25.48238182067871, 22.580623626708984,
                       20.554107666015625],
        "head_bias": [171.08509826660156, 142.5448455810547, 126.32621765136719,
                      114.99891662597656],
    },
}


def train_weights(np, leaves):
    """The lockstep's weights, drawn with numpy for both packages: leaves
    (path, shape) of the JAX params tree, drawn one at a time in sorted path
    order from one generator (TRAIN_SEED), float32: per-task leaves
    ("task/...") normal * TRAIN_TASK_SCALE, norm gains zero, weights normal
    / sqrt(fan_in) (the embedding's fan-in is its width). Returns {path:
    array}."""
    rng = np.random.default_rng(TRAIN_SEED)
    out = {}
    for path, shape in sorted(leaves):
        name = path.split("/")[-1]
        if path.startswith("task/"):
            scale = TRAIN_TASK_SCALE
        elif name == "gain":
            out[path] = np.zeros(shape, np.float32)
            continue
        else:
            scale = 1.0 / np.sqrt(shape[-1] if name == "embed" else shape[-2])
        out[path] = (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))
    return out


TRAIN_SPEED = {"batch": 32, "seq": 256, "warmup": 2, "steps": 10}
TRAIN_SYNC_STEPS = (5, 10)  # host syncs per step must be the same over both
TRAIN_OLMO = {"batch": 8, "seq": 256, "steps": 3}
TRAIN_LAUNCH = ["--arch", "multitask_lm", "--no-smoke", "--steps", "3", "--batch", "16",
                "--seq", "128"]
# the launcher's run and the same run in this process: logits of the two
# checkpoints' models (only the order of the card's atomic sums may differ)
TRAIN_LAUNCH_ATOL = 1e-3
TRAIN_SERVE_LENS = [300, 64, 500, 128]
TRAIN_SERVE_TASKS = [0, 85, 170, 255]
TRAIN_MOVED = 1e-3  # two steps must move some logit of the served requests by this


def train_flops(cfg, b, s):
    """(model FLOPs of one step, N): 6 N T for the N weights of the
    products (the layers' projections and MLP, the lm head; not the
    embedding gather, the norms or the per-task vectors) over T = b s
    tokens, plus the attention products as the reference computes them
    (every query against all S keys, masked): 4 b H S^2 hd a layer forward,
    three times that with the backward."""
    d, hd = cfg.d_model, cfg.head_dim
    mlp = 3 if cfg.mlp_kind == "swiglu" else 2
    per_layer = 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + mlp * d * cfg.d_ff
    n = cfg.num_layers * per_layer + d * cfg.vocab_size
    attn = 3 * cfg.num_layers * 4 * b * cfg.num_heads * s * s * hd
    return 6 * n * b * s + attn, n


def train_model(np, tr, cfg, dev, lockstep=False):
    """A full-width model on ``dev``: the port's seeded init, or with
    ``lockstep`` the weights of train_weights, loaded through convert."""
    model = tr["TransformerLM"](cfg, device=dev, seed=0)
    if lockstep:
        template = tr["convert"].params_to_numpy(model)
        leaves = [(p, leaf.shape) for p, leaf in tr["tree"].paths(template)]
        drawn = train_weights(np, leaves)
        tr["convert"].load_numpy_params(
            model, tr["tree"].unflatten(template, [drawn[p] for p, _ in leaves]))
    return model


def train_steps(tr, model, microbatches=1):
    """The smoke's train step on ``model`` (adamw(TRAIN_LR), the graph-mixed
    update over band_graph(num_tasks, 1)) and its fresh state."""
    opt = tr["adamw"](TRAIN_LR)
    gmt = tr["GraphMultiTask"](tr["band_graph"](model.cfg.num_tasks, 1), eta=TRAIN_ETA,
                               tau=TRAIN_TAU)
    return (tr["make_train_step"](model, opt, gmt, microbatches=microbatches),
            tr["init_state"](model, opt))


def train_batches(tr, cfg, batch, seq, n):
    """The first n host batches of the token pipeline (seed TRAIN_SEED), as
    the model's input mode takes them (the launcher's ``model_inputs``);
    a VLM's carry seeded vision embeddings over each row's first quarter."""
    pipe = iter(tr["TokenPipeline"](cfg.vocab_size, seq_len=seq, global_batch=batch,
                                    num_tasks=cfg.num_tasks, seed=TRAIN_SEED))
    out = [tr["model_inputs"](cfg, next(pipe)) for _ in range(n)]
    if cfg.input_mode == "vlm":
        import numpy as np

        rng = np.random.default_rng(TRAIN_SEED)
        for b in out:
            b["vision_embeds"] = rng.standard_normal(b["vision_embeds"].shape).astype(
                np.float32)
            b["vision_mask"][:, : seq // 4] = True
    return out


def free_card(torch):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_train_lockstep(torch, np, tr, cfg, dev):
    """10(a): multitask-LM at full width on the lockstep weights, the
    reference's batches and settings: loss, nll and task-leaf norms within
    TRAIN_RTOL of TRAIN_REF (scripts/train_reference.py)."""
    lock = TRAIN_LOCKSTEP
    model = train_model(np, tr, cfg, dev, lockstep=True)
    step, state = train_steps(tr, model, lock["microbatches"])
    got = {"loss": [], "nll": [], "task_norms": {k: [] for k in TRAIN_REF["task_norms"]}}
    for batch in train_batches(tr, cfg, lock["batch"], lock["seq"], lock["steps"]):
        state, m = step(state, tr["batch_to_device"](batch, dev))
        got["loss"].append(float(m["loss"]))
        got["nll"].append(float(m["nll"]))
        for name, trace in got["task_norms"].items():
            trace.append(float(model.task[name].detach().norm()))
    pairs = [(got["loss"], TRAIN_REF["loss"]), (got["nll"], TRAIN_REF["nll"])]
    pairs += [(got["task_norms"][k], TRAIN_REF["task_norms"][k]) for k in got["task_norms"]]
    rel = max(abs(a - b) / abs(b) for g, r in pairs for a, b in zip(g, r, strict=True))
    log(f"train (a): multitask-LM full width, {sum(p.numel() for p in model.parameters())} "
        f"params, {lock['steps']} steps of batch {lock['batch']} x {lock['seq']}, "
        f"{lock['microbatches']} microbatches: loss {got['loss']} against the reference's "
        f"{TRAIN_REF['loss']}; max relative difference of loss, nll and task-leaf norms "
        f"{rel:.3e} (limit {TRAIN_RTOL})")
    if not rel <= TRAIN_RTOL:
        raise AssertionError(f"train (a): the card's trace is {rel:.3e} from the reference's: "
                             f"{got}")
    return model, {"trace": got, "max_rel_err": rel}


def phase_train_speed(torch, np, tr, model, smi, dev):
    """10(b): steps of batch 32 x 256 on (a)'s model, synchronized, with
    remat on and off; host syncs per step over 5 and 10 steps; the
    reference's query-chunked attention against SDPA at this shape."""
    cfg, sp = model.cfg, TRAIN_SPEED
    flops, n_weights = train_flops(cfg, sp["batch"], sp["seq"])
    tokens = sp["batch"] * sp["seq"]
    batches = train_batches(tr, cfg, sp["batch"], sp["seq"], sp["warmup"] + sp["steps"])
    to_dev = tr["batch_to_device"]
    out = {"batch": sp["batch"], "seq": sp["seq"], "model_flops_per_step": flops,
           "product_weights": n_weights, "peak_flops_f32": PEAK_FLOPS["float32"]}
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        step, state = train_steps(tr, model)
        for b in batches[: sp["warmup"]]:
            state, _ = step(state, to_dev(b, dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches[sp["warmup"]:]:
            state, m = step(state, to_dev(b, dev))
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / sp["steps"]
        rec = {"ms_per_step": secs * 1e3, "tokens_per_s": tokens / secs,
               "mfu": flops / secs / PEAK_FLOPS["float32"],
               "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
               "last_loss": float(m["loss"])}
        if not np.isfinite(rec["last_loss"]):
            raise AssertionError(f"train (b): non-finite loss with remat={remat}")
        out["remat_on" if remat else "remat_off"] = rec
        log(f"train (b): remat {'on' if remat else 'off'}: {rec['ms_per_step']:.2f} ms/step, "
            f"{rec['tokens_per_s']:.1f} tokens/s, MFU {rec['mfu']:.4f} of the f32 CUDA-core "
            f"peak ({flops / 1e12:.4f} TFLOP a step: 6 x {n_weights} x {tokens} + attention), "
            f"torch.cuda.max_memory_allocated {rec['max_memory_allocated_mb']:.1f} MB; {smi}")
        del step, state
    model.cfg = cfg

    step, state = train_steps(tr, model)

    def run(n):
        def go():
            nonlocal state
            for b in batches[:n]:
                state, _ = step(state, to_dev(b, dev))
        return go

    sync_sites(torch, run(1))  # the first call under the debug mode also reports one-time syncs
    sites = {n: sync_sites(torch, run(n)) for n in TRAIN_SYNC_STEPS}
    out["syncs"] = {str(n): len(v) for n, v in sites.items()}
    log(f"train (b): host syncs by steps (torch sync debug mode): {out['syncs']}; "
        f"sites {sorted(set(x for v in sites.values() for x in v))}")
    lo, hi = TRAIN_SYNC_STEPS
    if len(sites[hi]) * lo != len(sites[lo]) * hi:
        raise AssertionError(f"train (b): host syncs per step differ over {lo} and {hi} steps")
    del step, state

    h, kvh, hd, s, b = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, sp["seq"], sp["batch"]
    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    q = torch.randn(b, s, h, hd, device=dev, generator=g)
    k, v = (torch.randn(b, s, kvh, hd, device=dev, generator=g) for _ in range(2))
    attend = tr["causal_attend"]
    # SDPA on (B, H, S, hd) with the KV heads expanded beforehand: its fused
    # f32 kernels take no grouped heads
    qh, kh, vh = (t.transpose(1, 2).repeat_interleave(h // t.shape[2], dim=1).contiguous()
                  for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    ref = attend(q, k, v, q_chunk=cfg.q_chunk)
    out["attention_ms"] = {
        "causal_attend": event_ms(torch, lambda: attend(q, k, v, q_chunk=cfg.q_chunk)),
        "sdpa": event_ms(torch, sdpa),
        "max_abs_diff": (ref - sdpa().transpose(1, 2)).abs().max().item()}
    log(f"train (b): one layer's attention forward at ({b}, {s}, {h}/{kvh}, {hd}) f32: "
        f"causal_attend {out['attention_ms']['causal_attend']:.3f} ms, SDPA (a yardstick the "
        f"port does not call) {out['attention_ms']['sdpa']:.3f} ms, max abs diff "
        f"{out['attention_ms']['max_abs_diff']:.2e}")
    return out


def event_ms(torch, fn, reps=10):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_train_olmo(torch, np, tr, get, smi, dev):
    """10(c): OLMo-1B at full width (tied embeddings, non-parametric
    LayerNorm), the port's seeded init: finite losses, the tied table
    trained."""
    cfg, ol = get("olmo_1b"), TRAIN_OLMO
    model = train_model(np, tr, cfg, dev)
    embed0 = model.embed.detach().norm().item()
    step, state = train_steps(tr, model)
    losses, secs = [], []
    for b in train_batches(tr, cfg, ol["batch"], ol["seq"], ol["steps"]):
        t0 = time.perf_counter()
        state, m = step(state, tr["batch_to_device"](b, dev))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    moved = abs(model.embed.detach().norm().item() - embed0)
    rec = {"losses": losses, "s_per_step": secs, "embed_norm_moved": moved,
           "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
           "params": sum(p.numel() for p in model.parameters())}
    log(f"train (c): OLMo-1B full width ({rec['params']} params), batch {ol['batch']} x "
        f"{ol['seq']}: losses {losses}, s/step {[round(x, 3) for x in secs]}, tied embedding "
        f"norm moved {moved:.3e}, torch.cuda.max_memory_allocated "
        f"{rec['max_memory_allocated_mb']:.1f} MB; {smi}")
    if not (np.isfinite(losses).all() and moved > 0 and not hasattr(model, "head")):
        raise AssertionError(f"train (c): {rec}")
    return rec


def phase_train_launch(torch, np, tr, dev):
    """10(d): ``python -m repro_torch.launch.train`` as a subprocess with a
    checkpoint; the same run in this process; each checkpoint loaded into a
    fresh model with the port's load_pytree: the in-process one gives its
    trained model's logits exactly, the launcher's within
    TRAIN_LAUNCH_ATOL."""
    out_dir = ROOT / "build" / "train_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_launch, ckpt_here = out_dir / "launch.npz", out_dir / "here.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN_LAUNCH,
                           "--ckpt", str(ckpt_launch)], env=env, capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    launch_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train (d): the launcher exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    log(f"train (d): launcher exited 0 in {launch_s:.1f} s: "
        + " | ".join(proc.stdout.strip().splitlines()))
    trained = tr["launch_main"]([*TRAIN_LAUNCH, "--ckpt", str(ckpt_here)])
    rng = np.random.default_rng(TRAIN_SEED)
    cfg = trained.cfg
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)), device=dev),
             "task_ids": torch.arange(4, device=dev) % cfg.num_tasks}
    with torch.no_grad():
        want = trained.forward(batch)[0]
    diffs = {}
    for name, path in (("here", ckpt_here), ("launch", ckpt_launch)):
        fresh = tr["TransformerLM"](cfg, device=dev, seed=7)
        tree, step = tr["load_pytree"](str(path), tr["convert"].params_to_numpy(fresh))
        tr["convert"].load_numpy_params(fresh, tree)
        with torch.no_grad():
            diffs[name] = (fresh.forward(batch)[0] - want).abs().max().item()
        if step != 3:
            raise AssertionError(f"train (d): {name} checkpoint at step {step}")
        del fresh, tree
    log(f"train (d): logits of fresh models from the checkpoints against the trained model's: "
        f"in-process {diffs['here']:.3e}, launcher's {diffs['launch']:.3e} "
        f"(limits 0 and {TRAIN_LAUNCH_ATOL})")
    if diffs["here"] != 0.0 or not diffs["launch"] <= TRAIN_LAUNCH_ATOL:
        raise AssertionError(f"train (d): checkpoint logits differ: {diffs}")
    for path in (ckpt_launch, ckpt_here):
        path.unlink()
    return {"launch_s": launch_s, "logits_diff": diffs}


def phase_train_serve(torch, np, tr, get, ContinuousBatcher, Request, ops, dev):
    """10(e): a batcher captured (CUDA graphs, kernel backend) before
    training serves after 2 train steps with no recapture: the same greedy
    tokens as a fresh batcher on the trained weights (every logits row
    within GRAPH_TOL), as the plain path (margin rule), some logits moved
    by training, every parameter's data_ptr unchanged."""
    cfg = get("multitask_lm")
    model = train_model(np, tr, cfg, dev)
    rng = np.random.default_rng(TRAIN_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in TRAIN_SERVE_LENS]
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    rows: dict = {}

    def keep(req, row):
        rows[(req.uid, len(req.out))] = row.copy()
        return int(np.argmax(row))

    def serve(bt, base):
        for i, (p, t) in enumerate(zip(prompts, TRAIN_SERVE_TASKS)):
            bt.submit(Request(uid=base + i, tokens=p, max_new=NEW, task_id=t))
        done = {r.uid: r.out for r in bt.run()}
        return [done[base + i] for i in range(len(prompts))]

    kw = dict(num_slots=4, max_seq=1024, prefill_chunk=32, sample_fn=keep)
    early = ContinuousBatcher(model, **kw)
    before = serve(early, 0)
    captures = early.captures
    step, state = train_steps(tr, model)
    for b in train_batches(tr, cfg, 8, 128, 2):
        state, _ = step(state, tr["batch_to_device"](b, dev))
    del step, state
    torch.cuda.synchronize()
    zero_counts(ops)
    after = serve(early, 100)
    torch.cuda.synchronize()
    launches = read_counts(ops)
    fresh = ContinuousBatcher(model, **kw)
    want = serve(fresh, 200)
    fresh.close()
    early.close()
    n = len(prompts)
    graph_diff = max(float(np.abs(rows[(100 + i, t)] - rows[(200 + i, t)]).max())
                     for i in range(n) for t in range(NEW))
    moved = max(float(np.abs(rows[(100 + i, t)] - rows[(i, t)]).max())
                for i in range(n) for t in range(NEW))
    changed = sum(a != b for x, y in zip(after, before) for a, b in zip(x, y))
    log(f"train (e): a batcher captured before training ({captures} graphs) served after 2 "
        f"steps with {early.captures} graphs: tokens == a fresh batcher's: {after == want}; "
        f"logits rows max abs diff {graph_diff:.3e} (limit {GRAPH_TOL}); training moved the "
        f"logits by up to {moved:.3e} and changed {changed}/{n * NEW} tokens; launches {launches}")
    if captures != 2 or early.captures != 2:
        raise AssertionError(f"train (e): {early.captures} captures, want 2 and no recapture")
    if after != want or not graph_diff <= GRAPH_TOL:
        raise AssertionError("train (e): the replay after training differs from a fresh capture")
    if not moved > TRAIN_MOVED:
        raise AssertionError(f"train (e): training moved no logit by {TRAIN_MOVED}")
    if {nm: p.data_ptr() for nm, p in model.named_parameters()} != ptrs:
        raise AssertionError("train (e): a parameter moved in memory during training")
    per = {nm: launches[nm] for nm in ("decode_attention", "prefill_attention")}
    if (min(per.values()) == 0 or any(c % cfg.num_layers for c in per.values())
            or launches["paged_decode_attention"] or launches["paged_prefill_attention"]
            or launches["graph_mix"]):
        raise AssertionError(f"train (e): launches {launches}")
    ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request,
                             task_ids=TRAIN_SERVE_TASKS)
    compared = compare("train (e)", "plain path", after, ref, margins, NEW)
    return {"launches": launches, "graph_logits_diff": graph_diff, "logits_moved": moved,
            "tokens_changed_by_training": changed, "plain_compared": compared}


def phase_train(torch, np, tr, get, ContinuousBatcher, Request, ops, smi,
                dev="cuda"):
    """Phase 10: training (see the docstring). ``dev`` "cpu" rehearses it
    off the card (smoke configs through ``get``, the card's calls patched)."""
    t_phase = time.perf_counter()
    free_card(torch)
    model, lockstep = phase_train_lockstep(torch, np, tr, get("multitask_lm"), dev)
    speed = phase_train_speed(torch, np, tr, model, smi, dev)
    del model
    free_card(torch)
    olmo = phase_train_olmo(torch, np, tr, get, smi, dev)
    free_card(torch)
    launch = phase_train_launch(torch, np, tr, dev)
    free_card(torch)
    serve = phase_train_serve(torch, np, tr, get, ContinuousBatcher, Request, ops, dev)
    free_card(torch)
    secs = time.perf_counter() - t_phase
    log(f"train: phase passed in {secs:.1f} s")
    return {"device": smi, "lockstep": lockstep, "speed": speed, "olmo_1b": olmo,
            "launch": launch, "serve": serve, "seconds": secs}


def profile_ticks(torch, np, phase, model, ContinuousBatcher, Request, max_seq, lens,
                  layers=0):
    """8 graph decode ticks after an admission round of ``lens`` prompts
    (64 new each), profiled: device ms per tick against the byte bound of
    ``decode_tick_bound``; ``layers`` attention-kernel launches a tick."""
    cfg = model.cfg

    def setup():
        rng = np.random.default_rng(1)
        bt = ContinuousBatcher(model, num_slots=4, max_seq=max_seq, prefill_chunk=32)
        for uid, n in enumerate(lens):
            bt.submit(Request(uid=uid, tokens=prompt_tokens(np, rng, cfg, n), max_new=64))
        bt.capture()
        return _admitted(bt)

    prof = profile_window(torch, f"8 decode ticks ({phase})", setup, _ticks, True,
                          layers=layers)
    # positions of the window's ticks: after admission and one tick, 8 more
    bound_ms, nbytes, parts = decode_tick_bound(model, [n + 5 for n in lens])
    tick_ms = prof["device_busy_ms"] / 8
    log(f"{phase}: decode tick device time {tick_ms:.3f} ms (host wall "
        f"{prof['wall_ms'] / 8:.3f} ms) against its bound {bound_ms:.3f} ms "
        f"({nbytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in parts.items())
        + f"): {bound_ms / tick_ms:.1%} of the bound")
    return {"device_ms": tick_ms, "wall_ms": prof["wall_ms"] / 8, "bound_ms": bound_ms,
            "bound_bytes": nbytes, "bound_parts": parts, "profile": prof}


def train_family(torch, np, tr, phase, cfg, smi, dev, mt, watched=(), aux=False):
    """``mt["steps"]`` steps of make_train_step with SGD and the graph-mixed
    update on a fresh model of ``cfg``: finite loss (and, with ``aux``,
    finite positive aux), every ``watched`` parameter moved; ms per step
    and peak memory logged. Returns the record."""
    model = tr["TransformerLM"](cfg, device=dev, seed=0)
    opt = tr["sgd"](mt["lr"])
    gmt = tr["GraphMultiTask"](tr["band_graph"](cfg.num_tasks, 1), eta=TRAIN_ETA,
                               tau=TRAIN_TAU)
    step, state = tr["make_train_step"](model, opt, gmt), tr["init_state"](model, opt)
    before = {n: model.get_parameter(n).detach().clone() for n in watched}
    torch.cuda.reset_peak_memory_stats()
    rec = {"ms": [], "loss": [], "aux": []}
    for b in train_batches(tr, cfg, mt["batch"], mt["seq"], mt["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, tr["batch_to_device"](b, dev))
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["loss"].append(float(m["loss"]))
        rec["aux"].append(float(m["aux"]))
    rec["moved"] = {n: (model.get_parameter(n).detach() - before[n]).abs().max().item()
                    for n in watched}
    rec["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    rec["params"] = sum(p.numel() for p in model.parameters())
    log(f"{phase} train (d): {cfg.name} full width, {cfg.num_layers} layers "
        f"({rec['params']} params, remat {cfg.remat}), SGD lr {mt['lr']}, batch "
        f"{mt['batch']} x {mt['seq']}: ms/step {rec['ms']}, loss {rec['loss']}, aux "
        f"{rec['aux']}, largest change of {rec['moved']}, torch.cuda.max_memory_allocated "
        f"{rec['peak_mb']:.1f} MB; {smi}")
    ok = np.isfinite(rec["loss"]).all() and np.isfinite(rec["aux"]).all()
    if aux:
        ok = ok and min(rec["aux"]) > 0
    if not (ok and all(v > 0 for v in rec["moved"].values())):
        raise AssertionError(f"{phase} train (d): {rec}")
    del model, step, state
    free_card(torch)
    return rec


MOE_LAYERS = 4  # of Mixtral-8x22B's 56: ~10.0 GB of f32 weights a layer, ~41.7 GB in all
MOE_MAX_SEQ = 8192
MOE_LENS = [4500, 700, 64, 413, 257, 590]  # the 4500-token prompt crosses the 4096 window
MOE_PROFILE_LENS = (700, 300, 500, 100)
MOE_MODES_LENS = [64, 100]
PHI4_LENS = [700, 64, 413, 257]
MOE_TRAIN = {"batch": 2, "seq": 256, "steps": 2, "lr": 1e-2}


def decode_tick_bound(model, positions):
    """Least device ms of one decode tick at HBM bandwidth: every weight read
    once per use (an untied embedding table only at the rows it gathers; an
    MoE layer's capacity dispatch reads every expert whatever the routing; a
    hybrid's shared block, far past the 50 MB L2, once per invocation), each
    recurrent state (mamba, mLSTM, sLSTM) read and written, and each slot's
    visible cache rows in every attention layer (K and V; MLA's latent and
    rotary key). Returns (ms, bytes, bytes by part)."""
    cfg = model.cfg
    invocations = model.kinds.count("shared_attn")
    weights = shared = 0
    for n, p in model.named_parameters():
        if n == "embed" and not cfg.tie_embeddings:
            continue
        if n.startswith("shared_attn."):
            shared += p.numel() * p.element_size() * invocations
        else:
            weights += p.numel() * p.element_size()
    if not cfg.tie_embeddings:  # one row a slot, one a codebook for audio
        weights += (len(positions) * cfg.num_codebooks * cfg.d_model
                    * model.embed.element_size())
    # one slot's state and one cache row of every layer: the (1, 1, ...) cache
    one = [(kind in ("mamba", "mlstm", "slstm"), sum(t.nbytes for t in entry))
           for kind, entry in zip(model.kinds, model.init_cache(1, 1))]
    states = 2 * len(positions) * sum(n for recurrent, n in one if recurrent)
    window = cfg.sliding_window or max(positions) + 1
    rows = sum(min(p + 1, window) for p in positions)
    kv = rows * sum(n for recurrent, n in one if not recurrent)
    parts = {"weights": weights, "shared_block": shared, "states": states, "kv": kv}
    nbytes = sum(parts.values())
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, parts


def window_effect(np, model, prompt, ContinuousBatcher, Request):
    """The first-token logits of ``prompt`` (longer than the window) served
    alone, with the config's sliding window and without one: the largest
    difference, which must show that the window masked on the card."""
    saved, rows = model.cfg, []
    try:
        for window in (saved.sliding_window, None):
            model.cfg = dataclasses.replace(saved, sliding_window=window)

            def keep(req, row):
                rows.append(row.copy())
                return int(np.argmax(row))

            bt = ContinuousBatcher(model, num_slots=4, max_seq=MOE_MAX_SEQ, prefill_chunk=32,
                                   sample_fn=keep)
            bt.submit(Request(uid=0, tokens=prompt, max_new=1))
            bt.run()
            bt.close()
    finally:
        model.cfg = saved
    return float(np.abs(rows[0] - rows[1]).max())


def phase_moe_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request, PagingSpec,
                    ops):
    """11(a), (b): Mixtral-8x22B at full width and MOE_LAYERS layers."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in MOE_LENS]
    kw = dict(max_seq=MOE_MAX_SEQ, prefill_chunk=32, num_slots=4)
    out = {}
    launches = {}
    for layout, extra in (("dense", {}),
                          ("paged", {"paging": PagingSpec.sized(16, MOE_MAX_SEQ,
                                                                4 * MOE_MAX_SEQ)})):
        phase = f"moe {layout}"
        engine = ServeEngine(model, **kw, **extra)
        toks, launched, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops)
        st = engine.last_stats
        check_launches(phase, launched, st, paged=layout == "paged", layers=cfg.num_layers)
        check_tokens(phase, toks, len(prompts), NEW, cfg.vocab_size)
        rates = report_rates(phase, st, len(prompts), NEW, ttft, wall)
        rates["eager"] = eager_parity(torch, phase, ServeEngine(model, cuda_graphs=False, **kw,
                                                                **extra),
                                      prompts, NEW, ops, toks)
        if layout == "dense":
            rates["logits_diff_graph_vs_eager"] = logits_parity(
                np, phase, model, ContinuousBatcher, Request, prompts, max_seq=MOE_MAX_SEQ)
            ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request,
                                     max_seq=MOE_MAX_SEQ)
            compare(phase, "plain path", toks, ref, margins, NEW)
            dense_toks = toks
        else:
            compare(phase, "dense kernel path", toks, dense_toks, margins, NEW)
        for name, n in launched.items():
            launches[name] = launches.get(name, 0) + n
        out[layout] = rates
    diff = window_effect(np, model, prompts[0], ContinuousBatcher, Request)
    log(f"moe: the {MOE_LENS[0]}-token request's first-token logits with the "
        f"{cfg.sliding_window}-token window vs without: max abs diff {diff:.3e}")
    if not diff > MARGIN:
        raise AssertionError(f"moe: the sliding window changed the logits by only {diff}")
    out["window_logits_diff"] = diff

    out["decode_tick"] = profile_ticks(torch, np, "moe", model, ContinuousBatcher, Request,
                                       MOE_MAX_SEQ, MOE_PROFILE_LENS, layers=cfg.num_layers)

    # (b) dropless capacity: the parallel chunk and the per-token scan route alike
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, capacity_factor=float(saved.num_experts))
    try:
        rng = np.random.default_rng(2)
        short = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in MOE_MODES_LENS]
        par, margins = greedy_run(np, model, short, NEW, ContinuousBatcher, Request)
        scan, _ = greedy_run(np, model, short, NEW, ContinuousBatcher, Request,
                             prefill_mode="scan")
        out["modes_compared"] = compare("moe modes", "the scan prefill", par, scan, margins,
                                        NEW)
    finally:
        model.cfg = saved
    return out, launches


def phase_moe(torch, np, tr, get, TransformerLM, ServeEngine, ContinuousBatcher, Request,
              PagingSpec, ops, smi, dev="cuda"):
    """Phase 11: the MoE family, phi4-mini, and an MoE train step (see the
    docstring). ``dev`` "cpu" rehearses it off the card (smoke configs
    through ``get``, the card's calls patched)."""
    t_phase = time.perf_counter()
    free_card(torch)
    out = {"memory_mb_before": log_memory(torch, "moe (before)")}
    cfg = dataclasses.replace(get("mixtral_8x22b"), num_layers=MOE_LAYERS)
    t1 = time.perf_counter()
    model = TransformerLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    out["params"] = sum(p.numel() for p in model.parameters())
    log(f"moe: Mixtral-8x22B full width, {cfg.num_layers} of 56 layers ({out['params']} "
        f"params, f32, {torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    serve, launches = phase_moe_serve(torch, np, model, ServeEngine, ContinuousBatcher,
                                      Request, PagingSpec, ops)
    out["serve"] = serve
    out["serve_peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    log(f"moe: serving peak torch.cuda.max_memory_allocated {out['serve_peak_mb']:.1f} MB")
    del model
    free_card(torch)

    # (c) phi4-mini at full width: tied embeddings at vocab 200064
    model = TransformerLM(get("phi4_mini_3_8b"), device=dev, seed=0)
    pcfg = model.cfg
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, pcfg.vocab_size, n).astype(np.int32) for n in PHI4_LENS]
    engine = ServeEngine(model, max_seq=1024, prefill_chunk=32, num_slots=4)
    toks, launched, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops)
    st = engine.last_stats
    check_launches("phi4", launched, st, paged=False, layers=pcfg.num_layers)
    check_tokens("phi4", toks, len(prompts), NEW, pcfg.vocab_size)
    out["phi4"] = report_rates("phi4", st, len(prompts), NEW, ttft, wall)
    out["phi4"]["params"] = sum(p.numel() for p in model.parameters())
    ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request)
    out["phi4"]["compared"] = compare("phi4", "plain path", toks, ref, margins, NEW)
    for name, n in launched.items():
        launches[name] += n
    del model, engine
    free_card(torch)

    # (d) SGD steps of Mixtral at full width, one layer
    out["train"] = train_family(
        torch, np, tr, "moe", dataclasses.replace(get("mixtral_8x22b"), num_layers=1), smi,
        dev, MOE_TRAIN, watched=("layers.0.moe.router", "task.router_bias"), aux=True)
    out["memory_mb_after"] = log_memory(torch, "moe (after)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"moe: phase passed in {out['seconds']:.1f} s")
    return out, launches


# ------------------------------------------------- phase 12: the hybrid
HYBRID_MAX_SEQ = 2048
# 6 over 4 slots: requests 4 and 5 reuse slots. Halved from 64..1200 to keep
# the whole smoke inside its 1200 s budget as phase 19 grew: the eager
# cells of phases 12-16 prefill these prompts at 100-460 tok/s
HYBRID_LENS = [64, 150, 350, 600, 128, 295]
HYBRID_REUSED = (4, 5)
HYBRID_PROFILE_LENS = (700, 300, 500, 100)
HYBRID_HOG, HYBRID_SHORT = (700, 64), (413, 16)  # (prompt, new): 48 + 27 blocks of 16
HYBRID_TIGHT_POOL = 1024  # tokens: 63 blocks of 16 hold the hog or the short, not both


def phase_hybrid_serve(torch, np, model, ServeEngine, ContinuousBatcher, Request, PagingSpec,
                       ops):
    """12(a)-(c): Zamba2-7B served dense and paged, graphs, eager, plain."""
    cfg = model.cfg
    layers = model.kinds.count("shared_attn")  # attention launches per dispatch
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in HYBRID_LENS]
    kw = dict(max_seq=HYBRID_MAX_SEQ, prefill_chunk=32, num_slots=4)
    out, launches = {}, {}
    for layout, extra in (("dense", {}),
                          ("paged", {"paging": PagingSpec.sized(16, HYBRID_MAX_SEQ,
                                                                4 * HYBRID_MAX_SEQ)})):
        phase = f"hybrid {layout}"
        engine = ServeEngine(model, **kw, **extra)
        toks, launched, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops)
        st = engine.last_stats
        check_launches(phase, launched, st, paged=layout == "paged", layers=layers)
        check_tokens(phase, toks, len(prompts), NEW, cfg.vocab_size)
        rates = report_rates(phase, st, len(prompts), NEW, ttft, wall)
        rates["eager"] = eager_parity(torch, phase, ServeEngine(model, cuda_graphs=False, **kw,
                                                                **extra),
                                      prompts, NEW, ops, toks)
        if layout == "dense":
            rates["logits_diff_graph_vs_eager"] = logits_parity(
                np, phase, model, ContinuousBatcher, Request, prompts, max_seq=HYBRID_MAX_SEQ)
            ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request,
                                     max_seq=HYBRID_MAX_SEQ)
            rates["plain_compared"] = compare(phase, "plain path", toks, ref, margins, NEW)
            dense_toks = toks
            # the requests admitted into reused slots, each alone in a fresh batcher
            alone = [greedy_run(np, model, [prompts[u]], NEW, ContinuousBatcher, Request,
                                max_seq=HYBRID_MAX_SEQ)
                     for u in HYBRID_REUSED]
            rates["reuse_compared"] = compare(
                "hybrid reuse", "a fresh batcher", toks[list(HYBRID_REUSED)],
                [a[0][0] for a in alone], [a[1][0] for a in alone], NEW)
        else:
            rates["dense_compared"] = compare(phase, "dense kernel path", toks, dense_toks,
                                              margins, NEW)
        for name, n in launched.items():
            launches[name] = launches.get(name, 0) + n
        out[layout] = rates

    out["decode_tick"] = profile_ticks(torch, np, "hybrid", model, ContinuousBatcher,
                                       Request, HYBRID_MAX_SEQ, HYBRID_PROFILE_LENS,
                                       layers=layers)
    return out, launches


def phase_hybrid_preempt(torch, np, model, ContinuousBatcher, Request, PagingSpec, ops):
    """12(d): one preemption of a priority-10 hog in a pool too small for it
    and a priority-0 request: one swap-out (pages and the hog's recurrent
    columns) and one swap-in; tokens equal a roomy pool's."""
    cfg = model.cfg
    layers = model.kinds.count("shared_attn")
    rng = np.random.default_rng(4)
    hog, short = (rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                  for n in (HYBRID_HOG[0], HYBRID_SHORT[0]))
    launches = {name: 0 for name in COUNTED}

    def pressure(pool_tokens, preempt):
        bt = ContinuousBatcher(model, num_slots=2, max_seq=HYBRID_MAX_SEQ, prefill_chunk=32,
                               paging=PagingSpec.sized(16, HYBRID_MAX_SEQ, pool_tokens),
                               policy="priority", preempt=preempt)
        ptrs = [t.data_ptr() for entry in bt.caches for t in entry]
        on_card = bt.caches[0][0].is_cuda
        outs, ins = [], []
        if preempt:
            bt._swap_out_fn = timed_swap(torch, bt._swap_out_fn, outs)
            bt._swap_in_fn = timed_swap(torch, bt._swap_in_fn, ins)
        torch.cuda.synchronize()
        zero_counts(ops)
        reqs = [Request(uid=0, tokens=hog, max_new=HYBRID_HOG[1], priority=10),
                Request(uid=1, tokens=short, max_new=HYBRID_SHORT[1], priority=0)]
        bt.submit(reqs[0])
        bt.step()
        bt.step()
        bt.submit(reqs[1])
        bt.run()
        torch.cuda.synchronize()
        launched = read_counts(ops)
        name = f"hybrid (preemption, {pool_tokens}-token pool)"
        check_launches(name, launched, batcher_stats(bt), paged=True, layers=layers)
        for k, n in launched.items():
            launches[k] += n
        summary = bt.check_invariants()
        moved = ptrs != [t.data_ptr() for entry in bt.caches for t in entry]
        bt.close()
        log(f"{name}: swap_outs {bt.swap_outs}, swap_ins {bt.swap_ins}, hog preemptions "
            f"{reqs[0].preemptions}; check_invariants {summary}; caches moved {moved}")
        if moved or summary["live_slots"] or summary["queued"] or summary["live_refs"]:
            raise AssertionError(f"{name}: caches moved {moved} or invariants {summary}")
        if preempt and ((bt.swap_outs, bt.swap_ins, reqs[0].preemptions) != (1, 1, 1)
                        or not all(pinned or not on_card for *_, pinned in outs + ins)):
            raise AssertionError(f"{name}: swap_outs {bt.swap_outs}, swap_ins {bt.swap_ins}, "
                                 f"preemptions {reqs[0].preemptions}, pinned "
                                 f"{[p for *_, p in outs + ins]}")
        return [list(r.out) for r in reqs], outs, ins

    want, _, _ = pressure(2 * HYBRID_MAX_SEQ, False)
    got, ((out_s, shape, nbytes, _),), ((in_s, *_),) = pressure(HYBRID_TIGHT_POOL, True)
    if got != want:
        raise AssertionError("hybrid (preemption): tokens differ from the roomy pool's")
    log(f"hybrid (preemption): tokens == the roomy pool's on both requests; snapshot pages "
        f"{shape} and the hog's recurrent columns, {nbytes / 2**20:.1f} MiB pinned; "
        f"synchronized swap-out {out_s * 1e3:.2f} ms, swap-in {in_s * 1e3:.2f} ms")
    return {"swap_out_ms": out_s * 1e3, "swap_in_ms": in_s * 1e3,
            "snapshot_mib": nbytes / 2**20}, launches


HYBRID_TRAIN = {"batch": 2, "seq": 256, "steps": 2, "lr": 1e-2}
HYBRID_TRAIN_PEAK_GB = 75  # f32 weights + gradients + activations the step allows itself
HYBRID_HOST_LAYERS = 2  # 12(e)'s card-vs-host step: one mamba2 layer + the shared block
HYBRID_HOST_RTOL = 1e-4
HYBRID_WATCHED = ("layers.0.mamba.a_log", "layers.0.mamba.dt_bias", "layers.0.mamba.conv_w",
                  "shared_attn.attn.wq", "shared_attn.mlp.wo")


def hybrid_train_gb(cfg, model):
    """The 12(e) step's memory, GB: f32 weights and their gradients, and
    the remat boundaries plus one layer's chunked-SSD work in flight."""
    params = sum(p.numel() for p in model.parameters())
    tokens = HYBRID_TRAIN["batch"] * HYBRID_TRAIN["seq"]
    d_inner = 2 * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    acts = cfg.num_layers * tokens * cfg.d_model + 8 * tokens * cfg.mamba_chunk * heads
    return 4 * (2 * params + acts) / 1e9


def phase_hybrid_train(torch, np, tr, model, smi, dev="cuda"):
    """12(e): make_train_step with SGD and the graph-mixed update on the
    phase's Zamba2 at full width (depth cut, and the cut logged, only if
    the step's memory would pass HYBRID_TRAIN_PEAK_GB), HYBRID_TRAIN["steps"]
    steps of 2 x 256, remat on: finite loss, a_log, dt_bias, conv_w and the
    shared block's weights moved; ms per step and peak memory logged. Then
    a 2-layer Zamba2 at full width (a mamba2 layer and the shared block):
    the card's first-step loss within HYBRID_HOST_RTOL of the same port
    step on the host CPU (the same weights and batch). Returns the record."""
    cfg = model.cfg
    est = hybrid_train_gb(cfg, model)
    if est > HYBRID_TRAIN_PEAK_GB:  # a fresh, shallower model; never a narrower one
        full = cfg.num_layers
        while (cfg.num_layers > len(cfg.pattern)
               and est * cfg.num_layers / full > HYBRID_TRAIN_PEAK_GB):
            cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
        log(f"hybrid train (e): depth cut to {cfg.num_layers} of {full} layers: the step "
            f"would need ~{est:.1f} GB")
        model.to("meta")  # the serving model's memory, before the shallower one's
        model = tr["TransformerLM"](cfg, device=dev, seed=0)
    else:
        log(f"hybrid train (e): full depth ({cfg.num_layers} layers), the step needs "
            f"~{est:.1f} GB of {HYBRID_TRAIN_PEAK_GB}: no cut")
    opt = tr["sgd"](HYBRID_TRAIN["lr"])
    gmt = tr["GraphMultiTask"](tr["band_graph"](cfg.num_tasks, 1), eta=TRAIN_ETA,
                               tau=TRAIN_TAU)
    step, state = tr["make_train_step"](model, opt, gmt), tr["init_state"](model, opt)
    before = {n: model.get_parameter(n).detach().clone() for n in HYBRID_WATCHED}
    free_card(torch)
    rec = {"ms": [], "loss": [], "layers": cfg.num_layers, "remat": cfg.remat,
           "estimate_gb": est}
    for b in train_batches(tr, cfg, HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"],
                           HYBRID_TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, tr["batch_to_device"](b, dev))
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["loss"].append(float(m["loss"]))
    rec["moved"] = {n: (model.get_parameter(n).detach() - before[n]).abs().max().item()
                    for n in HYBRID_WATCHED}
    rec["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    log(f"hybrid train (e): Zamba2-7B full width, {cfg.num_layers} layers, remat {cfg.remat}, "
        f"SGD lr {HYBRID_TRAIN['lr']} + the graph-mixed update, batch {HYBRID_TRAIN['batch']} "
        f"x {HYBRID_TRAIN['seq']}: ms/step {rec['ms']}, loss {rec['loss']}, largest change of "
        f"{rec['moved']}, torch.cuda.max_memory_allocated {rec['peak_mb']:.1f} MB; {smi}")
    if not (np.isfinite(rec["loss"]).all() and all(v > 0 for v in rec["moved"].values())):
        raise AssertionError(f"hybrid train (e): {rec}")
    del step, state, before, model
    free_card(torch)
    # the card against the host CPU on 2 layers, the same weights and batch
    small = dataclasses.replace(cfg, num_layers=HYBRID_HOST_LAYERS,
                                pattern=("mamba", "shared_attn"))
    host = tr["TransformerLM"](small, device="cpu", seed=0)
    card = tr["TransformerLM"](small, device=dev, seed=1)
    card.load_state_dict(host.state_dict())
    batch = train_batches(tr, small, HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"], 1)[0]
    first = {}
    for where, m_ in (("card", card), ("host", host)):
        opt = tr["sgd"](HYBRID_TRAIN["lr"])
        gmt = tr["GraphMultiTask"](tr["band_graph"](small.num_tasks, 1), eta=TRAIN_ETA,
                                   tau=TRAIN_TAU)
        st = tr["init_state"](m_, opt)
        t0 = time.perf_counter()
        _, met = tr["make_train_step"](m_, opt, gmt)(
            st, tr["batch_to_device"](batch, m_.device))
        first[where] = float(met["loss"])
        first[f"{where}_s"] = time.perf_counter() - t0
    rel = abs(first["card"] - first["host"]) / abs(first["host"])
    rec["host_check"] = dict(first, rel_diff=rel, layers=HYBRID_HOST_LAYERS)
    log(f"hybrid train (e): {HYBRID_HOST_LAYERS}-layer Zamba2 at full width (mamba2 + the "
        f"shared block): first-step loss on the card {first['card']:.7f} ({first['card_s']:.2f} "
        f"s), on the host CPU {first['host']:.7f} ({first['host_s']:.2f} s): relative "
        f"difference {rel:.2e} (limit {HYBRID_HOST_RTOL})")
    if not rel <= HYBRID_HOST_RTOL:
        raise AssertionError(f"hybrid train (e): card vs host {rec['host_check']}")
    del host, card
    free_card(torch)
    return rec


def phase_hybrid(torch, np, tr, get, TransformerLM, ServeEngine, ContinuousBatcher, Request,
                 PagingSpec, ops, smi, dev="cuda"):
    """Phase 12: Zamba2-7B at full width and depth (see the docstring).
    ``dev`` "cpu" rehearses it off the card (a smoke config through
    ``get``, the card's calls patched)."""
    t_phase = time.perf_counter()
    free_card(torch)
    out = {"memory_mb_before": log_memory(torch, "hybrid (before)")}
    t1 = time.perf_counter()
    model = TransformerLM(get("zamba2_7b"), device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    out["params"] = sum(p.numel() for p in model.parameters())
    log(f"hybrid: Zamba2-7B full width and depth ({cfg.num_layers} layers: "
        f"{model.kinds.count('mamba')} mamba, {model.kinds.count('shared_attn')} invocations "
        f"of one shared block; {out['params']} params, f32, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    serve, launches = phase_hybrid_serve(torch, np, model, ServeEngine, ContinuousBatcher,
                                         Request, PagingSpec, ops)
    out["serve"] = serve
    out["preemption"], more = phase_hybrid_preempt(torch, np, model, ContinuousBatcher,
                                                   Request, PagingSpec, ops)
    for name, n in more.items():
        launches[name] = launches.get(name, 0) + n
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    log(f"hybrid: peak torch.cuda.max_memory_allocated {out['peak_mb']:.1f} MB; {smi}")
    out["train"] = phase_hybrid_train(torch, np, tr, model, smi, dev)
    del model
    free_card(torch)
    out["memory_mb_after"] = log_memory(torch, "hybrid (after)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"hybrid: phase passed in {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------- phase 13: MLA (DeepSeek)
MLA_LAYERS = 4  # of DeepSeek-V2's 60: ~16.2 GB of f32 weights a layer, ~69.0 GB in all
MLA_MAX_SEQ = 2048
MLA_LENS = HYBRID_LENS  # 6 requests over 4 slots
MLA_PROFILE_LENS = HYBRID_PROFILE_LENS
MLA_TRAIN = {"batch": 2, "seq": 256, "steps": 2, "lr": 1e-2}


def prompt_tokens(np, rng, cfg, n):
    """A random prompt of ``n`` positions: (n,) ids, or an audio model's
    (n, K) codebook rows."""
    shape = (n, cfg.num_codebooks) if cfg.input_mode == "audio" else (n,)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def serve_family(torch, np, phase, model, ServeEngine, ContinuousBatcher, Request, ops,
                 max_seq, lens, layouts, reused=(), layers=0, extras=None, prompts=None):
    """The requests of ``lens`` (or the given ``prompts``, with a VLM's
    per-request ``extras``) through the engine in each (layout, engine
    kwargs) of ``layouts``, with CUDA graphs and eagerly: ``layers``
    attention-kernel launches per dispatch (0 for a model with no GQA
    layer, whose plain backend runs the same code), graph tokens == eager
    tokens; for the first layout the step logits with graphs within
    GRAPH_TOL of eager, and the ``reused`` requests, each alone in a fresh
    batcher, under the margin rule; each later layout against the first
    under the margin rule of a plain run, which the first layout's tokens
    meet too. An audio model's steps are rows of K tokens, its rates
    frames per second. Returns ({layout: rates}, launches, the first
    layout's tokens)."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    if prompts is None:
        prompts = [prompt_tokens(np, rng, cfg, n) for n in lens]
    unit = "frames" if cfg.input_mode == "audio" else "tok"
    kw = dict(max_seq=max_seq, prefill_chunk=32, num_slots=4)
    out, launches, first = {}, {}, None
    for layout, extra in layouts:
        name = f"{phase} {layout}"
        engine = ServeEngine(model, **kw, **extra)
        toks, launched, ttft, wall = serve_timed(torch, engine, prompts, NEW, ops,
                                                 extras=extras)
        st = engine.last_stats
        check_launches(name, launched, st, paged="paging" in extra, layers=layers)
        check_tokens(name, toks, len(prompts), NEW, cfg.vocab_size, cfg.num_codebooks)
        rates = report_rates(name, st, len(prompts), NEW, ttft, wall, unit)
        rates["eager"] = eager_parity(torch, name, ServeEngine(model, cuda_graphs=False, **kw,
                                                               **extra),
                                      prompts, NEW, ops, toks, extras=extras, unit=unit)
        if first is None:
            rates["logits_diff_graph_vs_eager"] = logits_parity(
                np, name, model, ContinuousBatcher, Request, prompts, max_seq=max_seq,
                extras=extras, **extra)
            if len(layouts) > 1:  # the margins the later layouts are held under
                ref, margins = plain_run(np, model, prompts, NEW, ContinuousBatcher, Request,
                                         max_seq=max_seq, extras=extras, **extra)
                rates["plain_compared"] = compare(name, "plain path", toks, ref, margins, NEW)
            first = toks
            if reused:
                alone = [greedy_run(np, model, [prompts[u]], NEW, ContinuousBatcher, Request,
                                    max_seq=max_seq,
                                    extras=None if extras is None else [extras[u]], **extra)
                         for u in reused]
                rates["reuse_compared"] = compare(
                    f"{phase} reuse", "a fresh batcher", toks[list(reused)],
                    [a[0][0] for a in alone], [a[1][0] for a in alone], NEW)
        else:
            rates[f"{layouts[0][0]}_compared"] = compare(name, f"{layouts[0][0]} path", toks,
                                                         first, margins, NEW)
        for k, n in launched.items():
            launches[k] = launches.get(k, 0) + n
        out[layout] = rates
    return out, launches, first


def phase_mla(torch, np, tr, get, TransformerLM, ServeEngine, ContinuousBatcher, Request,
              PagingSpec, ops, smi, dev="cuda"):
    """Phase 13: DeepSeek-V2-236B (MLA + MoE) at full width and MLA_LAYERS
    layers, served dense and paged, profiled, and trained one layer deep
    (see the docstring). ``dev`` "cpu" rehearses it off the card (a smoke
    config through ``get``, the card's calls patched)."""
    t_phase = time.perf_counter()
    free_card(torch)
    out = {"memory_mb_before": log_memory(torch, "mla (before)")}
    cfg = dataclasses.replace(get("deepseek_v2_236b"), num_layers=MLA_LAYERS)
    t1 = time.perf_counter()
    model = TransformerLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    out["params"] = sum(p.numel() for p in model.parameters())
    log(f"mla: DeepSeek-V2-236B full width, {cfg.num_layers} of 60 layers (MLA kv_lora "
        f"{cfg.kv_lora}, qk {cfg.qk_nope} + {cfg.qk_rope}, v {cfg.v_head_dim}; "
        f"{cfg.num_experts} routed + {cfg.num_shared_experts} shared experts, top-{cfg.top_k}; "
        f"{out['params']} params, f32, {torch.cuda.memory_allocated() / 1e9:.2f} GB) "
        f"initialised in {time.perf_counter() - t1:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    layouts = (("dense", {}),
               ("paged", {"paging": PagingSpec.sized(16, MLA_MAX_SEQ, 4 * MLA_MAX_SEQ)}))
    out["serve"], launches, _ = serve_family(torch, np, "mla", model, ServeEngine,
                                             ContinuousBatcher, Request, ops, MLA_MAX_SEQ,
                                             MLA_LENS, layouts)
    out["decode_tick"] = profile_ticks(torch, np, "mla", model, ContinuousBatcher, Request,
                                       MLA_MAX_SEQ, MLA_PROFILE_LENS)
    out["serve_peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    log(f"mla: serving peak torch.cuda.max_memory_allocated {out['serve_peak_mb']:.1f} MB; "
        f"{smi}")
    del model
    free_card(torch)
    out["train"] = train_family(
        torch, np, tr, "mla", dataclasses.replace(get("deepseek_v2_236b"), num_layers=1), smi,
        dev, MLA_TRAIN, watched=("layers.0.moe.router", "task.router_bias",
                                 "layers.0.attn.w_uk"), aux=True)
    out["memory_mb_after"] = log_memory(torch, "mla (after)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"mla: phase passed in {out['seconds']:.1f} s")
    return out, launches


# -------------------------------------------------------- phase 14: xLSTM
XLSTM_MAX_SEQ = 2048
XLSTM_LENS = HYBRID_LENS
XLSTM_REUSED = HYBRID_REUSED
XLSTM_PROFILE_LENS = HYBRID_PROFILE_LENS
XLSTM_ADAPTER_RANK = 8
# one step: the sequential cell's step takes 11-20 s at full depth
XLSTM_TRAIN = {"batch": 2, "seq": 128, "steps": 1, "lr": 1e-2}
XLSTM_PARALLEL_RTOL = 1e-4  # 14(e): the chunkwise step's loss against the sequential one's


def xlstm_adapters(torch, np, model, ServeEngine, ContinuousBatcher, Request,
                   TaskAdapterStore, band_graph, tree_lib, ops):
    """14(b): the requests of mixed tenants under a graph-mixed adapter
    store of "out" pairs on every recurrent block (band_graph(num_tasks,
    2), rank XLSTM_ADAPTER_RANK, an update every 2 finishes): the graph-mix
    launches counted; a zero store == no store; the kernel store's trees
    == a plain store's from the same seed after as many updates."""
    cfg = model.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in XLSTM_LENS]
    task_ids = (np.arange(len(prompts)) * 5 % cfg.num_tasks).astype(np.int32)
    graph = band_graph(cfg.num_tasks, 2)
    store_kw = dict(rank=XLSTM_ADAPTER_RANK, update_every=2, max_delay=2, seed=0)

    def engine(store=None):
        return ServeEngine(model, max_seq=XLSTM_MAX_SEQ, prefill_chunk=32, num_slots=4,
                           adapters=store)

    base, _, _, _ = serve_timed(torch, engine(), prompts, NEW, ops, task_ids)
    zero = engine(TaskAdapterStore(model, graph, **store_kw)).generate(
        {"tokens": prompts, "task_ids": task_ids}, NEW)
    if not np.array_equal(zero, base):
        raise AssertionError("xlstm adapters: a zero store changed the no-store tokens")
    log(f"xlstm adapters: zero store == no store on all {base.size} greedy tokens")
    torch.cuda.synchronize()
    zero_counts(ops)
    store = TaskAdapterStore(model, graph, **store_kw)
    store.randomize(scale=ADAPTER_SCALE)
    eng = engine(store)
    toks, launches, ttft, wall = serve_timed(torch, eng, prompts, NEW, ops, task_ids,
                                             zero=False)
    st = eng.last_stats
    n_req = len(prompts)
    check_launches("xlstm adapters", launches, st, paged=False, layers=0,
                   graph_mix=2 + 2 * (n_req // store.update_every))
    check_tokens("xlstm adapters", toks, n_req, NEW, cfg.vocab_size)
    rates = report_rates("xlstm adapters", st, n_req, NEW, ttft, wall)
    raw_mb = sum(t.numel() * t.element_size() for t in tree_lib.leaves(store.raw)) / 1e6
    changed = int((toks != base).sum())
    log(f"xlstm adapters: {sorted(store.raw['stages'][0]['slot0'])} pairs on "
        f"{len(store.raw['stages'][0])} slots x {cfg.num_periods} periods, {cfg.num_tasks} "
        f"tasks, {raw_mb:.1f} MB raw; {store.updates} updates; random adapters changed "
        f"{changed} of {toks.size} tokens against no store")
    with plain_backend(model):  # the same seed, mixed by the plain version
        plain = TaskAdapterStore(model, graph, **store_kw)
        plain.randomize(scale=ADAPTER_SCALE)
        for _ in range(store.updates):
            plain.update()
    atol, rtol = MIX_TOL["float32"]
    worst = 0.0
    for name in ("raw", "serving"):
        for got, want in zip(tree_lib.leaves(getattr(store, name)),
                             tree_lib.leaves(getattr(plain, name))):
            diff = (got - want).abs()
            worst = max(worst, diff.max().item())
            if not bool((diff <= atol + rtol * want.abs()).all()):
                raise AssertionError(f"xlstm adapters: kernel store {name} differs from the "
                                     f"plain store's by {diff.max().item()}")
    log(f"xlstm adapters: kernel store raw and serving == plain store's within atol {atol} "
        f"rtol {rtol} (max abs diff {worst:.2e}) after {store.updates} updates each")
    rates.update(tokens_changed=changed, store_mb=raw_mb, store_max_diff=worst)
    return rates, launches


def phase_xlstm(torch, np, tr, get, TransformerLM, ServeEngine, ContinuousBatcher, Request,
                TaskAdapterStore, band_graph, tree_lib, ops, smi, dev="cuda"):
    """Phase 14: xLSTM-350M whole, served with CUDA graphs and eagerly,
    under an adapter store, profiled and trained (see the docstring).
    ``dev`` "cpu" rehearses it off the card (a smoke config through
    ``get``, the card's calls patched)."""
    t_phase = time.perf_counter()
    free_card(torch)
    out = {"memory_mb_before": log_memory(torch, "xlstm (before)")}
    t1 = time.perf_counter()
    model = TransformerLM(get("xlstm_350m"), device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    out["params"] = sum(p.numel() for p in model.parameters())
    log(f"xlstm: xLSTM-350M full width and depth ({cfg.num_layers} layers: "
        f"{model.kinds.count('mlstm')} mLSTM, {model.kinds.count('slstm')} sLSTM; d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads; {out['params']} params, f32, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    out["serve"], launches, _ = serve_family(torch, np, "xlstm", model, ServeEngine,
                                             ContinuousBatcher, Request, ops, XLSTM_MAX_SEQ,
                                             XLSTM_LENS, (("dense", {}),), XLSTM_REUSED)
    out["adapters"], more = xlstm_adapters(torch, np, model, ServeEngine, ContinuousBatcher,
                                           Request, TaskAdapterStore, band_graph, tree_lib,
                                           ops)
    for k, n in more.items():
        launches[k] = launches.get(k, 0) + n
    out["decode_tick"] = profile_ticks(torch, np, "xlstm", model, ContinuousBatcher, Request,
                                       XLSTM_MAX_SEQ, XLSTM_PROFILE_LENS)
    out["serve_peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    log(f"xlstm: serving peak torch.cuda.max_memory_allocated {out['serve_peak_mb']:.1f} MB; "
        f"{smi}")
    del model
    free_card(torch)
    out["train"] = train_family(torch, np, tr, "xlstm", cfg, smi, dev, XLSTM_TRAIN,
                                watched=("layers.0.mlstm.wq",
                                         f"layers.{cfg.period - 1}.slstm.r"))
    # (e) one step of the chunkwise-parallel mLSTM on (d)'s weights and batch
    par = train_family(torch, np, tr, "xlstm (e) xlstm_parallel",
                       dataclasses.replace(cfg, xlstm_parallel=True), smi, dev,
                       dict(XLSTM_TRAIN, steps=1), watched=("layers.0.mlstm.wq",))
    rel = abs(par["loss"][0] - out["train"]["loss"][0]) / abs(out["train"]["loss"][0])
    log(f"xlstm (e): chunkwise-parallel mLSTM (chunk {cfg.xlstm_chunk or 64}) step "
        f"{par['ms'][0]:.1f} ms against the sequential cell's {out['train']['ms']} ms; loss "
        f"{par['loss'][0]:.6f} vs {out['train']['loss'][0]:.6f}: relative difference "
        f"{rel:.2e} (limit {XLSTM_PARALLEL_RTOL})")
    if not rel <= XLSTM_PARALLEL_RTOL:
        raise AssertionError(f"xlstm (e): the chunkwise loss differs by {rel:.2e}")
    out["train_parallel"] = dict(par, loss_rel_diff=rel)
    out["memory_mb_after"] = log_memory(torch, "xlstm (after)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"xlstm: phase passed in {out['seconds']:.1f} s")
    return out, launches



# ------------------------------------------------------ phase 15: the VLM
VLM_MAX_SEQ = 2048
VLM_LENS = HYBRID_LENS  # 6 requests over 4 slots
VLM_PROFILE_LENS = HYBRID_PROFILE_LENS
VLM_PEAK_GB = 75  # serving peak the phase allows itself before it cuts depth
VLM_TRAIN_LAYERS = 2
VLM_TRAIN = {"batch": 2, "seq": 256, "steps": 2, "lr": 1e-2}


def vlm_requests(np, cfg, lens):
    """Seeded prompts of ``lens`` tokens, each with vision embeddings over
    its first half (the image patches' positions), as per-request extras."""
    rng = np.random.default_rng(0)
    prompts, extras = [], []
    for n in lens:
        prompts.append(rng.integers(0, cfg.vocab_size, n).astype(np.int32))
        mask = np.zeros(n, bool)
        mask[: n // 2] = True
        extras.append({"vision_embeds": rng.standard_normal((n, cfg.d_model))
                       .astype(np.float32), "vision_mask": mask})
    return prompts, extras


def serving_gb(cfg, max_seq, slots):
    """f32 weights and the dense and paged caches of a serve phase, GB: what
    the phase's peak is made of (activations are a few hundred MB)."""
    c = cfg
    attn = c.d_model * c.head_dim * (2 * c.num_heads + 2 * c.num_kv_heads)
    mlp = (3 if c.mlp_kind == "swiglu" else 2) * c.d_model * c.d_ff
    v = c.vocab_size * c.num_codebooks
    params = c.num_layers * (attn + mlp) + 2 * v * c.d_model
    cache = 2 * c.num_layers * max_seq * slots * c.num_kv_heads * c.head_dim
    return 4 * (params + 2 * cache) / 1e9


def phase_vlm(torch, np, tr, get, TransformerLM, ServeEngine, ContinuousBatcher, Request,
              PagingSpec, ops, smi, dev="cuda"):
    """Phase 15: Pixtral-12B at full width and depth, served dense and paged
    with vision inputs, profiled, and trained 2 layers deep (see the
    docstring). ``dev`` "cpu" rehearses it off the card (a smoke config
    through ``get``, the card's calls patched)."""
    t_phase = time.perf_counter()
    free_card(torch)
    out = {"memory_mb_before": log_memory(torch, "vlm (before)")}
    cfg = get("pixtral_12b")
    full = cfg.num_layers
    while serving_gb(cfg, VLM_MAX_SEQ, 4) > VLM_PEAK_GB:
        cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
    if cfg.num_layers != full:
        log(f"vlm: depth cut to {cfg.num_layers} of {full} layers: the serving peak would "
            f"pass {VLM_PEAK_GB} GB")
    t1 = time.perf_counter()
    model = TransformerLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    out["params"] = sum(p.numel() for p in model.parameters())
    out["layers"] = cfg.num_layers
    log(f"vlm: Pixtral-12B full width, {cfg.num_layers} of {full} layers (d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of hd {cfg.head_dim}, {cfg.num_kv_heads} KV "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {out['params']} params, f32, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    prompts, extras = vlm_requests(np, cfg, VLM_LENS)
    layouts = (("dense", {}),
               ("paged", {"paging": PagingSpec.sized(16, VLM_MAX_SEQ, 4 * VLM_MAX_SEQ)}))
    out["serve"], launches, toks = serve_family(
        torch, np, "vlm", model, ServeEngine, ContinuousBatcher, Request, ops, VLM_MAX_SEQ,
        VLM_LENS, layouts, layers=cfg.num_layers, extras=extras, prompts=prompts)
    # the vision inputs reach the card: the first request without them differs
    text, _ = greedy_run(np, model, prompts[:1], NEW, ContinuousBatcher, Request,
                         max_seq=VLM_MAX_SEQ)
    changed = int((np.asarray(text[0]) != toks[0]).sum())
    log(f"vlm: request 0 text only (no vision inputs) changes {changed} of its {NEW} tokens")
    if not changed:
        raise AssertionError("vlm: the vision inputs changed no token of request 0")
    out["text_only_changed"] = changed
    out["decode_tick"] = profile_ticks(torch, np, "vlm", model, ContinuousBatcher, Request,
                                       VLM_MAX_SEQ, VLM_PROFILE_LENS, layers=cfg.num_layers)
    out["serve_peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    log(f"vlm: serving peak torch.cuda.max_memory_allocated {out['serve_peak_mb']:.1f} MB; "
        f"{smi}")
    del model
    free_card(torch)
    out["train"] = train_family(
        torch, np, tr, "vlm", dataclasses.replace(cfg, num_layers=VLM_TRAIN_LAYERS), smi, dev,
        VLM_TRAIN, watched=("layers.0.attn.wq", "embed", "task.head_bias"))
    out["memory_mb_after"] = log_memory(torch, "vlm (after)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"vlm: phase passed in {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------- phase 16: the audio LM
AUDIO_MAX_SEQ = 2048
AUDIO_LENS = HYBRID_LENS
AUDIO_PROFILE_LENS = HYBRID_PROFILE_LENS
AUDIO_SHARED = 256  # rows of codebook prefix the prefix-cache requests share
AUDIO_TAILS = (64, 100)
AUDIO_TRAIN = {"batch": 2, "seq": 256, "steps": 2, "lr": 1e-2}


def audio_prefix(torch, np, model, ContinuousBatcher, Request, PagingSpec, ops):
    """16(a): two prompts of codebook rows behind one AUDIO_SHARED-row
    prefix, one slot, paged (16-row blocks), with and without the prefix
    cache: the second hits the first's blocks, and both give their no-cache
    tokens. Returns the record and the launches."""
    cfg = model.cfg
    rng = np.random.default_rng(5)
    shared = prompt_tokens(np, rng, cfg, AUDIO_SHARED)
    prompts = [np.concatenate([shared, prompt_tokens(np, rng, cfg, n)]) for n in AUDIO_TAILS]
    launches = {name: 0 for name in COUNTED}
    runs = {}
    for cache in (False, True):
        bt = ContinuousBatcher(model, num_slots=1, max_seq=AUDIO_MAX_SEQ, prefill_chunk=32,
                               paging=PagingSpec.sized(16, AUDIO_MAX_SEQ, 2 * AUDIO_MAX_SEQ),
                               prefix_cache=cache)
        torch.cuda.synchronize()
        zero_counts(ops)
        for uid, p in enumerate(prompts):
            bt.submit(Request(uid=uid, tokens=p, max_new=NEW))
        outs = {r.uid: np.stack(r.out) for r in bt.run()}
        torch.cuda.synchronize()
        launched = read_counts(ops)
        check_launches(f"audio prefix (cache {cache})", launched, batcher_stats(bt),
                       paged=True, layers=cfg.num_layers)
        for k, n in launched.items():
            launches[k] += n
        runs[cache] = (outs, bt.prefix.hit_tokens if cache else 0, bt.prefill_tokens)
        bt.close()
    (plain, _, plain_pf), (hit, hits, hit_pf) = runs[False], runs[True]
    same = all(np.array_equal(plain[u], hit[u]) for u in plain)
    log(f"audio prefix: {hits} cached codebook rows hit, prefill rows {hit_pf} with the cache "
        f"against {plain_pf} without; tokens == the no-cache run's: {same}")
    if not (hits > 0 and same):
        raise AssertionError(f"audio prefix: hits {hits}, tokens equal {same}")
    return {"hit_tokens": hits, "prefill_rows": hit_pf, "prefill_rows_no_cache": plain_pf}, \
        launches


def phase_audio(torch, np, tr, get, TransformerLM, ServeEngine, ContinuousBatcher, Request,
                PagingSpec, ops, smi, dev="cuda"):
    """Phase 16: MusicGen-large whole, served dense and paged over codebook
    rows, with the prefix cache, profiled and trained at full depth (see
    the docstring). ``dev`` "cpu" rehearses it off the card (a smoke config
    through ``get``, the card's calls patched)."""
    t_phase = time.perf_counter()
    free_card(torch)
    out = {"memory_mb_before": log_memory(torch, "audio (before)")}
    t1 = time.perf_counter()
    model = TransformerLM(get("musicgen_large"), device=dev, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    out["params"] = sum(p.numel() for p in model.parameters())
    log(f"audio: MusicGen-large full width and depth ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of hd {cfg.head_dim} (MHA), GELU, LayerNorm, "
        f"{cfg.num_codebooks} codebooks of {cfg.vocab_size}; {out['params']} params, f32, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
        f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    layouts = (("dense", {}),
               ("paged", {"paging": PagingSpec.sized(16, AUDIO_MAX_SEQ, 4 * AUDIO_MAX_SEQ)}))
    out["serve"], launches, _ = serve_family(
        torch, np, "audio", model, ServeEngine, ContinuousBatcher, Request, ops, AUDIO_MAX_SEQ,
        AUDIO_LENS, layouts, layers=cfg.num_layers)
    out["prefix"], more = audio_prefix(torch, np, model, ContinuousBatcher, Request,
                                       PagingSpec, ops)
    for k, n in more.items():
        launches[k] = launches.get(k, 0) + n
    out["decode_tick"] = profile_ticks(torch, np, "audio", model, ContinuousBatcher, Request,
                                       AUDIO_MAX_SEQ, AUDIO_PROFILE_LENS, layers=cfg.num_layers)
    out["serve_peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    log(f"audio: serving peak torch.cuda.max_memory_allocated {out['serve_peak_mb']:.1f} MB; "
        f"{smi}")
    del model
    free_card(torch)
    out["train"] = train_family(torch, np, tr, "audio", cfg, smi, dev, AUDIO_TRAIN,
                                watched=("layers.0.mlp.wi", "embed", "task.head_bias"))
    out["memory_mb_after"] = log_memory(torch, "audio (after)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"audio: phase passed in {out['seconds']:.1f} s")
    return out, launches


# ------------------------------------------------- phase 17: the analysis
def phase_analysis(torch, ops, smi, dev="cuda"):
    """Phase 17: the port's own analysis on the card (see the docstring):
    the lint over src/repro_torch and the graph audit with the kernel
    backend, the A003 ids probe in a child process; zero active findings,
    and every kernel of the five launched inside the audited run. Returns
    (the record, the launches). ``dev`` "cpu" rehearses it off the card
    (the card's calls patched; no kernel launches there)."""
    from repro_torch.analysis.findings import active
    from repro_torch.analysis.graph_audit import run_audit
    from repro_torch.analysis.lint import lint_paths

    t_phase = time.perf_counter()
    free_card(torch)
    lint = lint_paths([ROOT / "src" / "repro_torch"], root=ROOT)
    torch.cuda.synchronize()
    zero_counts(ops)
    findings, report = run_audit(dev, backends=("kernel",))
    torch.cuda.synchronize()
    launched = read_counts(ops)
    bad = active(lint) + active(findings)
    for f in bad:
        log(f"analysis: {f.format()}")
    checks = report["checks"]
    out = {"lint_findings": len(lint), "lint_suppressed": len(lint) - len(active(lint)),
           "audit_findings": len(findings), "active": len(bad), "checks": len(checks),
           "launches": launched, "ids_probe_exit": checks["A003"].get("exit"),
           "replay": {k: v["replay"] for k, v in checks.items()
                      if isinstance(v, dict) and "replay" in v},
           "a002": {k: {n: v[n] for n in ("prefill_kernels_c4", "prefill_kernels_c8")}
                    for k, v in checks.items() if k.startswith("A002[")
                    and isinstance(v, dict)},
           "a007": {k: v for k, v in checks.items() if k.startswith("A007")},
           "graph_mix": checks["graph_mix"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"analysis: lint {out['lint_findings']} findings, all suppressed: "
        f"{out['lint_suppressed'] == out['lint_findings']}; audit {len(checks)} checks, "
        f"{len(findings)} findings; the ids probe's process exited {out['ids_probe_exit']}; "
        f"launches inside the audited run {launched}; {smi}")
    log(json.dumps({"analysis": out}, default=str))
    if bad:
        raise AssertionError(f"analysis: {len(bad)} active findings")
    if out["ids_probe_exit"] != 0 or not all(launched[name] > 0 for name in COUNTED):
        raise AssertionError(f"analysis: probe exit {out['ids_probe_exit']}, launches "
                             f"{launched}: every kernel must run inside the audit")
    log(f"analysis: phase passed in {out['seconds']:.1f} s")
    return out, launched


ANALYSIS_TIMEOUT_S = 300  # phase 17's process: past it the smoke fails


def kernel_ops():
    """The five kernels' wrappers, by the names of their launch counts."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.graph_mix import ops as mix_ops
    from repro_torch.kernels.prefill_attention import ops as pre_ops

    return {"decode_attention": dec_ops.decode_attention,
            "prefill_attention": pre_ops.prefill_attention,
            "paged_decode_attention": dec_ops.paged_decode_attention,
            "paged_prefill_attention": pre_ops.paged_prefill_attention,
            "graph_mix": mix_ops.graph_mix}


def analysis_entry(_index, tmp, smi):
    """Phase 17 in a spawned process (a fresh profiler; the kernels built
    by phase 1 load from build/kernels): writes tmp/analysis.json with the
    record and the launches, or fails the process."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out, launched = phase_analysis(torch, kernel_ops(), smi)
    with open(os.path.join(tmp, "analysis.json"), "w") as f:
        json.dump({"out": out, "launched": launched}, f, default=str)


def phase_analysis_spawned(torch, smi):
    """Phase 17 (see the docstring) in its own process under
    ANALYSIS_TIMEOUT_S; returns (the record, the launches)."""
    import tempfile

    import torch.multiprocessing as mp

    free_card(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    t0 = time.perf_counter()
    spawn_and_wait(mp, analysis_entry, (tmp, smi), 1, t0 + ANALYSIS_TIMEOUT_S,
                   "the analysis", ANALYSIS_TIMEOUT_S)
    with open(os.path.join(tmp, "analysis.json")) as f:
        rec = json.load(f)
    log(f"analysis: its process took {time.perf_counter() - t0:.1f} s")
    return rec["out"], rec["launched"]


# ------------------------------------------------ phase 19: the distributed layer
DIST_TIMEOUT_S = 150  # the spawned ranks' hard limit: past it the smoke fails
DIST_TOL = 1e-5
DIST_SEED = 0
DIST_MIX = {"d": 4096, "eta": 0.5, "tau": 2.0, "alpha": 0.04}
DIST_SOLVER = {"n": 200, "d": 64, "eta": 0.5, "tau": 1.5, "iters": 60, "bsr_iters": 80}
DIST_SYNC_ITERS = (10, 40)  # host syncs per sharded call must be the same at both
DIST_TRAIN = {"batch": 32, "seq": 256, "steps": 3}  # phase 10(b)'s shape
DIST_TP_SPEC = ("data", None, "model")  # 19(d): the residual stream and the logits
DIST_MEMORY_RTOL = 0.25  # 19(e): the dry run's step memory against 19(c)'s measured peak
DIST_DRYRUN = (("olmo_1b", "decode_32k"), ("multitask_lm", "train_4k"))  # at 16 x 16


def dist_close(got, want):
    """max |got - want| and whether it is within DIST_TOL + DIST_TOL |want|."""
    diff = (got - want).abs()
    return diff.max().item(), bool((diff <= DIST_TOL + DIST_TOL * want.abs()).all())


def dist_band(m):
    """The phase's band graph over m tasks: bandwidth 2 where the ring has
    room (its antipodal task at m = 4), 1 at m = 2, none at m = 1."""
    from repro_torch.core import band_graph

    return band_graph(m, max(1, min(2, m // 2)))


def dist_solvers(torch, np, rank, world, dev, record):
    """19(a) and (b) on this rank: one task per rank, m = world."""
    from repro_torch import core
    from repro_torch.core.distributed import mix_all_gather, mix_ring, mixing_spec_for_band_graph
    from repro_torch.core.runners import bol_sharded, bsr_sharded

    m, g = world, dist_band(world)
    rng = np.random.default_rng(DIST_SEED)
    mx = DIST_MIX
    theta = rng.standard_normal((m, mx["d"])).astype(np.float32)
    mu = g.bol_mixing(mx["eta"], mx["tau"], mx["alpha"])
    want = torch.as_tensor((mu.T @ theta.astype(np.float64))[rank:rank + 1], device=dev)
    local = torch.as_tensor(theta[rank:rank + 1], device=dev)
    self_w, nbr = mixing_spec_for_band_graph(g, mx["eta"], mx["tau"], mx["alpha"])
    col = torch.as_tensor(mu[:, rank], dtype=torch.float32, device=dev)
    for name, got in (("mix_all_gather", mix_all_gather(local, col)),
                      ("mix_ring", mix_ring(local, self_w, nbr))):
        err, ok = dist_close(got.double(), want)
        record[name] = {"max_abs_err": err}
        if not ok:
            raise AssertionError(f"distributed (a): rank {rank} {name} is {err:.3e} from "
                                 "mu^T theta")
    sv = DIST_SOLVER
    x = rng.standard_normal((m, sv["n"], sv["d"])).astype(np.float32)
    w_true = rng.standard_normal((m, sv["d"])).astype(np.float32)
    y = (np.einsum("mnd,md->mn", x, w_true)
         + 0.1 * rng.standard_normal((m, sv["n"]))).astype(np.float32)
    problem = core.MultiTaskProblem(g, core.SQUARED, sv["eta"], sv["tau"])
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    runs = {
        "bol_ring": (lambda k: bol_sharded(problem, x, y, k, use_ring=True, device=dev),
                     lambda k: core.bol(problem, xd, yd, k, accelerated=False).w, sv["iters"]),
        "bol_all_gather": (lambda k: bol_sharded(problem, x, y, k, use_ring=False, device=dev),
                           lambda k: core.bol(problem, xd, yd, k, accelerated=False).w,
                           sv["iters"]),
        "bsr": (lambda k: bsr_sharded(problem, x, y, k, device=dev),
                lambda k: core.bsr(problem, xd, yd, k, accelerated=False).w, sv["bsr_iters"]),
    }
    for name, (sharded, single, iters) in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded(iters)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        err, ok = dist_close(got, single(iters))
        sync_sites(torch, lambda: sharded(1))  # one-time syncs show on the first call
        sites = {k: sync_sites(torch, lambda k=k: sharded(k)) for k in DIST_SYNC_ITERS}
        record[name] = {"iters": iters, "max_abs_err": err, "ms": secs * 1e3,
                        "syncs": {str(k): len(v) for k, v in sites.items()},
                        "sync_sites": sorted(set(s for v in sites.values() for s in v))}
        if not ok:
            raise AssertionError(f"distributed (a): rank {rank} {name} is {err:.3e} from the "
                                 "single-device solver")
        lo, hi = DIST_SYNC_ITERS
        if len(sites[lo]) != len(sites[hi]):
            raise AssertionError(f"distributed (b): rank {rank} {name}: host syncs grow with "
                                 f"the iterations: {sites}")


def dist_sharded(torch, tr, cfg, mesh_shape, dev, timed, want, plain):
    """One sharded run of 19(c) / (d): the model of ``cfg`` from seed 0 on
    a ``mesh_shape`` (data, model) mesh, sharded in the rules' placements,
    stepped by ``sharding.sharded_step`` over the phase's batches; its
    record against the plain step's (``want``: the plain step's updated
    parameters, on the host)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import axes_of, make_mesh
    from repro_torch.models import TransformerLM
    from repro_torch.sharding import (
        full_params,
        param_specs,
        placements,
        shard_batch,
        shard_state,
        sharded_step,
    )

    model = TransformerLM(cfg, device=dev, seed=0)
    mesh = make_mesh(*mesh_shape, device=dev.type)
    axes = axes_of(mesh)
    specs = param_specs(cfg, dict(model.named_parameters()), axes)
    step, state = train_steps(tr, model)
    state = shard_state(model, state, mesh, axes)
    state, rec = timed(sharded_step(model, step), state, lambda b: shard_batch(b, mesh, axes))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], plain["losses"]))
    got = {k: v.cpu() for k, v in full_params(state.params).items()}
    param_rel = max(((got[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                    for k, v in want.items())
    norm_rel = max(abs(got[k].norm().item() / max(v.norm().item(), 1e-30) - 1.0)
                   for k, v in want.items())
    bad = [k for k, p in state.params.items() if k.startswith("task.")
           and not (isinstance(p, DTensor)
                    and tuple(p.placements) == placements(specs[k], mesh))]
    rec.update(mesh=list(mesh_shape), loss_max_rel_err=loss_rel, param_max_rel_err=param_rel,
               param_norm_max_rel_err=norm_rel, bad_task_placements=bad,
               task_placements={k: repr(tuple(state.params[k].placements))
                                for k in state.params if k.startswith("task.")})
    del model, step, state, got
    return rec


def dist_train(torch, np, rank, world, dev, smi, record):
    """19(c) and (d) on this rank: the plain step, then the sharded step
    on a (world, 1) mesh and the tensor-parallel one on a (1, world) mesh,
    each from the same weights and batches. The plain step's updated
    weights wait on the host, so a sharded run's peak is its own step's."""
    from repro_torch import optim
    from repro_torch import train as trainer
    from repro_torch.configs import get
    from repro_torch.core import GraphMultiTask, band_graph
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import model_inputs
    from repro_torch.models import TransformerLM

    tr = {"adamw": optim.adamw, "GraphMultiTask": GraphMultiTask, "band_graph": band_graph,
          "make_train_step": trainer.make_train_step, "init_state": trainer.init_state,
          "TokenPipeline": TokenPipeline, "model_inputs": model_inputs}
    cfg, sp = get("multitask_lm"), DIST_TRAIN
    batches = [trainer.batch_to_device(b, dev)
               for b in train_batches(tr, cfg, sp["batch"], sp["seq"], sp["steps"])]

    def timed(step, state, shard=None):
        losses, ms = [], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b if shard is None else shard(b))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        return state, {"losses": losses, "ms_per_step": ms,
                       "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6}

    plain_model = TransformerLM(cfg, device=dev, seed=0)
    step, state = train_steps(tr, plain_model)
    state, plain = timed(step, state)
    want = {k: v.detach().cpu() for k, v in plain_model.named_parameters()}
    del plain_model, step, state
    free_card(torch)
    tp_cfg = dataclasses.replace(cfg, activation_sharding=DIST_TP_SPEC,
                                 logits_sharding=DIST_TP_SPEC)
    runs = {}
    for key, run_cfg, shape in (("sharded", cfg, (world, 1)), ("tensor_parallel", tp_cfg,
                                                              (1, world))):
        runs[key] = dist_sharded(torch, tr, run_cfg, shape, dev, timed, want, plain)
        free_card(torch)
    record["train"] = {"params": sum(v.numel() for v in want.values()), "tasks": cfg.num_tasks,
                       "plain": plain, **runs, "device": smi}
    if rank == 0:
        for label, key in (("c", "sharded"), ("d", "tensor_parallel")):
            r = runs[key]
            log(f"distributed ({label}): multitask-LM full width ({record['train']['params']} "
                f"params, {cfg.num_tasks} tasks, AdamW, the mix over band_graph("
                f"{cfg.num_tasks}, 1)"
                + (f", residual stream and logits constrained to {DIST_TP_SPEC}"
                   if key == "tensor_parallel" else "")
                + f"), {sp['steps']} steps of {sp['batch']} x {sp['seq']} on a "
                f"{tuple(r['mesh'])} mesh: losses {r['losses']} against the plain step's "
                f"{plain['losses']}; max relative error of losses {r['loss_max_rel_err']:.3e}, "
                f"of parameters {r['param_max_rel_err']:.3e}, of parameter norms "
                f"{r['param_norm_max_rel_err']:.3e} (limit {DIST_TOL}); ms a step "
                f"{[round(t, 2) for t in r['ms_per_step']]}, plain "
                f"{[round(t, 2) for t in plain['ms_per_step']]}; peak "
                f"torch.cuda.max_memory_allocated {r['max_memory_allocated_mb']:.1f} MB, plain "
                f"{plain['max_memory_allocated_mb']:.1f} MB; task leaves "
                f"{r['task_placements']}; {smi}")
    # one rank runs the plain step's arithmetic, so every element must
    # agree; over several the gradients sum in another order, and AdamW
    # turns a near-zero gradient's rounding into a step of up to lr either
    # way: there each leaf's norm is held (the rule of phase 10 and of the
    # CPU tests against JAX)
    for label, key in (("c", "sharded"), ("d", "tensor_parallel")):
        r = runs[key]
        params_ok = (r["param_max_rel_err"] if world == 1
                     else r["param_norm_max_rel_err"]) <= DIST_TOL
        if not (r["loss_max_rel_err"] <= DIST_TOL and params_ok):
            raise AssertionError(
                f"distributed ({label}): rank {rank}: the {key} step is "
                f"{r['loss_max_rel_err']:.3e} (losses), {r['param_max_rel_err']:.3e} "
                f"(parameters), {r['param_norm_max_rel_err']:.3e} (parameter norms) from the "
                "plain step")
        if r["bad_task_placements"]:
            raise AssertionError(f"distributed ({label}): rank {rank}: task leaves off their "
                                 f"placements: {r['bad_task_placements']}")


def dist_dryrun(tmp, measured_mb, smi):
    """19(e), in a process of its own (its fake process group never meets
    the NCCL ranks): the dry run of DIST_DRYRUN on the 16 x 16 mesh, and of
    19(c)'s step (multitask-LM, 32 x 256, AdamW, f32) on a (1, 1) fake
    mesh, whose argument_bytes + temp_bytes must lie within
    DIST_MEMORY_RTOL of 19(c)'s measured peak. Writes tmp/dryrun.json."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.specs import InputShape

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    t0 = time.perf_counter()
    out = {"combos": {}}
    for arch, shape in DIST_DRYRUN:
        r = dryrun.run_one(arch, shape, False, False, None)
        out["combos"][f"{arch}__{shape}"] = r
        log(json.dumps({"dryrun": r}))
    sp = DIST_TRAIN
    shape = InputShape(f"train_{sp['batch']}x{sp['seq']}", sp["seq"], sp["batch"], "train")
    step = dryrun.account(get("multitask_lm"), shape, make_fake_mesh(shape=(1, 1)),
                          dtype=torch.float32)
    mem = step["memory"]
    predicted = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e6
    rel = abs(predicted - measured_mb) / measured_mb
    out["step_1x1"] = dict(step, predicted_mb=predicted, measured_mb=measured_mb,
                           rel_err=rel, device=smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"distributed (e): dry run of 19(c)'s step on a (1, 1) fake mesh: argument_bytes "
        f"{mem['argument_bytes'] / 1e6:.1f} MB + temp_bytes {mem['temp_bytes'] / 1e6:.1f} MB = "
        f"{predicted:.1f} MB against the measured peak torch.cuda.max_memory_allocated "
        f"{measured_mb:.1f} MB of 19(c): relative difference {rel:.3f} (limit "
        f"{DIST_MEMORY_RTOL}); {step['cost']['flops']:.4e} FLOPs a step; the dry runs took "
        f"{out['seconds']:.1f} s on the host; {smi}")
    with open(os.path.join(tmp, "dryrun.json"), "w") as f:
        json.dump(out, f)
    if not rel <= DIST_MEMORY_RTOL:
        raise AssertionError(f"distributed (e): the dry run's step memory {predicted:.1f} MB is "
                             f"{rel:.3f} from the measured {measured_mb:.1f} MB")


def dist_rank(rank, world, tmp, smi, device="cuda"):
    """One rank of phase 19, in its own process: joins the NCCL group on
    cuda:rank, runs (a)-(d) and writes its record to tmp/rank<r>.json. Any
    failure raises, and its process exits non-zero. ``device`` "cpu"
    rehearses it over gloo (the card's calls patched)."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = init_distributed(rank, world, device=device,
                           store=dist.FileStore(os.path.join(tmp, "store"), world))
    nccl = torch.cuda.nccl.version() if dev.type == "cuda" else None
    record = {"world": world, "backend": str(dist.get_backend()),
              "nccl": ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl),
              "init_s": time.perf_counter() - t0}
    if rank == 0:
        log(f"distributed: world {world}, backend {record['backend']}, NCCL "
            f"{record['nccl']}, torch {torch.__version__}"
            + ("; world 1: plumbing only" if world == 1 else ""))
    dist_solvers(torch, np, rank, world, dev, record)
    if rank == 0:
        log("distributed (a), (b): " + ", ".join(
            f"{k} err {v['max_abs_err']:.2e}" + (f" {v['ms']:.1f} ms, syncs {v['syncs']}"
                                                 if "ms" in v else "")
            for k, v in record.items() if isinstance(v, dict)))
    dist_train(torch, np, rank, world, dev, smi, record)
    dist.destroy_process_group()
    record["seconds"] = time.perf_counter() - t0
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def spawn_and_wait(mp, fn, args, nprocs, deadline, what, limit=None):
    """``nprocs`` spawned processes of ``fn`` (``torch.multiprocessing``),
    joined until ``deadline`` (``time.perf_counter()``; ``limit``, its
    seconds for the message, DIST_TIMEOUT_S by default); past it, or if one
    fails, the smoke fails. Every process is stopped on the way out."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{what} ran past {limit or DIST_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def dist_dryrun_entry(_index, tmp, measured_mb, smi):
    dist_dryrun(tmp, measured_mb, smi)


def phase_distributed(torch, smi):
    """Phase 19 (see the docstring): the ranks in their own processes, then
    the dry run (19(e)) in another, each under DIST_TIMEOUT_S; returns rank
    0's record with the dry run's."""
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    free_card(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    spawn_and_wait(mp, dist_rank, (world, tmp, smi), world, t_phase + DIST_TIMEOUT_S,
                   "distributed: the ranks")
    records = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            records.append(json.load(f))
    measured = records[0]["train"]["sharded"]["max_memory_allocated_mb"]
    t_dry = time.perf_counter()
    spawn_and_wait(mp, dist_dryrun_entry, (tmp, measured, smi), 1, t_dry + DIST_TIMEOUT_S,
                   "distributed: the dry run")
    with open(os.path.join(tmp, "dryrun.json")) as f:
        dry = json.load(f)
    secs = time.perf_counter() - t_phase
    log(f"distributed: phase passed in {secs:.1f} s ({world} ranks; rank 0 "
        f"{records[0]['seconds']:.1f} s after its spawn, NCCL init "
        f"{records[0]['init_s']:.1f} s; the dry run's process {time.perf_counter() - t_dry:.1f}"
        " s)")
    return dict(records[0], dryrun=dry, phase_seconds=secs)


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

    from repro_torch import core as core_lib
    from repro_torch import data as data_lib
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get
    from repro_torch.core.graph import band_graph
    from repro_torch.kernels import runtime
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.graph_mix import ops as mix_ops
    from repro_torch.kernels.graph_mix import ref as mix_ref
    from repro_torch.kernels.prefill_attention import ops as pre_ops
    from repro_torch.kernels.prefill_attention import ref as pre_ref
    from repro_torch.models import TransformerLM
    from repro_torch.serve import (
        ContinuousBatcher,
        FaultPlan,
        PagingSpec,
        Request,
        ServeEngine,
        TaskAdapterStore,
    )
    from repro_torch import convert, optim, train as trainer
    from repro_torch.checkpoint import load_pytree
    from repro_torch.core import GraphMultiTask
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import main as launch_main
    from repro_torch.launch.train import model_inputs
    from repro_torch.models.attention import causal_attend
    import repro_torch.examples.consensus_vs_multitask  # noqa: F401  (phase 18's entry points)
    import repro_torch.examples.learn_the_graph  # noqa: F401
    import repro_torch.examples.quickstart  # noqa: F401
    import repro_torch.examples.serve_batched  # noqa: F401
    import repro_torch.examples.train_multitask_lm  # noqa: F401
    import repro_torch.experiments.ablation_mtl_lm  # noqa: F401
    import repro_torch.experiments.delay_bench  # noqa: F401
    import repro_torch.experiments.fig2_erm  # noqa: F401
    import repro_torch.experiments.fig3_stochastic  # noqa: F401
    import repro_torch.experiments.run  # noqa: F401
    import repro_torch.experiments.table1_complexity  # noqa: F401
    from repro_torch import examples, experiments

    train_lib = {"TransformerLM": TransformerLM, "convert": convert, "tree": tree_lib,
                 "adamw": optim.adamw, "sgd": optim.sgd, "GraphMultiTask": GraphMultiTask,
                 "band_graph": band_graph, "make_train_step": trainer.make_train_step,
                 "init_state": trainer.init_state, "batch_to_device": trainer.batch_to_device,
                 "TokenPipeline": TokenPipeline, "causal_attend": causal_attend,
                 "launch_main": launch_main, "load_pytree": load_pytree,
                 "model_inputs": model_inputs}

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
    ops = kernel_ops()
    t0 = time.perf_counter()
    phase_build(runtime)
    breakdown = []  # (kernel, entry, kernel call, library call) for phase_breakdown
    entries = phase_kernels(torch, F, dec_ops, pre_ops, dec_ref, pre_ref, runtime.gather_pages,
                            breakdown)
    entries["graph_mix"] = phase_graph_mix(torch, mix_ops, mix_ref, band_graph,
                                           get("multitask_lm"))
    paper = phase_paper(torch, np, core_lib, data_lib)
    exps = phase_experiments(experiments, examples, convert, TransformerLM, get, ops, smi,
                             paper["f_star"]["card"])
    distributed = phase_distributed(torch, smi)
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
    faults = phase_faults(torch, np, model, ServeEngine, ContinuousBatcher, Request, PagingSpec,
                          FaultPlan, ops, dense, paged)
    profiles = phase_profile(torch, np, model, ContinuousBatcher, Request, PagingSpec)
    del model  # and the cycles that still hold it, so phase 7 starts on a free card
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    mt_model = TransformerLM(get("multitask_lm"), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"adapters: multitask-LM full width ({sum(p.numel() for p in mt_model.parameters())} "
        f"params, f32) initialised in {time.perf_counter() - t1:.1f} s")
    adapters = phase_adapters(torch, np, mt_model, ServeEngine, TaskAdapterStore, band_graph,
                              tree_lib, ContinuousBatcher, Request, ops)
    del mt_model
    train = phase_train(torch, np, train_lib, get, ContinuousBatcher, Request, ops, smi)
    moe, moe_launches = phase_moe(torch, np, train_lib, get, TransformerLM, ServeEngine,
                                  ContinuousBatcher, Request, PagingSpec, ops, smi)
    hybrid, hybrid_launches = phase_hybrid(torch, np, train_lib, get, TransformerLM,
                                           ServeEngine, ContinuousBatcher, Request, PagingSpec,
                                           ops, smi)
    mla, mla_launches = phase_mla(torch, np, train_lib, get, TransformerLM, ServeEngine,
                                  ContinuousBatcher, Request, PagingSpec, ops, smi)
    xlstm, xlstm_launches = phase_xlstm(torch, np, train_lib, get, TransformerLM, ServeEngine,
                                        ContinuousBatcher, Request, TaskAdapterStore,
                                        band_graph, tree_lib, ops, smi)
    vlm, vlm_launches = phase_vlm(torch, np, train_lib, get, TransformerLM, ServeEngine,
                                  ContinuousBatcher, Request, PagingSpec, ops, smi)
    audio, audio_launches = phase_audio(torch, np, train_lib, get, TransformerLM, ServeEngine,
                                        ContinuousBatcher, Request, PagingSpec, ops, smi)
    phase_breakdown(torch, breakdown)
    del breakdown  # its closures hold the phase-2 inputs
    analysis, analysis_launches = phase_analysis_spawned(torch, smi)
    log(json.dumps({"paper": {"device": smi, **paper}}))
    log(json.dumps({"experiments": exps}, default=str))
    log(json.dumps({"distributed": distributed}))
    log(json.dumps({"serve_rates": {"dense": dense["rates"], "paged": paged["rates"],
                                    "prefix": prefix["rates"], "faults": faults["rates"],
                                    "adapters": adapters["rates"]},
                    "profile": profiles}))
    log(json.dumps({"train": train}))
    log(json.dumps({"moe": {"device": smi, **moe}}))
    log(json.dumps({"hybrid": {"device": smi, **hybrid}}))
    log(json.dumps({"mla": {"device": smi, **mla}}))
    log(json.dumps({"xlstm": {"device": smi, **xlstm}}))
    log(json.dumps({"vlm": {"device": smi, **vlm}}))
    log(json.dumps({"audio": {"device": smi, **audio}}))
    log(f"smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    # launches of each kernel on the main paths, each counted from zero:
    # the dense, adapters and train (serving after training) phases for the
    # dense kernels, the paged and prefix phases for the paged ones, the
    # faults, moe, hybrid, vlm, audio and analysis phases for both (and the
    # experiments phase's serve_batched for the dense ones), the
    # adapters, xlstm and analysis phases for the graph mix (the mla phase
    # launches none: MLA is plain, as in the reference)
    launches = {
        name: sum(ph["launches"][name]
                  for ph in (dense, paged, prefix, faults, adapters, train["serve"]))
        + sum(ph.get(name, 0) for ph in (moe_launches, hybrid_launches, mla_launches,
                                         xlstm_launches, vlm_launches, audio_launches,
                                         analysis_launches, exps["launches"]))
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
        "graph_mix": ("src/repro_torch/kernels/csrc/graph_mix.cu",
                      "src/repro/kernels/graph_mix/kernel.py:42", "graph_mix_pallas"),
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
