"""Layer 2: graph audit — run the REAL serving entry points and check the
invariants the AST lint cannot see.

Counterpart of ``repro.analysis.jaxpr_audit``. The reference traces its
jitted step pair and walks the lowered programs; the port has no program
to walk, so this layer runs the entry points themselves
(``ContinuousBatcher``, ``serve/step.StepExecutor`` and the step bodies it
captures, ``make_cow_copy``, ``graph_mix_tree``) on the caller's device
and watches what they do: the captures, the aten ops a step dispatches
(``torch.utils._python_dispatch.TorchDispatchMode``), the kernels and CUDA
API calls the profiler sees, data pointers and ``_version`` counters,
torch's sync debug mode. It checks:

  A001  one capture per step kind — a content-varying serving run
        (prompt lengths, live masks and slot reuse vary tick to tick)
        leaves ``StepExecutor.captures == 2`` and more dispatches than
        captures (CUDA only: the CPU runs the steps eagerly), and the
        attention ops take the whole pos-flavor matrix (Python int, numpy
        scalar, () and (B,) tensors: ``runtime.pos_vector``) with one
        result, device tensors with no host sync (the reference's
        retrace-per-tick bug class).
  A002  no per-token loop in the parallel prefill — a prefill chunk of a
        dense stack dispatches as many aten ops at chunk 4 as at chunk 8,
        the per-token "scan" oracle more, and on CUDA the kernels the
        profiler sees at chunk 8 are within one decode tick's count of
        those at chunk 4 (the library's GEMM algorithms vary with the
        shape; a per-token loop would add four ticks' worth); a decode
        tick's counts do not depend on the positions. xLSTM's prefill is
        a sequential cell in the reference too, so it is out of A002's
        scope (the report says so).
  A003  clamped ids at run time — dead lanes carry the null task id
        ``num_tasks``; a run fed token ids past the vocabulary, task ids
        past the tables and block-table entries past the pool neither
        raises nor leaves a non-finite live row, and its live rows are bit
        for bit those of a run with in-range ids. On CUDA the probe runs in
        a child process (``python -m repro_torch.analysis --probe ids``),
        so a missing clamp is a finding, not a device-side assert that
        poisons this process's CUDA context.
  A004  no hidden host->device copies — a step body creates no tensor
        from host data (no ``aten.lift_fresh``), and on CUDA one replayed
        dispatch makes exactly one ``cudaGraphLaunch`` and two
        ``cudaMemcpyAsync`` (the staging upload and the read-back).
  A005  in place — the caches' data pointers (K/V and recurrent states)
        are unchanged across a decode tick, a prefill chunk and a slot
        reset, every tensor a step writes has its ``_version`` advanced,
        and on CUDA a tick's peak memory exceeds what was allocated before
        it by at most ``TICK_WORKSPACE_BYTES`` plus half the caches (a
        copied cache would add all of it).
  A006  the COW copy — ``make_cow_copy`` issues one copy per pool tensor
        whatever ``rows`` is, in place, and touches nothing outside
        ``[dst, :rows]``.
  A007  no host sync in a step (CUDA only) — a decode tick and a prefill
        chunk run eagerly under ``torch.cuda.set_sync_debug_mode("error")``,
        the window covering the step body only, not the executor's
        read-back. On the CPU the check is the lint's R004.
  graph mix — ``graph_mix_tree`` over an f32 + bf16 tree calls
        ``graph_mix`` once per dtype group: 2 (on CUDA, 2 kernel launches),
        as the reference's ``audit_graph_mix`` counts 2 ``pallas_call``s.

The default audit is the reference's: ``olmo_1b``'s smoke config, dense
and paged (``PagingSpec.sized(8, 24, pool_tokens=96)``), backends
("kernel", "plain"); A005 also on ``zamba2_7b``'s smoke config for the
recurrent states. On CUDA it also audits ``olmo_1b`` at full width with the
kernel backend and ``multitask_lm`` at full width under a
``TaskAdapterStore`` (the adapter path), so the audited captures launch
kernels 1-4 and the graph mix.

Run via ``python -m repro_torch.analysis``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

ARCH = "olmo_1b"
RECURRENT_ARCH = "zamba2_7b"
ADAPTER_ARCH = "multitask_lm"
MAX_SEQ = 24
PAGED_BLOCK = 8
POOL_TOKENS = 96
SLOTS = 2
A002_CHUNKS = (4, 8)
# a tick may allocate this much beyond what was allocated before it (its
# activations, the logits, cuBLAS's workspace), plus half the caches' bytes
TICK_WORKSPACE_BYTES = 64 << 20


# ------------------------------------------------------------- instruments
class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched inside it, by overload name."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))

    @property
    def total(self) -> int:
        return sum(self.ops.values())

    def count(self, prefix: str) -> int:
        return sum(n for name, n in self.ops.items() if name.startswith(prefix))


def _cuda_profile(fn):
    """(kernels executed, {CUDA API call: count}) of ``fn()`` under
    torch.profiler (CUDA only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    api = {e.key: e.count for e in events
           if e.device_type != DeviceType.CUDA and e.key.startswith("cu")}
    return kernels, api


@contextlib.contextmanager
def _sync_errors(device):
    """Turn every host sync on ``device`` into an error (CUDA; a no-op
    elsewhere)."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ----------------------------------------------------------------- set-up
def audit_spec():
    from repro_torch.serve.paging import PagingSpec

    return PagingSpec.sized(PAGED_BLOCK, MAX_SEQ, pool_tokens=POOL_TOKENS)


def audit_model(arch: str, backend: str, device, smoke: bool = True):
    from repro_torch.configs import get
    from repro_torch.models import TransformerLM

    cfg = dataclasses.replace(get(arch, smoke=smoke), attn_backend=backend)
    return TransformerLM(cfg, device=device, seed=0)


def _layout(paging) -> str:
    return "dense" if paging is None else "paged"


def _tables(paging, b: int, device):
    """(B, max_blocks) int32 block tables of distinct blocks per slot, or
    None when dense."""
    if paging is None:
        return None
    mb = paging.max_blocks_per_slot
    return _ints(1 + np.arange(b * mb).reshape(b, mb) % (paging.num_blocks - 1), device)


def _step_inputs(model, b: int, c: int, paging, pos, seed: int = 0):
    """Inputs of one step body: (tokens (B, C), task ids (B,), positions
    (B,) int32, mask (B, C) bool, block tables)."""
    rng = np.random.default_rng(seed)
    dev = model.device
    cfg = model.cfg
    mask = torch.ones((b, c), dtype=torch.bool, device=dev)
    return (_ints(rng.integers(0, cfg.vocab_size, (b, c)), dev),
            _ints(np.arange(b) % cfg.num_tasks, dev), _ints(pos, dev), mask,
            _tables(paging, b, dev))


def _bodies(model, mode="parallel"):
    from repro_torch.serve.step import _step_bodies

    return _step_bodies(model, mode)


def _decode(model, caches, inputs, adapters=None):
    tick, _ = _bodies(model)
    tokens, tasks, positions, mask, table = inputs
    return tick(tokens[:, 0], tasks, caches, positions, mask[:, 0], table, adapters)


def _prefill(model, caches, inputs, mode="parallel", adapters=None):
    _, body = _bodies(model, mode)
    tokens, tasks, positions, mask, table = inputs
    return body(tokens, tasks, caches, positions, mask, table, adapters)


def _ints(a, device):
    return torch.as_tensor(a, dtype=torch.int32, device=device)


def _entries(caches):
    return [t for entry in caches for t in entry]


def _finding(rule, path, message):
    return Finding(rule=rule, path=path, line=0, message=message)


# ------------------------------------------------------------------ A001
def audit_captures(model, paging, adapters=None, name=None):
    """A001 (and A004's replay) over a content-varying ContinuousBatcher
    run: 3 requests of 5, 3 and 6 prompt tokens over 2 slots, chunk 4 (the
    third request reuses a slot)."""
    from repro_torch.serve import ContinuousBatcher, Request

    cfg = model.cfg
    path = name or f"batcher[{cfg.attn_backend},{_layout(paging)}]"
    rng = np.random.default_rng(0)
    bt = ContinuousBatcher(model, num_slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=4,
                           paging=paging, adapters=adapters)
    for i, (n, new) in enumerate(((5, 3), (3, 4), (6, 2))):
        bt.submit(Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                          max_new=new, task_id=i % cfg.num_tasks))
    done = bt.run()
    dispatches = bt.decode_dispatches + bt.prefill_dispatches
    report = {"captures": bt.captures, "dispatches": dispatches,
              "finished": len(done)}
    findings = []
    if len(done) != 3 or any(len(r.out) != r.max_new for r in done):
        findings.append(_finding("A001", path, f"the run finished {len(done)} of 3 requests"))
    if bt._steps.cuda_graphs:
        if bt.captures != 2 or dispatches <= bt.captures:
            findings.append(_finding(
                "A001", path,
                f"{bt.captures} captures over {dispatches} dispatches of a content-varying "
                "run — each step kind must be captured once and replayed after (the "
                "retrace-per-tick bug class)"))
        # A004: one replayed dispatch, every lane dead
        b = SLOTS
        zeros = np.zeros(b, np.int32)
        kernels, api = _cuda_profile(lambda: bt._steps.decode(
            zeros, np.full(b, cfg.num_tasks, np.int32), zeros, np.zeros(b, bool),
            bt._block_tables(), bt._adapter_tree()))
        graph, copies = api.get("cudaGraphLaunch", 0), api.get("cudaMemcpyAsync", 0)
        report["replay"] = {"cudaGraphLaunch": graph, "cudaMemcpyAsync": copies,
                            "kernels": kernels}
        if (graph, copies) != (1, 2):
            findings.append(_finding(
                "A004", path,
                f"a replayed decode dispatch made {graph} cudaGraphLaunch and {copies} "
                "cudaMemcpyAsync; want 1 and 2 (the staging upload and the read-back): a "
                "hidden host<->device copy rides every dispatch"))
    else:
        report["captures"] = "eager (no CUDA graphs off CUDA)"
    bt.close()
    return findings, report


def audit_pos_flavors(device) -> tuple[list[Finding], dict]:
    """A001 for the attention ops: every pos flavor gives the (B,) tensor
    flavor's result; device tensors do so with no host sync."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention

    rng = np.random.default_rng(1)
    b, s, kvh, g, cq, hd = 2, 32, 2, 2, 4, 32
    h = kvh * g

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)

    k, v, q1, qc = t(b, s, kvh, hd), t(b, s, kvh, hd), t(b, 1, h, hd), t(b, cq, h, hd)
    flavors = {"int": 7, "np.int32": np.int32(7), "()": torch.tensor(7, device=device),
               "(B,)": torch.tensor([7, 7], dtype=torch.int32, device=device),
               "(B,) int64": torch.tensor([7, 7], device=device)}
    want = (decode_attention(q1, k, v, flavors["(B,)"]),
            prefill_attention(qc, k, v, flavors["(B,)"]))
    findings, report = [], {}
    for name, pos in flavors.items():
        sync = isinstance(pos, torch.Tensor)
        try:
            with _sync_errors(device) if sync else contextlib.nullcontext():
                got = (decode_attention(q1, k, v, pos), prefill_attention(qc, k, v, pos))
        except RuntimeError as e:
            findings.append(_finding("A001", f"attention(pos {name})",
                                     f"raised under the sync check: {e}"))
            continue
        same = all(torch.equal(a, w) for a, w in zip(got, want))
        report[name] = same
        if not same:
            findings.append(_finding("A001", f"attention(pos {name})",
                                     "a pos flavor gives another result than the (B,) "
                                     "int32 tensor: pos_vector must normalize it"))
    return findings, report


# ------------------------------------------------------------------ A002
def audit_op_counts(model, paging) -> tuple[list[Finding], dict]:
    """A002: aten ops (and on CUDA kernels) of one parallel prefill chunk
    at chunks 4 and 8 and of the scan oracle at chunk 8; of a decode tick
    at two position vectors."""
    path = f"prefill_chunk[{model.cfg.attn_backend},{_layout(paging)}]"
    cuda = model.device.type == "cuda"

    def measure(fn):
        caches = model.init_cache(SLOTS, MAX_SEQ, paging)
        fn(caches)  # a warm-up: lazy set-up is not the step's
        with OpCounter() as ops:
            fn(caches)
        kernels = _cuda_profile(lambda: fn(caches))[0] if cuda else None
        return ops.total, kernels

    report: dict = {}
    for c in A002_CHUNKS:
        inputs = _step_inputs(model, SLOTS, c, paging, [0, 3])
        report[f"prefill_ops_c{c}"], report[f"prefill_kernels_c{c}"] = measure(
            lambda caches, inputs=inputs: _prefill(model, caches, inputs))
    inputs = _step_inputs(model, SLOTS, A002_CHUNKS[-1], paging, [0, 3])
    report["scan_ops_c8"], _ = measure(lambda caches: _prefill(model, caches, inputs, "scan"))
    for pos in ([2, 5], [7, 11]):
        inputs = _step_inputs(model, SLOTS, 1, paging, pos)
        report[f"decode_ops_{pos}"], report[f"decode_kernels_{pos}"] = measure(
            lambda caches, inputs=inputs: _decode(model, caches, inputs))
    findings = []
    lo, hi = (report[f"prefill_ops_c{c}"] for c in A002_CHUNKS)
    if lo != hi:
        findings.append(_finding("A002", path,
                                 f"{lo} aten ops at chunk 4 but {hi} at chunk 8 — a "
                                 "per-token loop crept into the parallel prefill"))
    # the kernels of one aten op vary with the shape (cuBLAS picks a split-K
    # algorithm with a reduction kernel for some M), so on the card the
    # chunk's kernel count may move by less than one token's worth: a
    # per-token loop would add 4 decode ticks' worth from chunk 4 to 8
    k4, k8 = report["prefill_kernels_c4"], report["prefill_kernels_c8"]
    if cuda and abs(k8 - k4) >= report["decode_kernels_[2, 5]"]:
        findings.append(_finding("A002", path,
                                 f"{k4} kernels at chunk 4 but {k8} at chunk 8: more than a "
                                 f"decode tick's {report['decode_kernels_[2, 5]']} apart"))
    if report["scan_ops_c8"] <= hi:
        findings.append(_finding("A002", path,
                                 f"the per-token scan oracle dispatches {report['scan_ops_c8']}"
                                 f" ops, no more than the parallel chunk's {hi}: the counter "
                                 "does not see the loop it is there to catch"))
    dec = [report[f"decode_ops_{p}"] for p in ([2, 5], [7, 11])]
    kdec = [report[f"decode_kernels_{p}"] for p in ([2, 5], [7, 11])]
    if dec[0] != dec[1] or kdec[0] != kdec[1]:
        findings.append(_finding("A002", f"decode_tick[{model.cfg.attn_backend},"
                                 f"{_layout(paging)}]",
                                 f"the tick's op / kernel counts depend on the positions: "
                                 f"{dec}, {kdec}"))
    return findings, report


# ------------------------------------------------------------------ A003
def audit_ids(model, paging) -> tuple[list[Finding], dict]:
    """A003: 4 lanes, lanes 0-1 live, 2-3 dead with the null task id. The
    bad run feeds lane 1 token ids past the vocabulary and a task id past
    the tables, the dead lanes garbage ids and tables past the pool, and
    the live lanes' unused table columns ids past the pool; the good run
    feeds lane 1 the ids those clamp to and the rest in range. Live rows
    must be finite and bit for bit the good run's, decode and prefill."""
    cfg, dev = model.cfg, model.device
    path = f"ids[{cfg.attn_backend},{_layout(paging)}]"
    b, c, v, m = 4, 4, cfg.vocab_size, cfg.num_tasks

    def inputs(bad: bool, cols: int):
        rng = np.random.default_rng(3)
        tok = rng.integers(0, v, (b, c))
        tasks = np.array([0, m - 1, m, m])
        if bad:
            tok[1] = v + 5 + np.arange(c)
            tok[2:] = np.array([[v, 2 * v, -1, v + 1]])
            tasks = np.array([0, m + 3, m + 7, 10 * m])
        else:
            tok[1] = v - 1
            tok[2:] = 0
        mask = np.zeros((b, c), bool)
        mask[:2] = True
        table = None
        if paging is not None:
            mb, nb = paging.max_blocks_per_slot, paging.num_blocks
            ids = np.zeros((b, mb), np.int64)
            ids[:2, :cols] = 1 + np.arange(2 * cols).reshape(2, cols)
            if bad:
                ids[:2, cols:] = nb + 3
                ids[2:] = np.resize(np.array([nb + 1, -5, 10 * nb]), mb)
            table = _ints(ids, dev)
        return (_ints(tok, dev), _ints(tasks, dev), _ints(np.zeros(b), dev),
                torch.as_tensor(mask, device=dev), table)

    def run(bad: bool):
        caches = model.init_cache(b, MAX_SEQ, paging)
        cols = -(-(c + 1) // paging.block_size) if paging is not None else 0
        pre = _prefill(model, caches, inputs(bad, cols))[0]
        tok, tasks, _, mask, table = inputs(bad, cols)
        step = (tok[:, :1], tasks, torch.full((b,), c, dtype=torch.int32, device=dev),
                mask[:, :1], table)
        dec = _decode(model, caches, step)[1]
        return pre[:2], dec[:2]

    findings, report = [], {}
    try:
        want = run(False)
        got = run(True)
    except (IndexError, RuntimeError) as e:
        return [_finding("A003", path, f"out-of-range ids raised: {e}")], {"raised": str(e)}
    for name, g, w in zip(("prefill", "decode"), got, want):
        finite = bool(torch.isfinite(g).all())
        same = torch.equal(g, w)
        report[name] = {"finite": finite, "bit_identical": same}
        if not (finite and same):
            findings.append(_finding(
                "A003", path,
                f"{name}: live rows finite {finite}, bit-identical to the in-range run "
                f"{same} — an out-of-range id in one lane reached another"))
    return findings, report


def probe_ids(device, backends, arch: str = ARCH) -> tuple[list[Finding], dict]:
    """A003 over every backend, dense and paged, in this process."""
    findings, report = [], {}
    for backend in backends:
        model = audit_model(arch, backend, device)
        for paging in (None, audit_spec()):
            f, r = audit_ids(model, paging)
            findings += f
            report[f"{backend},{_layout(paging)}"] = r
    return findings, report


def probe_ids_child(device, backends) -> tuple[list[Finding], dict]:
    """A003 in a child process (``--probe ids``): a device-side assert
    there ends the child, not this process's CUDA context."""
    src = Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ids.json"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(src)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--probe", "ids", "--device",
             str(device), "--backends", *backends, "--json", str(out)],
            capture_output=True, text=True, env=env, timeout=600)
        if not out.exists():
            tail = (proc.stdout + proc.stderr)[-2000:]
            return [_finding("A003", "ids(child)",
                             f"the probe process exited {proc.returncode} without a report "
                             f"(a device-side assert ends it): {tail}")], {
                "exit": proc.returncode}
        got = json.loads(out.read_text())
    findings = [Finding(**f) for f in got["findings"]]
    return findings, {"exit": proc.returncode, **got["report"]}


# ------------------------------------------------------------ A004, A005
def audit_in_place(model, paging) -> tuple[list[Finding], dict]:
    """A004 (no tensor from host data in a step body) and A005 (pointers,
    versions, peak memory) over an eager decode tick, prefill chunk and
    slot reset, each step warmed up first."""
    cfg, dev = model.cfg, model.device
    path = f"in_place[{cfg.name},{cfg.attn_backend},{_layout(paging)}]"
    caches = model.init_cache(SLOTS, MAX_SEQ, paging)
    ptrs = [t.data_ptr() for t in _entries(caches)]
    findings, report = [], {}
    cache_bytes = sum(t.numel() * t.element_size() for t in _entries(caches))

    def versions():
        return [t._version for t in _entries(caches)]

    prefill_in = _step_inputs(model, SLOTS, 4, paging, [0, 3])
    decode_in = _step_inputs(model, SLOTS, 1, paging, [4, 7])
    # a warm-up on other caches, as the executor's before its capture: a
    # one-time set-up (a cached scale, a library handle) is no dispatch's
    warm = model.init_cache(SLOTS, MAX_SEQ, paging)
    _prefill(model, warm, prefill_in)
    _decode(model, warm, decode_in)
    del warm
    steps = {"prefill": lambda: _prefill(model, caches, prefill_in),
             "decode": lambda: _decode(model, caches, decode_in)}
    for name, fn in steps.items():
        before = versions()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        with OpCounter() as ops:
            fn()
        after = versions()
        stale = [i for i, (x, y) in enumerate(zip(before, after)) if y <= x]
        report[name] = {"host_data_tensors": ops.count("aten.lift_fresh"),
                        "unwritten_entries": len(stale)}
        if ops.count("aten.lift_fresh"):
            findings.append(_finding("A004", path,
                                     f"{name}: {ops.count('aten.lift_fresh')} tensors made from "
                                     "host data inside the step body — a hidden host->device "
                                     "copy every dispatch"))
        if stale:
            findings.append(_finding("A005", path,
                                     f"{name}: cache entries {stale} were not written in place "
                                     "(their _version did not advance)"))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            extra = torch.cuda.max_memory_allocated(dev) - base
            allowed = TICK_WORKSPACE_BYTES + cache_bytes // 2
            report[name]["extra_peak_bytes"] = extra
            if extra > allowed:
                findings.append(_finding("A005", path,
                                         f"{name}: peak {extra} B above the caches, allowed "
                                         f"{allowed} B — the step copied a cache"))
    reset = np.array([True] + [False] * (SLOTS - 1))
    per_slot = [t for kind, entry in zip(model.kinds, caches)
                if paging is None or kind not in ("attn", "attn_moe", "shared_attn")
                for t in entry]
    before = [t._version for t in per_slot]
    model.reset_slot_state(caches, reset, paging)
    if any(t._version <= v for t, v in zip(per_slot, before)):
        findings.append(_finding("A005", path, "the slot reset did not write every per-slot "
                                 "entry in place"))
    report["reset_entries"] = len(per_slot)
    if [t.data_ptr() for t in _entries(caches)] != ptrs:
        findings.append(_finding("A005", path,
                                 "a cache tensor moved (data_ptr changed) across a tick, a "
                                 "chunk or a reset: a captured graph would read stale "
                                 "memory"))
    return findings, report


# ------------------------------------------------------------------ A006
def audit_cow(model, paging) -> tuple[list[Finding], dict]:
    from repro_torch.serve.step import make_cow_copy

    cow = make_cow_copy(paging)
    caches = model.init_cache(SLOTS, MAX_SEQ, paging)
    gen = torch.Generator(device=model.device).manual_seed(0)
    for t in _entries(caches):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device).to(t.dtype))
    pools = _entries(caches)
    ptrs = [t.data_ptr() for t in pools]
    findings, report = [], {}
    for src, dst, rows in ((1, 2, 1), (4, 5, 3)):
        before = [t.clone() for t in pools]
        with OpCounter() as ops:
            cow(caches, src, dst, rows)
        copies = ops.count("aten.copy_")
        report[f"rows{rows}"] = {"copies": copies, "pools": len(pools)}
        if copies != len(pools):
            findings.append(_finding("A006", "cow_copy",
                                     f"{copies} copies for {len(pools)} pools at rows={rows}: "
                                     "one slice copy per pool, whatever rows is"))
        for t, old in zip(pools, before):
            want = old.clone()
            want[dst, :rows] = old[src, :rows]
            if not torch.equal(t, want):
                findings.append(_finding("A006", "cow_copy",
                                         f"rows={rows}: the copy touched more than "
                                         f"[{dst}, :{rows}] or copied other rows"))
                break
    if [t.data_ptr() for t in pools] != ptrs:
        findings.append(_finding("A006", "cow_copy", "the copy reallocated a pool"))
    return findings, report


# ------------------------------------------------------------------ A007
def audit_sync(model, paging) -> tuple[list[Finding], dict]:
    """A007 (CUDA): eager step bodies under sync debug mode "error"."""
    path = f"sync[{model.cfg.name},{model.cfg.attn_backend},{_layout(paging)}]"
    caches = model.init_cache(SLOTS, MAX_SEQ, paging)
    findings, report = [], {}
    for name, c, pos, fn in (("prefill", 4, [0, 3], _prefill), ("decode", 1, [4, 7], _decode)):
        inputs = _step_inputs(model, SLOTS, c, paging, pos)
        fn(model, caches, inputs)  # a warm-up, as the executor's before its capture
        try:
            with _sync_errors(model.device):
                fn(model, caches, inputs)
            report[name] = "no sync"
        except RuntimeError as e:
            report[name] = str(e)
            findings.append(_finding("A007", path, f"{name}: host sync in the step body: {e}"))
    return findings, report


# --------------------------------------------------------------- graph mix
def audit_graph_mix(device) -> tuple[list[Finding], dict]:
    """One ``graph_mix`` call (and on CUDA one launch) per dtype group."""
    from repro_torch.kernels.graph_mix import ops

    m = 4
    gen = torch.Generator(device=device).manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    tree = {"a": r(m, 3, 5), "b": r(m, 7), "c": r(m, 2, 2, dtype=torch.bfloat16)}
    mu = torch.softmax(r(m, m), dim=0)
    groups = len({t.dtype for t in tree.values()})
    if device.type == "cuda":  # the kernel's own counter
        launches = ops.graph_mix.launches
        out = ops.graph_mix_tree(mu, tree)
        calls = ops.graph_mix.launches - launches
        report = {"launches": calls, "dtype_groups": groups}
    else:  # a CPU call runs the plain version: one product per graph_mix call
        with OpCounter() as products:
            out = ops.graph_mix_tree(mu, tree)
        calls = products.count("aten.mm") + products.count("aten.bmm")
        report = {"graph_mix_calls": calls, "dtype_groups": groups}
    findings = []
    if calls != groups:
        findings.append(_finding("A001", "graph_mix_tree",
                                 f"{report} — the tree mix must be one graph_mix per dtype"))
    if not all(bool(torch.isfinite(t.float()).all()) for t in out.values()):
        findings.append(_finding("A003", "graph_mix_tree", "non-finite mixed leaves"))
    return findings, report


# --------------------------------------------------------------- the audit
def _adapter_run(device, smoke: bool):
    """A001 on ``ADAPTER_ARCH`` under a TaskAdapterStore (the adapter path:
    the graph mix at construction, gathers inside the captured steps)."""
    from repro_torch.core.graph import band_graph
    from repro_torch.serve import TaskAdapterStore

    model = audit_model(ADAPTER_ARCH, "kernel", device, smoke=smoke)
    store = TaskAdapterStore(model, band_graph(model.cfg.num_tasks, 2), update_every=2)
    store.randomize(0.05)
    name = f"batcher[{model.cfg.name}{'' if smoke else ' full'},adapters]"
    return audit_captures(model, None, adapters=store, name=name)


def run_audit(device="cuda", backends=("kernel", "plain"),
              retrace: bool = True) -> tuple[list[Finding], dict]:
    """The whole audit on ``device`` (see the module docstring).
    ``retrace=False`` skips the serving runs (A001 and A004's replay). On
    CUDA it adds olmo_1b at full width with the kernel backend and
    multitask_lm at full width under an adapter store, and runs A003 in a
    child process."""
    from repro_torch.kernels.runtime import require_device

    dev = require_device(device)
    cuda = dev.type == "cuda"
    findings: list[Finding] = []
    report: dict = {"device": str(dev), "arch": ARCH, "max_seq": MAX_SEQ, "checks": {}}

    def add(key, result):
        f, r = result
        findings.extend(f)
        report["checks"][key] = r

    spec = audit_spec()
    for backend in backends:
        model = audit_model(ARCH, backend, dev)
        for paging in (None, spec):
            tag = f"{backend},{_layout(paging)}"
            add(f"A002[{tag}]", audit_op_counts(model, paging))
            add(f"A004/A005[{tag}]", audit_in_place(model, paging))
            if cuda:
                add(f"A007[{tag}]", audit_sync(model, paging))
            if retrace:
                add(f"A001[{tag}]", audit_captures(model, paging))
        if backend == backends[0]:
            add("A006", audit_cow(model, spec))
        del model
    report["checks"]["A002[xlstm]"] = ("out of scope: the reference's xLSTM prefill is a "
                                       "sequential cell too")
    hybrid = audit_model(RECURRENT_ARCH, backends[0], dev)
    for paging in (None, spec):
        add(f"A004/A005[{RECURRENT_ARCH},{_layout(paging)}]", audit_in_place(hybrid, paging))
    del hybrid
    add("A003", probe_ids_child(dev, backends) if cuda else probe_ids(dev, backends))
    add("A001[pos flavors]", audit_pos_flavors(dev))
    add("graph_mix", audit_graph_mix(dev))
    if retrace:
        add(f"A001[{ADAPTER_ARCH},adapters]", _adapter_run(dev, smoke=True))
    if cuda:
        model = audit_model(ARCH, "kernel", dev, smoke=False)
        for paging in (None, spec):
            tag = f"{ARCH} full,kernel,{_layout(paging)}"
            add(f"A004/A005[{tag}]", audit_in_place(model, paging))
            if cuda:
                add(f"A007[{tag}]", audit_sync(model, paging))
            if retrace:
                add(f"A001[{tag}]", audit_captures(model, paging,
                                                   name=f"batcher[{tag}]"))
        del model
        if retrace:
            add(f"A001[{ADAPTER_ARCH} full,adapters]", _adapter_run(dev, smoke=False))
    return findings, report
