"""The port's five examples (repro_torch.examples) against the reference's
examples/ scripts on the CPU: each reference script runs as a script
(``runpy.run_path``, its output captured), the numbers it prints are parsed
and held to the numbers the port's ``main`` returns: within 1e-4 relative
plus half a unit of the last printed digit (the paper's solvers repeat the
reference's arithmetic), token lists and counters equal. ``serve_batched``
and ``train_multitask_lm`` start the port's model from the JAX init's
weights (``params=``), so tokens and losses are comparable; every parity
boolean ``serve_batched`` prints holds on both sides (the reference's
Pallas kernels in interpret mode). ``train_multitask_lm`` runs 3 steps of
8 x 32 tokens on both sides (its default, 30 steps of 8 x 256, takes
minutes on the CPU). JAX at matmul precision "highest", float32."""
import contextlib
import io
import re
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get as jax_get  # noqa: E402
from repro.configs.base import ArchConfig as JaxConfig  # noqa: E402
from repro.models import TransformerLM as JaxLM  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    consensus_vs_multitask,
    learn_the_graph,
    quickstart,
    serve_batched,
    train_multitask_lm,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
RTOL = 1e-4
TRAIN_ARGS = ["--steps", "3", "--seq", "32", "--batch", "8"]
NUM = r"(-?[0-9.]+(?:e[+-]\d+)?)"


def run_reference(name, argv=()):
    """What examples/<name>.py prints, run as a script."""
    old, sys.argv = sys.argv, [f"{name}.py", *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), jax.default_matmul_precision("highest"):
            runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


def run_port(module, argv=(), **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return module.main([*argv, *CPU], **kw)


def close_to_printed(value, text, rtol=RTOL):
    """``value`` against a number as printed: within rtol, plus half a unit
    of the printed number's last digit."""
    m = re.fullmatch(r"-?\d+(?:\.(\d+))?(?:e([+-]\d+))?", text)
    assert m, text
    half = 0.5 * 10.0 ** (int(m.group(2) or 0) - len(m.group(1) or ""))
    return abs(value - float(text)) <= rtol * abs(float(text)) + half


def _jax_init(cfg):
    return jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.PRNGKey(0)))


# -------------------------------------------------------------- quickstart
def test_quickstart_matches_the_reference():
    text = run_reference("quickstart")
    got = run_port(quickstart)
    rho, eta, tau = re.search(rf"rho\(B,S\) = {NUM}.*eta={NUM} tau={NUM}", text, re.S).groups()
    assert close_to_printed(got["rho"], rho) and close_to_printed(got["eta"], eta)
    assert close_to_printed(got["tau"], tau)
    printed = re.findall(rf"^(.+?)\s+population risk = {NUM}\s+ERM objective = {NUM}$", text,
                         re.M)
    assert [p[0] for p in printed] == list(got["methods"])
    for name, risk, obj in printed:
        assert close_to_printed(got["methods"][name][0], risk), name
        assert close_to_printed(got["methods"][name][1], obj), name
    assert close_to_printed(got["f_star"], re.search(rf"f\* = {NUM}", text).group(1))


# -------------------------------------------------- consensus_vs_multitask
def test_consensus_vs_multitask_matches_the_reference():
    text = run_reference("consensus_vs_multitask")
    got = run_port(consensus_vs_multitask)
    spread = float(re.search(rf"averaging steps: {NUM}", text).group(1))
    assert spread <= 1e-6 and got["consensus_spread"] <= 1e-6  # machine-identical rows
    printed = re.findall(rf"tau=\s*{NUM}\s+spread\(optimum\)={NUM}\s+spread\(BOL\)={NUM}", text)
    assert len(printed) == len(got["spreads"]) == 4
    for (tau, opt, it), (t, o, i) in zip(printed, got["spreads"]):
        assert float(tau) == t and close_to_printed(o, opt) and close_to_printed(i, it)
    limit = re.findall(rf"tau=\s*(\d+)\s+\|\|M.*= {NUM}", text)
    assert [int(t) for t, _ in limit] == [t for t, _ in got["limit"]]
    for (_, dist), (_, d) in zip(limit, got["limit"]):
        assert close_to_printed(d, dist)


# --------------------------------------------------------- learn_the_graph
def test_learn_the_graph_matches_the_reference():
    text = run_reference("learn_the_graph")
    got = run_port(learn_the_graph)
    printed = re.findall(rf"^(.+?)\s+population risk = {NUM}$", text, re.M)
    assert [p[0] for p in printed] == list(got["risks"])
    for name, risk in printed:
        assert close_to_printed(got["risks"][name], risk), name
    within, across = re.search(rf"within-cluster mean = {NUM}, across-cluster mean = {NUM}",
                               text).groups()
    assert close_to_printed(got["within"], within) and close_to_printed(got["across"], across)
    history = [(int(r), float(o), int(e)) for r, o, e in re.findall(
        rf"'round': (\d+), 'objective': {NUM}, 'edges': (\d+)", text)]
    assert [(h["round"], h["edges"]) for h in got["history"]] == [(r, e) for r, _, e in history]
    np.testing.assert_allclose([h["objective"] for h in got["history"]],
                               [o for _, o, _ in history], rtol=RTOL)


# ------------------------------------------------------- train_multitask_lm
def test_train_multitask_lm_lockstep_with_the_reference():
    cfg = JaxConfig(name="mtl-lm", family="dense", pattern=("attn",), num_tasks=8, q_chunk=128,
                    **train_multitask_lm.SMALL)
    text = run_reference("train_multitask_lm", TRAIN_ARGS)
    got = run_port(train_multitask_lm, TRAIN_ARGS, params=_jax_init(cfg))
    assert f"model: {got['params'] / 1e6:.1f}M parameters" in text
    printed = re.findall(rf"step\s+(\d+)\s+loss {NUM}\s+nll {NUM}", text)
    assert [int(s) for s, _, _ in printed] == [h["step"] for h in got["history"]] == [0, 1, 2]
    for (_, loss, nll), h in zip(printed, got["history"]):
        assert close_to_printed(h["loss"], loss) and close_to_printed(h["nll"], nll)
    spread = re.search(rf"spread across tasks: {NUM}", text).group(1)
    neighbor = re.search(rf"on the ring: {NUM}", text).group(1)
    assert abs(got["spread"] - float(spread)) <= 1e-4
    assert abs(got["neighbor"] - float(neighbor)) <= 1e-4
    assert got["tok_s"] > 0


# ------------------------------------------------------------ serve_batched
@pytest.fixture(scope="module")
def serving():
    text = run_reference("serve_batched")
    got = run_port(serve_batched, params=_jax_init(jax_get("qwen2_5_14b", smoke=True)))
    return text, got


def test_serve_batched_parity_booleans_hold_on_both_sides(serving):
    text, got = serving
    flags = re.findall(r": (True|False)\b", text)
    assert len(flags) == 6 and set(flags) == {"True"}, flags
    keys = ("batcher_match", "paged_match", "scan_match", "kernel_match", "sla_match",
            "prefix_match")
    assert all(got[k] is True for k in keys), {k: got[k] for k in keys}


def test_serve_batched_tokens_and_counters_match_the_reference(serving):
    text, got = serving
    first = re.search(r"first request's continuation: \[(.*)\]", text).group(1)
    assert got["first_continuation"] == [int(t) for t in first.split(",")]
    ticks, dec, pre = map(int, re.search(
        r"(\d+) ticks, (\d+) decode dispatches .* (\d+) chunked prefill", text).groups())
    assert (got["ticks"], got["decode_dispatches"], got["prefill_dispatches"]) == (ticks, dec, pre)
    assert got["free_blocks"] == int(re.search(r"blocks free after run: (\d+)/", text).group(1))
    mixed, streamed, emitted = map(int, re.search(
        r"(\d+) fused prefill\+decode dispatches, (\d+) tokens streamed.*emitted (\d+) tokens",
        text).groups())
    assert (got["mixed_dispatches"], got["streamed"], got["cancelled_emitted"]) == (
        mixed, streamed, emitted)
    hit, lookup, cow, computed = map(int, re.search(
        r"\((\d+)/(\d+) prompt tokens .*?(\d+) copy-on-write block copies, (\d+) tokens computed",
        text).groups())
    assert (got["hit_tokens"], got["lookup_tokens"], got["cow_copies"],
            got["prefill_tokens"]) == (hit, lookup, cow, computed)
    assert got["hit_ratio"] == pytest.approx(hit / lookup)


def test_serve_batched_kernel_cross_check_within_tolerance(serving):
    """The reference's Pallas flash-decode (interpret mode) against its
    serving path, and the port's four kernel ops (their plain versions on
    CPU tensors) against the port's serving path: all within 1e-5."""
    text, got = serving
    assert float(re.search(rf"max \|diff\| = {NUM}", text).group(1)) <= 1e-5
    assert set(got["cross_check"]) == {"decode", "prefill", "paged_decode", "paged_prefill"}
    assert max(got["cross_check"].values()) <= 1e-5
