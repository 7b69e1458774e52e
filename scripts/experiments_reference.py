"""The JAX reference's numbers at ``chip_smoke.py`` phase 18's workloads: the
reference's ``benchmarks/`` paper scripts at ``chip_smoke.EXP_ARGS`` and its
five ``examples/``, on the CPU (float32, matmul precision "highest").

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/experiments_reference.py [--full]

Prints the JAX version and one JSON line, ``EXP_REF = {...}``, as
``chip_smoke.py`` holds it: per experiment the numbers its rows carry
(Figure 2's f*, population risks, final objectives and rounds to 1e-3;
Figure 3's risks and chosen sigma scales; Table 1's rows; the delay rows;
the ablation's final losses and adapter spreads) and per example the
numbers it prints (the training history as steps and losses). The LM
runs (the ablation, ``train_multitask_lm --full``, ``serve_batched``) start
from the weights the smoke gives the port: the port's seeded CPU init as a
JAX tree (``chip_smoke.exp_init_tree``), patched in for the JAX model's
``init``. The reference writes its CSVs into a temporary directory, not
into the repo. ``--full`` adds a second line, ``EXP_FULL = {...}``: Figure 2
at C in ``chip_smoke.EXP_FULL_CLUSTERS`` (``benchmarks/run.py --full``'s
sweep). Takes about 10 minutes on 8 CPU cores (``--full``: about 2 more),
most of it the 162.7 M-parameter example's 30 training steps.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import re
import runpy
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as smoke  # noqa: E402  (its top level imports the standard library only)

import benchmarks.common as bcommon  # noqa: E402
from benchmarks import (  # noqa: E402
    ablation_mtl_lm,
    delay_bench,
    fig2_erm,
    fig3_stochastic,
    table1_complexity,
)
from repro.models.model import TransformerLM as JaxLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as PortConfig  # noqa: E402
from repro_torch.models import TransformerLM as PortLM  # noqa: E402

_TREES: dict = {}


def port_weights(self, key):
    """The JAX model's init replaced by the smoke's initial weights for its
    config (the key is ignored: the reference's runs all use PRNGKey(0))."""
    cfg = self.cfg
    if cfg.name not in _TREES:
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(PortConfig)}
        port_cfg = PortConfig(**dict(fields, attn_backend="plain"))
        _TREES[cfg.name] = smoke.exp_init_tree(convert, PortLM, port_cfg)
    return jax.tree.map(jnp.asarray, _TREES[cfg.name])


def captured(fn):
    """fn()'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def example(name, argv=()):
    """Run examples/<name>.py as a script; its globals and its output."""
    sys.argv = [f"{name}.py", *argv]
    return captured(lambda: runpy.run_path(str(ROOT / "examples" / f"{name}.py")))


def fig2_numbers(rows):
    return {"f_star": next(r[4] for r in rows if r[0] == "centralized"),
            "rows": {f"{r[0]}/{r[1]}": [r[3], r[4], r[5]] for r in rows}}


def experiments() -> dict:
    out = {}
    rows = fig2_erm.main(smoke.EXP_ARGS["fig2_erm"])
    out["fig2_erm"] = fig2_numbers(rows)
    rows, text = captured(lambda: fig3_stochastic.main(smoke.EXP_ARGS["fig3_stochastic"]))
    out["fig3_stochastic"] = {
        "rows": {f"{r[0]}/{r[1]}": r[3] for r in rows},
        "sigma_scale": {b: float(s) for b, s in
                        re.findall(r"ssr b=\s*(\d+) .*\(sigma_scale=([0-9.e-]+)\)", text)},
    }
    rows = table1_complexity.main(smoke.EXP_ARGS["table1_complexity"])
    out["table1_complexity"] = {"rows": {r[0]: [r[1], r[2], r[3]] for r in rows}}
    rows = delay_bench.main(smoke.EXP_ARGS["delay_bench"])
    out["delay_bench"] = {"rows": {str(r[0]): r[1:] for r in rows}}
    rows = ablation_mtl_lm.main(smoke.EXP_ARGS["ablation_mtl_lm"])
    out["ablation_mtl_lm"] = {"rows": {r[0]: r[1:] for r in rows}}
    return out


def examples() -> dict:
    out = {}
    g, _ = example("quickstart")
    p, x, y = g["problem"], g["x"], g["y"]
    out["quickstart"] = {
        "rho": g["theory"].rho(g["tasks"].graph, g["B"], g["S"]), "eta": g["eta"],
        "tau": g["tau"], "f_star": g["f_star"],
        "methods": {name: [g["tasks"].population_risk(np.asarray(w)),
                           float(p.erm_objective(w, x, y))]
                    for name, w in [("local", g["w_local"]), ("centralized", g["w_cent"]),
                                    ("BSR (batch, solve regularizer)", g["res_bsr"].w),
                                    ("BOL (batch, optimize loss)", g["res_bol"].w)]},
    }
    _, text = example("consensus_vs_multitask")
    out["consensus_vs_multitask"] = {
        "consensus_spread": float(re.search(r"averaging steps: (\S+)", text).group(1)),
        "spreads": [[float(a), float(b), float(c)] for a, b, c in re.findall(
            r"tau=\s*(\S+)\s+spread\(optimum\)=(\S+)\s+spread\(BOL\)=(\S+)", text)],
        "limit": [[int(a), float(b)]
                  for a, b in re.findall(r"tau=\s*(\d+)\s+\|\|M.*= (\S+)", text)],
    }
    g, _ = example("learn_the_graph")
    a = g["g_learn"].adjacency
    out["learn_the_graph"] = {
        "risks": {name: g["tasks"].population_risk(np.asarray(w))
                  for name, w in [("oracle graph", g["w_oracle"]), ("no coupling", g["w_lone"]),
                                  ("learned graph", g["w_learn"])]},
        "within": float(a[g["same"]].mean()), "across": float(a[g["off"]].mean()),
        "history": g["hist"],
    }
    g, _ = example("train_multitask_lm", smoke.EXP_TRAIN_ARGS)
    out["train_multitask_lm"] = {
        "params": g["n_params"], "spread": g["spread"], "neighbor": g["neighbor"],
        "history": [{"step": h["step"], "loss": h["loss"]} for h in g["history"]]}
    g, _ = example("serve_batched")
    out["serve_batched"] = {
        "first_continuation": [int(t) for t in g["out"][0][:16]],
        "ticks": g["batcher"].ticks, "decode_dispatches": g["batcher"].decode_dispatches,
        "prefill_dispatches": g["batcher"].prefill_dispatches,
        "free_blocks": g["paged"].allocator.free_blocks,
        "mixed_dispatches": g["sla"].mixed_dispatches, "streamed": len(g["streamed"]),
        "cancelled_emitted": len({r.uid: r for r in g["done_sla"]}[3].out),
        **{k: g["stats"][k] for k in ("hit_ratio", "hit_tokens", "lookup_tokens",
                                      "cow_copies", "prefill_tokens")},
        **{k: bool(g[v]) for k, v in (("batcher_match", "match"), ("paged_match", "paged_match"),
                                      ("scan_match", "scan_match"),
                                      ("kernel_match", "flash_match"),
                                      ("sla_match", "sla_match"), ("prefix_match", "px_match"))},
        "decode_err": float(g["err"]),
    }
    return out


def clean(obj):
    """JSON-ready: numpy scalars as Python numbers, NaN as None."""
    if isinstance(obj, dict):
        return {str(k): clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [clean(v) for v in obj]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return None if obj != obj else float(obj)
    return obj


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also Figure 2 at every cluster count of the full sweep")
    args = ap.parse_args()
    JaxLM.init = port_weights
    with tempfile.TemporaryDirectory() as tmp, jax.default_matmul_precision("highest"):
        bcommon.REPORTS = tmp
        t0 = time.perf_counter()
        ref = {**captured(experiments)[0], **examples()}
        seconds = time.perf_counter() - t0
        full = None
        if args.full:
            t0 = time.perf_counter()
            clusters = [str(c) for c in smoke.EXP_FULL_CLUSTERS]
            rows, _ = captured(lambda: fig2_erm.main(
                smoke.EXP_SIZE + ["--iters", "300", "--clusters", *clusters]))
            full = {"rows": fig2_numbers(rows)["rows"],
                    "f_star": {str(r[1]): r[4] for r in rows if r[0] == "centralized"},
                    "seconds": time.perf_counter() - t0}
    print(f"# JAX {jax.__version__}, CPU, float32; {seconds:.1f} s")
    print("EXP_REF = " + json.dumps(clean(ref)))
    if full is not None:
        print("EXP_FULL = " + json.dumps(clean(full)))


if __name__ == "__main__":
    main()
