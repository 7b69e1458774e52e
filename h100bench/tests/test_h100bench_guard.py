"""What the benchmark may load and read, and that a cell is added by new
files alone."""
import ast
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100bench"
sys.path.insert(0, str(ROOT))

from h100bench.lib import common  # noqa: E402


def imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def code_strings(path: Path) -> list[str]:
    """String constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    base = common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", types.ModuleType("x"))
    assert common.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "repro.serve", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert {"repro.serve", "jax"} <= set(common.forbidden_modules())


def test_sources_import_no_jax_and_the_reference_no_program():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        tops = {n.split(".")[0] for n in imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path
        for s in code_strings(path):
            assert not any(x in s for x in ("BENCH_serve", "chip_smoke", "benchmarks/")), path


STEADY = '''"""Arrivals at a steady rate: request i due at i / rate."""
from h100bench.arrivals.poisson import OpenLoop
from h100bench.lib.traffic import ServeStream


def source(params, seed, vocab, num_tasks, seconds):
    n = int(params["arrival"]["rate"] * seconds)
    specs = ServeStream(params, seed, vocab, num_tasks, pool=n).take(n)
    for i, s in enumerate(specs):
        s.due = i / params["arrival"]["rate"]
    return OpenLoop(specs)
'''


def test_a_cell_made_of_new_files_alone_runs(tmp_path):
    """A cell of OLMo-1B with the prefix cache on, shortest-first admission
    and arrivals of a kind of its own, added by a manifest entry, a traffic
    file, an arrival kind's file and a cell file, nothing else."""
    shutil.copytree(BENCH, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "olmo1b.tiny-steady", "config": "olmo-1b",
                                  "traffic": "tiny-steady", "chips": 1, "why": "a test cell"})
    for m in manifest["end_to_end"]:
        if m["name"] == "ttft_p95_s":
            m["workloads"].append("olmo1b.tiny-steady")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (tmp_path / "h100bench" / "arrivals" / "steady.py").write_text(STEADY)
    (tmp_path / "h100bench" / "traffic" / "tiny-steady.json").write_text(json.dumps({
        "arrival": {"kind": "steady", "rate": 4.0},
        "prompt": {"median": 6, "sigma": 0.5, "min": 2, "max": 12},
        "output": {"median": 6, "sigma": 0.5, "min": 2, "max": 12}, "tenants": None}))
    (tmp_path / "h100bench" / "cells" / "olmo1b.tiny-steady.json").write_text(json.dumps({
        "kind": "serve",
        "server": {"num_slots": 3, "prefill_chunk": 8, "max_seq": 96, "block_size": 8,
                   "pool_tokens": 640, "prefix_cache": True, "policy": "sjf"},
        "warmup_requests": 2, "check": {"sample_tokens": 30, "limits": {"logit_gap": 3e-4}},
        "rehearse": {}}))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "olmo1b.tiny-steady",
                        "--seed", "5", "--seconds", "4", "--trace", "0", "--rehearse"],
                       cwd=tmp_path, capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and {"ttft_p95_s", "setup_s"} <= set(res["metrics"])
    assert res["attempted"] == 16


def test_without_the_program_it_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "mtlm.train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
