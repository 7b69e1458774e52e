"""The port stands alone: no module of src/repro_torch, and not
chip_smoke.py, imports jax, jaxlib or the JAX package repro — checked on
the source (every import statement) and at run time (importing the serving
stack, the paper's core and data, the training stack, the analysis, the
experiments or the examples loads no jax)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_sources_import_no_jax_or_repro():
    files = _port_files()
    assert len(files) > 10
    bad = [
        f"{p.relative_to(ROOT)}:{line} imports {mod}"
        for p in files
        for mod, line in _imported_roots(p)
        if mod in FORBIDDEN
    ]
    assert bad == []


def test_importing_the_serving_stack_loads_no_jax():
    code = (
        "import sys, repro_torch.serve, repro_torch.models, repro_torch.convert; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_importing_the_paper_core_and_data_loads_no_jax():
    code = (
        "import sys, repro_torch.core, repro_torch.data, repro_torch.configs; "
        "repro_torch.configs.get('multitask_linreg'); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_importing_the_training_stack_loads_no_jax():
    code = (
        "import sys, repro_torch.train, repro_torch.optim, repro_torch.checkpoint, "
        "repro_torch.launch.train, repro_torch.data.tokens, repro_torch.core.distributed; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_importing_the_analysis_loads_no_jax():
    code = (
        "import sys, repro_torch.analysis, repro_torch.analysis.graph_audit, "
        "repro_torch.analysis.__main__; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_importing_the_experiments_and_examples_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, repro_torch.experiments, repro_torch.examples; "
        "[importlib.import_module(f'{pkg.__name__}.{m.name}') "
        " for pkg in (repro_torch.experiments, repro_torch.examples) "
        " for m in pkgutil.iter_modules(pkg.__path__) if m.name != '__main__']; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
