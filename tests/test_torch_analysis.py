"""Tests for repro_torch.analysis, the port's counterpart of
tests/test_analysis.py: the AST lint rules R001-R006 (each with flagged,
accepted and suppressed cases, as the reference's), the suppression forms,
the port itself lint-clean, seeded regressions through the CLI (a copy of a
port module with one clamp removed, one assert inserted, one ``.item()``
in a step body, one ``except Exception: pass``: each exits 1 naming its
rule), the CLI contract (exit 0 and a JSON report where ``--json`` says;
without a GPU and without ``--device cpu`` it raises), and the graph audit
on the CPU at smoke size: A002 op counts equal at chunks 4 and 8, A003
live rows bit-identical under out-of-range ids, A005 pointers and
versions, A006 one copy per pool, one graph_mix call per dtype group. The
checks that need the card (A001 captures, A004 copies, A007, the ids probe
in a child process) are in tests/test_torch_cuda_analysis.py. Imports no
JAX."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from repro_torch.analysis import graph_audit  # noqa: E402
from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.analysis.findings import active  # noqa: E402
from repro_torch.analysis.lint import collect_suppressions, lint_paths, lint_source  # noqa: E402
from repro_torch.analysis.rules import ALL_RULES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CORE = "src/repro_torch/core/example.py"  # no scoped rule applies here
SERVE = "src/repro_torch/serve/example.py"
MODELS = "src/repro_torch/models/example.py"
KERNELS = "src/repro_torch/kernels/example/ops.py"
STEP = "src/repro_torch/models/attention.py"  # its cached_attend is on the step path


def rules_of(findings, only_active=True):
    fs = active(findings) if only_active else findings
    return [f.rule for f in fs]


def lint(snippet: str, path: str = CORE):
    return lint_source(textwrap.dedent(snippet), path)


# ------------------------------------------------------------------- R001
@pytest.mark.parametrize("gather", [
    "table[task_ids]",
    "F.embedding(tokens, table)",
    "torch.gather(table, 1, ids)",
    "table.index_select(0, ids)",
    "torch.take_along_dim(table, ids, dim=1)",
])
def test_r001_flags_unclamped_runtime_gathers(gather):
    fs = lint(f"""
        import torch
        import torch.nn.functional as F
        def f(table, task_ids, tokens, ids):
            return {gather}
    """, path=MODELS)
    assert rules_of(fs) == ["R001"]


def test_r001_flags_index_put_on_a_raw_index():
    fs = lint("""
        import torch
        def write(pool, new, pos):
            rows = pos.long() + 1
            pool.index_put_((rows,), new)
    """, path=SERVE)
    assert rules_of(fs) == ["R001"]


def test_r001_accepts_clamped_bounded_and_literal_indices():
    fs = lint("""
        import torch
        import torch.nn.functional as F
        def f(table, task_ids, tokens, pos, n):
            ids = tokens.clamp(0, table.shape[0] - 1)
            a = F.embedding(ids, table)
            b = table[task_ids.long().clamp(0, n)]
            c = table[3]
            d = table[torch.arange(4), torch.remainder(pos, n)]
            order = torch.argsort(pos)
            e = pos.gather(0, order)
            idx = ids
            idx = torch.where(pos > 0, idx, 0)
            g = table[idx]
            return a, b, c, d, e, g
    """, path=MODELS)
    assert rules_of(fs) == []


def test_r001_only_applies_under_serve_models_kernels():
    fs = lint("""
        def f(table, task_ids):
            return table[task_ids]
    """)
    assert rules_of(fs) == []


def test_r001_suppression_comment():
    fs = lint("""
        def f(table, ids):
            return table[ids]  # analysis: ignore[R001] -- ids validated upstream
    """, path=MODELS)
    assert rules_of(fs) == []
    assert rules_of(fs, only_active=False) == ["R001"]
    assert fs[0].suppressed


# ------------------------------------------------------------------- R002
def test_r002_flags_bare_assert_in_serve():
    fs = lint("""
        def free(self, b):
            assert b not in self._free, "double free"
    """, path=SERVE)
    assert rules_of(fs) == ["R002"]


def test_r002_ignores_other_trees_and_typed_raises():
    snippet = """
        def free(self, b):
            assert b not in self._free
    """
    assert rules_of(lint(snippet, path=CORE)) == []
    fs = lint("""
        def free(self, b):
            if b in self._free:
                raise RuntimeError(f"double free of block {b}")
    """, path=SERVE)
    assert rules_of(fs) == []


def test_r002_allowlists_kernel_shape_contracts():
    fs = lint("""
        def op(q, k):
            assert q.shape == k.shape
            assert q.dtype == k.dtype
    """, path=KERNELS)
    assert rules_of(fs) == []
    fs = lint("""
        def op(n):
            assert n > 0
    """, path=KERNELS)
    assert rules_of(fs) == ["R002"]


def test_r002_suppression_own_line_covers_next_line():
    fs = lint("""
        def free(self, b):
            # analysis: ignore[R002] -- exercised by every test run
            assert b not in self._free
    """, path=SERVE)
    assert rules_of(fs) == []
    assert [f.rule for f in fs] == ["R002"] and fs[0].suppressed


# ------------------------------------------------------------------- R003
@pytest.mark.parametrize("draw", [
    "torch.randn(3)",
    "torch.multinomial(probs, 1)",
    "torch.randint(0, 5, (3,))",
    "torch.rand_like(probs)",
    "probs.normal_()",
    "probs.bernoulli()",
])
def test_r003_flags_draws_from_the_default_generator(draw):
    fs = lint(f"""
        import torch
        def sample(probs):
            return {draw}
    """)
    assert rules_of(fs) == ["R003"]


def test_r003_accepts_explicit_generators_and_numpy_generators():
    fs = lint("""
        import numpy as np
        import torch
        def sample(probs, seed):
            gen = torch.Generator().manual_seed(seed)
            rng = np.random.default_rng(seed)
            a = torch.multinomial(probs, 1, generator=gen)
            b = torch.randn(3, generator=gen)
            c = probs.normal_(generator=gen)
            d = rng.normal(size=3)
            return a, b, c, d
    """)
    assert rules_of(fs) == []


def test_r003_suppression():
    fs = lint("""
        import torch
        def noise(x):
            return x + torch.randn(x.shape)  # analysis: ignore[R003] -- test noise only
    """)
    assert rules_of(fs) == []
    assert [f.rule for f in fs] == ["R003"] and fs[0].suppressed


# ------------------------------------------------------------------- R004
@pytest.mark.parametrize("body", [
    "n = live.sum().item()",
    "if live.any():\n                q = q * 2",
    "k = int(pos[0])",
    "host = q.cpu()",
    "rows = torch.nonzero(live)",
    "while pos.max() > 3:\n                pos = pos - 1",
])
def test_r004_flags_host_syncs_in_a_step_function(body):
    fs = lint(f"""
        import torch
        def cached_attend(q, k_cache, v_cache, pos, live=None, backend="kernel"):
            {body}
            return q
    """, path=STEP)
    assert rules_of(fs) == ["R004"]


def test_r004_accepts_host_level_tests():
    fs = lint("""
        import torch
        def cached_attend(q, k_cache, v_cache, pos, *, sliding_window=None,
                          backend="kernel", block_tables=None):
            if block_tables is None and backend == "plain":
                q = q * 1
            if q.shape[1] == 1:
                q = q + 0
            s = k_cache.shape[1]
            if s % 2:
                q = q - 0
            if sliding_window is not None:
                q = torch.where(pos[:, None, None, None] > 0, q, 0.0)
            return q
    """, path=STEP)
    assert rules_of(fs) == []


def test_r004_nested_def_in_a_step_function_is_in_scope():
    fs = lint("""
        def _step_bodies(model, prefill_mode):
            def decode_tick(tokens, task_ids, caches, positions, live):
                logits = model.decode_step(tokens, caches, positions, live)
                return logits.argmax().item()
            return decode_tick
    """, path="src/repro_torch/serve/step.py")
    assert rules_of(fs) == ["R004"]


def test_r004_ignores_functions_off_the_step_path():
    fs = lint("""
        import numpy as np
        import torch
        def reset_slot_state(self, caches, reset, paging=None):
            rows = np.flatnonzero(torch.as_tensor(reset).cpu().numpy())
            return rows
    """, path="src/repro_torch/models/model.py")
    assert rules_of(fs) == []


def test_r004_suppression():
    fs = lint("""
        import torch
        def cached_attend(q, k_cache, v_cache, pos):
            # analysis: ignore[R004] -- a CPU scalar, no device sync
            root = float(torch.tensor(2.0).sqrt())
            return q / root
    """, path=STEP)
    assert rules_of(fs) == []
    assert [f.rule for f in fs] == ["R004"] and fs[0].suppressed


# ------------------------------------------------------------------- R005
@pytest.mark.parametrize("product", [
    "torch.matmul(x, w)",
    "x @ w",
    'torch.einsum("bd,df->bf", x, w)',
    "torch.bmm(x, w)",
    "F.linear(x, w)",
])
def test_r005_flags_contractions_not_shown_float32(product):
    fs = lint(f"""
        import torch
        import torch.nn.functional as F
        def f(x, w):
            return {product}
    """, path=MODELS)
    assert rules_of(fs) == ["R005"]


def test_r005_accepts_float32_operands_and_other_trees():
    fs = lint("""
        import torch
        from repro_torch.models.layers import matmul
        def f(x, w, state):
            a = torch.matmul(x.float(), w.float())
            xf = x.to(torch.float32)
            b = torch.einsum("bd,df->bf", xf * 2, w.to(dtype=torch.float32))
            s = torch.zeros((3, 3), dtype=torch.float32)
            for _ in range(3):
                s = s * 0.5 + torch.bmm(xf, xf)
            c = matmul(x, w)
            return a, b, c, s
    """, path=MODELS)
    assert rules_of(fs) == []
    assert rules_of(lint("""
        import torch
        def f(x, w):
            return torch.matmul(x, w)
    """, path=CORE)) == []


def test_r005_suppression():
    fs = lint("""
        import torch
        def f(x, w):
            return torch.matmul(x, w)  # analysis: ignore[R005] -- float32 by construction
    """, path=MODELS)
    assert rules_of(fs) == []


# ------------------------------------------------------------------- R006
@pytest.mark.parametrize("handler", ["except:\n                pass",
                                     "except (ValueError, Exception):\n                ..."])
def test_r006_flags_bare_and_broad_silent_excepts(handler):
    fs = lint(f"""
        def retire(self, uid):
            try:
                self._free(uid)
            {handler}
    """, path=SERVE)
    assert rules_of(fs) == ["R006"]


def test_r006_accepts_typed_and_acting_handlers():
    fs = lint("""
        def retire(self, uid):
            try:
                self._free(uid)
            except FaultError:
                self.retire_faults += 1
            try:
                self._free(uid)
            except Exception as e:
                self.errors.append(e)  # broad, but observable
    """, path=SERVE)
    assert rules_of(fs) == []


def test_r006_only_applies_under_serve_or_kernels():
    fs = lint("""
        def f():
            try:
                g()
            except:
                pass
    """)
    assert rules_of(fs) == []


def test_r006_suppression():
    fs = lint("""
        def f(self):
            try:
                g()
            except Exception:  # analysis: ignore[R006]
                pass
    """, path=SERVE)
    assert [f.rule for f in fs] == ["R006"] and fs[0].suppressed


# ------------------------------------------------- suppression machinery
def test_collect_suppressions_forms():
    sup = collect_suppressions(textwrap.dedent("""
        x = 1  # analysis: ignore[R001]
        # analysis: ignore[R002, R003]
        y = 2
        z = 3  # analysis: ignore
    """))
    assert sup[2] == {"R001"}
    assert sup[4] == {"R002", "R003"}  # own-line comment covers next line
    assert sup[5] == {"*"}


def test_every_rule_listed_once():
    assert [r.rule_id for r in ALL_RULES] == [f"R00{i}" for i in range(1, 7)]


# ----------------------------------------------------- the port is clean
def test_port_is_lint_clean():
    fs = lint_paths([ROOT / "src" / "repro_torch"], root=ROOT)
    assert active(fs) == [], "\n".join(f.format() for f in active(fs))
    # every waiver says why
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            if "analysis: ignore[" in line and "analysis/" not in str(path):
                assert " -- " in line, f"{path}: {line.strip()}"


# ------------------------------------------------------------- CLI contract
def _seed(src: str, old: str, new: str):
    assert old in src, old
    return src.replace(old, new, 1)


SEEDS = {
    "R001": ("models/model.py", lambda s: _seed(
        s, 'ids = batch["tokens"].clamp(0, c.vocab_size - 1)', 'ids = batch["tokens"]')),
    "R002": ("serve/step.py", lambda s: _seed(
        s, "    def cow_copy(caches, src: int, dst: int, rows: int):\n",
        "    def cow_copy(caches, src: int, dst: int, rows: int):\n"
        "        assert src != dst\n")),
    "R004": ("serve/step.py", lambda s: _seed(
        s, "        step_logits = logits[:, 0]  # (B, V) f32, (B, K, V) for audio\n",
        "        step_logits = logits[:, 0]  # (B, V) f32, (B, K, V) for audio\n"
        "        assert step_logits.abs().max().item() < 1e9\n")),
    "R006": ("serve/faults.py", lambda s: s + (
        "\n\ndef _swallow(fn):\n    try:\n        fn()\n    except Exception:\n"
        "        pass\n")),
}


@pytest.mark.parametrize("rule", list(SEEDS))
def test_cli_seeded_regressions_fail_with_rule_id(rule, tmp_path, capsys):
    """A copy of a port module, under the package's own layout, lints clean;
    with one seeded change it exits 1 naming the rule."""
    rel, seed = SEEDS[rule]
    original = (ROOT / "src" / "repro_torch" / rel).read_text()
    copy = tmp_path / "src" / "repro_torch" / rel
    copy.parent.mkdir(parents=True)
    copy.write_text(original)
    assert main(["--lint-only", "--device", "cpu", str(copy)]) == 0
    capsys.readouterr()
    copy.write_text(seed(original))
    assert main(["--lint-only", "--device", "cpu", str(copy)]) == 1
    out = capsys.readouterr().out
    assert f" {rule} " in out, out


def test_cli_lint_and_audit_on_the_cpu_exit_zero_and_write_json(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu", "--json", str(out)],
        capture_output=True, text=True, cwd=tmp_path, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["summary"]["active"] == 0
    assert report["summary"]["suppressed"] == len(report["lint"]) > 0
    assert report["audit"]["report"]["device"] == "cpu"
    assert "A006" in report["audit"]["report"]["checks"]
    assert not (ROOT / "src" / "ANALYSIS_report.json").exists()


def test_cli_without_a_gpu_raises_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--lint-only"])
    assert main(["--list-rules"]) == 0
    assert "R006" in capsys.readouterr().out


# ------------------------------------------------------------ graph audit
@pytest.fixture(scope="module")
def olmo():
    return graph_audit.audit_model("olmo_1b", "kernel", torch.device("cpu"))


@pytest.fixture(scope="module")
def spec():
    return graph_audit.audit_spec()


@pytest.mark.parametrize("paged", [False, True])
def test_audit_prefill_ops_equal_at_chunks_4_and_8(olmo, spec, paged):
    findings, report = graph_audit.audit_op_counts(olmo, spec if paged else None)
    assert findings == [], [f.format() for f in findings]
    assert report["prefill_ops_c4"] == report["prefill_ops_c8"] < report["scan_ops_c8"]
    assert report["decode_ops_[2, 5]"] == report["decode_ops_[7, 11]"]


@pytest.mark.parametrize("paged", [False, True])
def test_audit_out_of_range_ids_leave_live_rows_bit_identical(olmo, spec, paged):
    findings, report = graph_audit.audit_ids(olmo, spec if paged else None)
    assert findings == [], [f.format() for f in findings]
    assert report["prefill"] == report["decode"] == {"finite": True, "bit_identical": True}


def test_audit_ids_catches_a_missing_clamp(olmo, monkeypatch):
    """A003 against a model whose task-row gather lost its clamp: the probe
    reports the raise as a finding."""
    monkeypatch.setattr(olmo, "_task_rows", lambda table, ids: table[ids])
    findings, _ = graph_audit.audit_ids(olmo, None)
    assert [f.rule for f in findings] == ["A003"]


@pytest.mark.parametrize("arch", ["olmo_1b", "zamba2_7b"])
@pytest.mark.parametrize("paged", [False, True])
def test_audit_caches_stay_in_place(arch, paged, spec):
    model = graph_audit.audit_model(arch, "kernel", torch.device("cpu"))
    findings, report = graph_audit.audit_in_place(model, spec if paged else None)
    assert findings == [], [f.format() for f in findings]
    for step in ("prefill", "decode"):
        assert report[step] == {"host_data_tensors": 0, "unwritten_entries": 0}
    recurrent = sum(k == "mamba" for k in model.kinds) * 2
    assert report["reset_entries"] == (recurrent if paged else 2 * len(model.kinds))


def test_audit_in_place_catches_a_copied_cache(olmo, monkeypatch):
    """A005 against a dense write that rebinds instead of writing in place."""
    from repro_torch.models.model import TransformerLM

    def out_of_place(cache, new, pos, live=None):
        return cache.clone()

    monkeypatch.setattr(TransformerLM, "_cache_write", staticmethod(out_of_place))
    findings, _ = graph_audit.audit_in_place(olmo, None)
    assert {f.rule for f in findings} == {"A005"}


def test_audit_cow_is_one_copy_per_pool(olmo, spec):
    findings, report = graph_audit.audit_cow(olmo, spec)
    assert findings == [], [f.format() for f in findings]
    pools = 2 * olmo.cfg.num_layers
    assert report["rows1"] == report["rows3"] == {"copies": pools, "pools": pools}


def test_audit_graph_mix_is_one_call_per_dtype_group():
    findings, report = graph_audit.audit_graph_mix(torch.device("cpu"))
    assert findings == [], [f.format() for f in findings]
    assert report["graph_mix_calls"] == report["dtype_groups"] == 2


def test_audit_serving_run_and_pos_flavors_on_the_cpu(olmo, spec):
    findings, report = graph_audit.audit_captures(olmo, spec)
    assert findings == [] and report["finished"] == 3
    assert report["captures"].startswith("eager")  # no CUDA graph off CUDA
    findings, report = graph_audit.audit_pos_flavors(torch.device("cpu"))
    assert findings == [] and all(report.values()) and len(report) == 5


def test_op_counter_sees_a_per_token_loop():
    """The walker's twin: the counter behind A002 counts a loop's ops once
    per iteration."""
    x = torch.ones(4)
    with graph_audit.OpCounter() as one:
        x * 2
    with graph_audit.OpCounter() as loop:
        for _ in range(3):
            x * 2
    assert (one.total, loop.total) == (1, 3)
