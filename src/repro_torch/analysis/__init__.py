"""repro_torch.analysis — mechanized correctness invariants for the port's
serving stack; the counterpart of ``repro.analysis``.

Two layers:

* **AST lint** (``repro_torch.analysis.lint`` + ``repro_torch.analysis.rules``)
  — source rules R001-R006, each the reference's bug class re-expressed for
  torch: clamped ids before a gather, no bare asserts on runtime paths, no
  draw from the default generator, no host sync inside a captured step,
  float32 accumulation in contractions, no swallowed exceptions.
* **graph audit** (``repro_torch.analysis.graph_audit``) — runs the real
  serving entry points: one CUDA-graph capture per step kind, no per-token
  loop in the parallel prefill, clamped ids at run time, no hidden
  host->device copies, in-place cache writes, the fused copy-on-write, no
  host sync in a step, one graph-mix launch per dtype group.

CLI: ``python -m repro_torch.analysis`` — exits non-zero iff a
non-suppressed finding remains, and writes a JSON report only where
``--json`` says.
"""
from repro_torch.analysis.findings import Finding, active
from repro_torch.analysis.graph_audit import run_audit
from repro_torch.analysis.lint import lint_paths, lint_source

__all__ = ["Finding", "active", "lint_paths", "lint_source", "run_audit"]
