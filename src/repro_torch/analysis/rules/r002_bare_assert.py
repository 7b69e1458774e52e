"""R002 — no bare ``assert`` on serving/kernel runtime paths.

The reference's rule as it is. ``python -O`` strips every ``assert``
statement. The port's allocator invariants in ``serve/paging.py``
(double-free and foreign-block detection: a block id reaching the free
list twice is later handed to TWO live slots whose K/V writes silently
corrupt each other), the slot-binding invariants in ``serve/slots.py`` and
the executor's checks in ``serve/step.py`` must survive optimized
deployments, so runtime invariants in ``serve/`` and ``kernels/`` raise
typed exceptions (``ValueError`` / ``RuntimeError``).

Allowlisted: shape-contract asserts inside ``kernels/`` (tests such as
``assert q.shape == (...)``): they check the wrappers' host-side shapes,
which every run of the test suite exercises, and keep the wrappers
readable. The allowlist requires the test to mention ``.shape`` /
``.ndim`` / ``.dtype``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

_SHAPE_ATTRS = {"shape", "ndim", "dtype"}


def _is_shape_contract(test: ast.expr) -> bool:
    return any(
        isinstance(n, ast.Attribute) and n.attr in _SHAPE_ATTRS
        for n in ast.walk(test)
    )


class BareAssertRule:
    rule_id = "R002"
    title = "bare assert in serve//kernels/ runtime path (stripped by -O)"

    def applies_to(self, path: str) -> bool:
        p = path.replace("\\", "/")
        return "/serve/" in p or "/kernels/" in p

    def check(self, tree: ast.AST, source: str, path: str) -> list[Finding]:
        p = path.replace("\\", "/")
        in_kernels = "/kernels/" in p
        findings = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assert):
                continue
            if in_kernels and _is_shape_contract(node.test):
                continue  # allowlisted kernel shape contract
            findings.append(Finding(
                rule=self.rule_id, path=path, line=node.lineno,
                message=(
                    "bare assert on a runtime path — stripped under "
                    "python -O, so the invariant silently disappears in "
                    "optimized deployments; raise ValueError/RuntimeError "
                    "instead (kernel shape-contract asserts are allowlisted)"
                ),
            ))
        return findings
