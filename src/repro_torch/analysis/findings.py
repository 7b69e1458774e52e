"""Finding: one diagnostic from the AST lint or the graph audit.

Counterpart of ``repro.analysis.findings``. Both layers of
``repro_torch.analysis`` report through this one type, so the CLI, the
JSON report (``--json PATH``) and the tests consume a single shape.
``suppressed`` findings are kept in the report (a reader can diff what is
being waived) but never fail the run.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # "R001".."R006" (AST lint) or "A001".."A007" (graph audit)
    path: str  # repo-relative file, or the audited entry-point name
    line: int  # 1-based source line; 0 for whole-program audit findings
    message: str
    suppressed: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        sup = "  [suppressed]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{sup}"


def active(findings: list[Finding]) -> list[Finding]:
    """The findings that fail the run (non-suppressed)."""
    return [f for f in findings if not f.suppressed]
