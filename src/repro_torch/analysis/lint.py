"""AST lint runner: parse, run rules, honor suppressions.

Layer 1 of ``repro_torch.analysis``, the counterpart of
``repro.analysis.lint``. The runner owns everything that is not
hazard-detection: file discovery, parsing, suppression comments, and the
suppressed-flag on findings. Rules (in ``repro_torch.analysis.rules``) are
pure AST predicates.

Suppression syntax::

    x = table[ids]  # analysis: ignore[R001] -- why the ids are in range
    # analysis: ignore[R002, R003]   <- own-line form covers the NEXT line
    assert invariant

``# analysis: ignore`` with no bracket waives every rule on that line.
Suppressed findings stay in the JSON report (so a reader can diff what is
being waived) but do not fail the run.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import ALL_RULES

_SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*ignore(?:\[(?P<rules>[A-Za-z0-9,\s]+)\])?"
)


def collect_suppressions(source: str) -> dict[int, set[str]]:
    """line (1-based) -> set of suppressed rule ids ({"*"} = all rules).

    A trailing comment covers its own line; a comment alone on a line also
    covers the next non-blank, non-comment line (for statements too long to
    share a line with their waiver).
    """
    per_line: dict[int, set[str]] = {}
    own_line: list[int] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenizeError:
        return {}
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = m.group("rules")
        ids = (
            {r.strip().upper() for r in rules.split(",") if r.strip()}
            if rules else {"*"}
        )
        line = tok.start[0]
        per_line.setdefault(line, set()).update(ids)
        if tok.line.strip().startswith("#"):
            own_line.append(line)
    lines = source.splitlines()
    for line in own_line:
        for nxt in range(line + 1, len(lines) + 1):
            stripped = lines[nxt - 1].strip()
            if stripped and not stripped.startswith("#"):
                per_line.setdefault(nxt, set()).update(per_line[line])
                break
    return per_line


def _suppressed(finding: Finding, suppressions: dict[int, set[str]]) -> bool:
    ids = suppressions.get(finding.line)
    return ids is not None and ("*" in ids or finding.rule in ids)


def lint_source(
    source: str, path: str, rules=None
) -> list[Finding]:
    """Lint one source string; returns findings with ``suppressed`` set."""
    rules = ALL_RULES if rules is None else rules
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(
            rule="E000", path=path, line=e.lineno or 0,
            message=f"syntax error: {e.msg}",
        )]
    suppressions = collect_suppressions(source)
    findings: list[Finding] = []
    for rule in rules:
        if not rule.applies_to(path):
            continue
        for f in rule.check(tree, source, path):
            if _suppressed(f, suppressions):
                f = Finding(
                    rule=f.rule, path=f.path, line=f.line,
                    message=f.message, suppressed=True,
                )
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_file(path: Path, root: Path | None = None, rules=None) -> list[Finding]:
    # repo-relative paths keep the report diffable; targets outside the
    # repo (ad-hoc CLI invocations) fall back to their absolute path
    if root is not None and path.resolve().is_relative_to(root):
        rel = str(path.resolve().relative_to(root))
    else:
        rel = str(path)
    return lint_source(path.read_text(), rel, rules=rules)


def iter_python_files(target: Path):
    if target.is_file():
        yield target
        return
    yield from sorted(target.rglob("*.py"))


def lint_paths(
    targets: list[Path], root: Path | None = None, rules=None
) -> list[Finding]:
    """Lint every .py under each target (files or directories)."""
    findings: list[Finding] = []
    for target in targets:
        for path in iter_python_files(target):
            findings.extend(lint_file(path, root=root, rules=rules))
    return findings
