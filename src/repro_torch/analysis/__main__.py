"""CLI: ``python -m repro_torch.analysis [paths...]``.

Runs the AST lint over ``src/repro_torch`` (or the given paths) and the
graph audit over the serving entry points on ``--device`` (default
``cuda``: without a GPU it raises, as every entry point of the port does;
pass ``--device cpu`` to audit on the CPU), prints every finding,
optionally writes a JSON report (``--json PATH``; nothing is written
otherwise), and exits non-zero iff a non-suppressed finding remains.

``--probe ids`` runs only the audit's A003 probe (out-of-range ids) in
this process; the audit on CUDA runs it that way in a child process, so a
device-side assert ends the child and becomes a finding.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.findings import Finding, active
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.rules import ALL_RULES


def _repo_root() -> Path:
    # src/repro_torch/analysis/__main__.py -> repo root three levels above src/
    return Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST lint + graph audit for the port's serving stack",
    )
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--device", default="cuda",
                    help="where the audit runs (default cuda; cpu to run on the CPU)")
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="write the full report (incl. suppressed findings)")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--audit-only", action="store_true")
    ap.add_argument("--skip-retrace", action="store_true",
                    help="no serving runs (A001 and the replayed dispatch of A004)")
    ap.add_argument("--backends", nargs="+", default=["kernel", "plain"],
                    choices=["kernel", "plain"])
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--probe", choices=["ids"], default=None,
                    help="run one audit probe alone in this process")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.rule_id}  {rule.title}")
        return 0

    from repro_torch.kernels.runtime import require_device

    device = require_device(args.device)
    root = _repo_root()
    findings: list[Finding] = []
    report: dict = {}

    if args.probe == "ids":
        from repro_torch.analysis.graph_audit import probe_ids

        found, probe = probe_ids(device, tuple(args.backends))
        findings.extend(found)
        report["report"] = probe
        report["findings"] = [f.to_dict() for f in found]
    else:
        if not args.audit_only:
            targets = args.paths or [root / "src" / "repro_torch"]
            lint_findings = lint_paths(targets, root=root)
            findings.extend(lint_findings)
            report["lint"] = [f.to_dict() for f in lint_findings]
        if not args.lint_only:
            from repro_torch.analysis.graph_audit import run_audit

            audit_findings, audit_report = run_audit(
                device=device, backends=tuple(args.backends), retrace=not args.skip_retrace,
            )
            findings.extend(audit_findings)
            report["audit"] = {
                "report": audit_report,
                "findings": [f.to_dict() for f in audit_findings],
            }

    bad = active(findings)
    report["summary"] = {
        "findings": len(findings),
        "active": len(bad),
        "suppressed": len(findings) - len(bad),
    }
    for f in findings:
        print(f.format())
    if args.json is not None:
        args.json.write_text(json.dumps(report, indent=2, sort_keys=True, default=str))
        print(f"report written to {args.json}")
    if bad:
        print(f"FAILED: {len(bad)} non-suppressed finding(s)")
        return 1
    print(f"analysis clean ({report['summary']['suppressed']} suppressed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
