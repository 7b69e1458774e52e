"""R006 — no swallowed exceptions on serve//kernels/ runtime paths.

The reference's rule as it is. The port's fault-tolerance layer
(``serve/faults.py``, the copy of the reference's ``FaultPlan``, and the batcher's
seams, quarantine, retry and preemption) works because every fault
SURFACES: injected ``FaultError``s are caught at named seams
that retry, requeue, or terminally fail the affected request — and the
chaos tests assert the engine's bookkeeping reconciles afterwards
(``check_invariants()``). A bare ``except:`` or an
``except Exception: pass`` swallows precisely the faults that machinery
exists to handle: an allocator error absorbed silently on the admission
path leaks refcounted blocks with no signal until the pool is
mysteriously empty, and a swallowed dispatch error turns a retryable
fault into silent token loss. Runtime handlers must either name the
exception type they expect (``except FaultError:``) or do something
observable with what they catch.

Flagged:

  * ``except:`` — bare, catches everything including ``KeyboardInterrupt``
    and ``SystemExit``; always flagged regardless of body.
  * ``except Exception:`` / ``except BaseException:`` (bound or not, alone
    or inside a tuple) whose body is ONLY ``pass`` / ``...`` — a broad
    catch that does nothing with the exception.

Not flagged: typed handlers, and broad handlers that act on the
exception (log it, count it, re-raise, return an error value).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

_BROAD = {"Exception", "BaseException"}


def _is_broad(type_node: ast.expr | None) -> bool:
    if type_node is None:
        return False
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(elt) for elt in type_node.elts)
    return False


def _body_is_silent(body: list[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis
        ):
            continue
        return False
    return True


class SwallowedExceptRule:
    rule_id = "R006"
    title = "swallowed exception in serve//kernels/ runtime path"

    def applies_to(self, path: str) -> bool:
        p = path.replace("\\", "/")
        return "/serve/" in p or "/kernels/" in p

    def check(self, tree: ast.AST, source: str, path: str) -> list[Finding]:
        findings = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(Finding(
                    rule=self.rule_id, path=path, line=node.lineno,
                    message=(
                        "bare `except:` on a runtime path — it catches "
                        "everything (KeyboardInterrupt included) and hides "
                        "exactly the faults the serving engine's "
                        "fault-tolerance machinery must see; name the "
                        "expected exception type (e.g. FaultError)"
                    ),
                ))
            elif _is_broad(node.type) and _body_is_silent(node.body):
                findings.append(Finding(
                    rule=self.rule_id, path=path, line=node.lineno,
                    message=(
                        "`except Exception: pass` on a runtime path — a "
                        "broad catch that does nothing turns retryable "
                        "faults into silent state corruption (leaked "
                        "blocks, lost tokens); either narrow the type or "
                        "act on the exception (count, log, re-raise)"
                    ),
                ))
        return findings
