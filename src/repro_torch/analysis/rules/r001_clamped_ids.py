"""R001 — a runtime-index gather must take clamped (or literal) indices.

The reference's R001 asks every ``jnp.take`` on runtime indices for an
explicit ``mode=``, because JAX's default fills out-of-bounds rows with NaN
under jit: the reference's worst serving bug, where dead lanes carried
the null task id one past the task tables and the NaN rows poisoned live
rows through the MoE buffers. Torch has no fill mode: an out-of-range index
raises on the CPU and, on CUDA, trips a device-side assert that ends the
process and every request it serves. The bug class is the same (an id
from an untrusted or dead lane reaching a gather), so the rule is the
same: the port clamps token ids, task and adapter ids, block-table
columns and paged reads (``models/model.py`` ``_embed``, ``_task_rows``,
``_gather_adapters``; ``kernels/runtime.gather_pages``).

Flagged, under ``serve/``, ``models/`` and ``kernels/``: a gather
(``index_select``, ``torch.gather`` / ``.gather``, ``F.embedding``,
``take_along_dim``, ``index_put_``, ``index_copy_``, ``index_fill_``,
``index_add_``, ``scatter_`` / ``scatter_add_``, or subscripting a tensor
with a tensor) whose index is a runtime tensor that the same function does
not bound. An index is bounded when it is a literal, or when the
expression, or a value its names are bound to in the function, goes
through one of ``BOUNDING_CALLS``: a clamp (``.clamp(``, ``clamp_``,
``clip``), a wrap (``remainder``, ``%``), a range (``arange``), a
permutation (``argsort``), or a helper that clamps (``_physical``,
``_task_rows``). Everything else carries a suppression with its reason,
for example an index the surrounding code proves in range.

Indices of unknown type (a parameter, a loop variable) are not flagged:
the rule cannot tell a host int from a tensor there, and the callers'
indices are checked at their own sites.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import (
    assignments,
    dotted_name,
    get_keyword,
    is_literal_index,
    is_tensor_expr,
    own_nodes,
    scoped_functions,
)

BOUNDING_CALLS = {"clamp", "clamp_", "clip", "clip_", "remainder", "arange", "argsort",
                  "_physical", "_task_rows"}
# gather -> (positional index of the index argument, its keyword)
_METHOD_GATHERS = {
    "gather": (1, "index"), "index_select": (1, "index"), "take_along_dim": (0, "indices"),
    "index_put_": (0, "indices"), "index_put": (0, "indices"), "index_copy_": (1, "index"),
    "index_fill_": (1, "index"), "index_add_": (1, "index"), "scatter_": (1, "index"),
    "scatter_add_": (1, "index"), "scatter": (1, "index"), "scatter_add": (1, "index"),
}
_FUNCTION_GATHERS = {
    "torch.gather": (2, "index"), "torch.index_select": (2, "index"),
    "torch.take_along_dim": (1, "indices"), "F.embedding": (0, "input"),
    "torch.nn.functional.embedding": (0, "input"), "torch.embedding": (1, "indices"),
}


def _index_arg(call: ast.Call):
    """(gather name, index expression) of a gather call, else None."""
    name = dotted_name(call.func)
    spec = _FUNCTION_GATHERS.get(name or "")
    if spec is None and isinstance(call.func, ast.Attribute) and name not in _FUNCTION_GATHERS:
        if call.func.attr in _METHOD_GATHERS and not (name or "").startswith("torch."):
            spec = _METHOD_GATHERS[call.func.attr]
            name = f".{call.func.attr}"
    if spec is None:
        return None
    pos, kw = spec
    idx = get_keyword(call, kw)
    if idx is None and len(call.args) > pos:
        idx = call.args[pos]
    return (name, idx) if idx is not None else None


class ClampedIdsRule:
    rule_id = "R001"
    title = "runtime-index gather in serve//models//kernels/ without a clamp"

    def applies_to(self, path: str) -> bool:
        p = path.replace("\\", "/")
        return any(f"/{d}/" in p for d in ("serve", "models", "kernels"))

    def check(self, tree: ast.AST, source: str, path: str) -> list[Finding]:
        findings: dict[int, Finding] = {}
        for _, fn, names in scoped_functions(tree):
            binds = assignments(fn)
            for node in own_nodes(fn):
                if isinstance(node, ast.Call):
                    got = _index_arg(node)
                    if got is None:
                        continue
                    name, idx = got
                    elts = idx.elts if isinstance(idx, (ast.Tuple, ast.List)) else [idx]
                    # a gather's index is a tensor whatever the rule can infer
                    bad = [e for e in elts if not isinstance(e, ast.Slice)
                           and not self._bounded(e, binds, set())]
                elif isinstance(node, ast.Subscript):
                    idx = node.slice
                    elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
                    bad = [e for e in elts if self._runtime(e, names)
                           and not self._bounded(e, binds, set())]
                    name = "subscript"
                else:
                    continue
                if bad:
                    findings.setdefault(node.lineno, Finding(
                        rule=self.rule_id, path=path, line=node.lineno,
                        message=(
                            f"{name} with runtime index {ast.unparse(bad[0])!r} that this "
                            "function does not clamp: torch raises on an out-of-range id "
                            "on the CPU and trips a device-side assert on CUDA, ending the "
                            "process (the dead-lane id bug class); clamp it, or say "
                            "why it is in range in a suppression"
                        ),
                    ))
        return list(findings.values())

    @staticmethod
    def _runtime(node: ast.expr, names: set[str]) -> bool:
        """A tensor index: a tensor name or a tensor-valued expression (not
        a slice, a literal, None or an ellipsis)."""
        if isinstance(node, (ast.Slice, ast.Constant)) or is_literal_index(node):
            return False
        return is_tensor_expr(node, names)

    def _bounded(self, node: ast.expr, binds, visiting: set[str]) -> bool:
        """The expression goes through a bounding call, or names a value
        bound (in this function) to one: a name bound more than once is
        bounded when its other bindings are (a rebinding through itself,
        ``idx = torch.where(live, idx, 0)``, keeps the bound)."""
        if is_literal_index(node):
            return True
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fn = sub.func
                attr = fn.attr if isinstance(fn, ast.Attribute) else dotted_name(fn)
                if attr in BOUNDING_CALLS:
                    return True
            if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod):
                return True
            if isinstance(sub, ast.Name) and sub.id in visiting:
                return True
            if isinstance(sub, ast.Name) and sub.id in binds:
                values = [v for v in binds[sub.id] if v is not None]
                if values and len(values) == len(binds[sub.id]) and all(
                        self._bounded(v, binds, visiting | {sub.id}) for v in values):
                    return True
        return False
