"""R005 — contractions in ``models/`` accumulate in float32.

The reference's R005 is about a weak float literal silently promoting (or
not) a bf16 contraction operand. Torch does not promote a bf16 tensor with
a Python float as JAX does; its hazard of the same class is the reverse: a
``torch.matmul`` / ``@`` / ``einsum`` / ``bmm`` / ``F.linear`` on bf16
operands accumulates, and returns, at bf16 unless the caller says
otherwise. The reference states its accumulation dtype
(``preferred_element_type=jnp.float32``, ``repro/models/layers.py``
``matmul``) and the port's token parity depends on doing the same
(bf16 accumulation moves greedy tokens; ROADMAP "Keep the f32
accumulation").

Flagged, under ``models/``: a contraction whose operands the rule cannot
show to be float32. An operand is float32 when it goes through
``.float()`` / ``.double()`` / ``.to(torch.float32)``, is made with
``dtype=torch.float32``, or is a name every binding of which in the
function is such an expression (or arithmetic, a method or a ``torch.*``
call on one: float32 wins torch's promotion between tensors). Such
contractions go through ``models/layers.matmul`` (which casts to float32,
accumulates and casts back), or the site says why it need not in a
suppression (operands float32 by construction elsewhere, or the
reference contracting at the operand dtype there too).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import (
    assignments,
    dotted_name,
    get_keyword,
    own_nodes,
    scoped_functions,
)

_CONTRACTIONS = {"torch.matmul", "torch.einsum", "torch.bmm", "torch.mm", "torch.mv",
                 "torch.baddbmm", "torch.addmm", "torch.tensordot", "F.linear",
                 "torch.nn.functional.linear"}
_METHOD_CONTRACTIONS = {"matmul", "bmm", "mm", "mv"}
_F32 = {"torch.float32", "torch.float", "torch.float64", "torch.double"}


def _f32_dtype(node) -> bool:
    return node is not None and dotted_name(node) in _F32


class AccumulationRule:
    rule_id = "R005"
    title = "contraction in models/ on operands not shown float32 (accumulates low)"

    def applies_to(self, path: str) -> bool:
        return "/models/" in path.replace("\\", "/")

    def check(self, tree: ast.AST, source: str, path: str) -> list[Finding]:
        findings = []
        for _, fn, _ in scoped_functions(tree):
            f32 = self._f32_names(fn)
            for node in own_nodes(fn):
                operands = self._operands(node)
                if operands is None:
                    continue
                low = [op for op in operands if not self._is_f32(op, f32)]
                if not low:
                    continue
                findings.append(Finding(
                    rule=self.rule_id, path=path, line=node.lineno,
                    message=(
                        f"contraction on {ast.unparse(low[0])!r}, not shown to be float32: "
                        "on bf16 operands torch accumulates and returns bf16, where the "
                        "reference accumulates in float32 (preferred_element_type); use "
                        "layers.matmul or cast the operands, or say why in a suppression"
                    ),
                ))
        return findings

    @staticmethod
    def _operands(node):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            return [node.left, node.right]
        if not isinstance(node, ast.Call):
            return None
        name = dotted_name(node.func) or ""
        if name in _CONTRACTIONS:
            args = list(node.args)
            if name == "torch.einsum" and args and isinstance(args[0], ast.Constant):
                args = args[1:]
            return args
        if isinstance(node.func, ast.Attribute) and node.func.attr in _METHOD_CONTRACTIONS \
                and not name.startswith(("torch.", "np.", "numpy.")):
            return [node.func.value, *node.args]
        return None

    def _f32_names(self, fn) -> set[str]:
        """Names every binding of which is float32 (greatest fixpoint, so
        loop-carried rebindings through themselves keep the name)."""
        binds = assignments(fn)
        names = {n for n, vs in binds.items() if all(v is not None for v in vs)}
        changed = True
        while changed:
            changed = False
            for n in list(names):
                if not all(self._is_f32(v, names) for v in binds[n]):
                    names.discard(n)
                    changed = True
        return names

    def _is_f32(self, node, names) -> bool:
        if isinstance(node, ast.Name):
            return node.id in names
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr in ("float", "double"):
                    return True
                if func.attr == "to":
                    if any(_f32_dtype(a) for a in node.args) or _f32_dtype(
                            get_keyword(node, "dtype")):
                        return True
                    return False
            if _f32_dtype(get_keyword(node, "dtype")):
                return True
            if isinstance(func, ast.Attribute) and not (dotted_name(func) or "").startswith(
                    "torch."):
                return self._is_f32(func.value, names)  # a method of a float32 tensor
            if (dotted_name(func) or "").startswith(("torch.", "F.")):
                return any(self._is_f32(a, names) for a in node.args)
            return False
        if isinstance(node, ast.Subscript):
            return self._is_f32(node.value, names)
        if isinstance(node, ast.BinOp):
            return self._is_f32(node.left, names) or self._is_f32(node.right, names)
        if isinstance(node, ast.UnaryOp):
            return self._is_f32(node.operand, names)
        if isinstance(node, ast.IfExp):
            return self._is_f32(node.body, names) and self._is_f32(node.orelse, names)
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self._is_f32(e, names) for e in node.elts)
        return False
