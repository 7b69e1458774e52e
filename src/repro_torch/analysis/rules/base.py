"""Shared AST helpers for the lint rules.

Counterpart of ``repro.analysis.rules.base``. Every rule is a module-level
class with

    rule_id : str          e.g. "R001"
    title   : str          one-line summary for --list-rules
    def applies_to(self, path: str) -> bool
    def check(self, tree: ast.AST, source: str, path: str) -> list[Finding]

registered in ``repro_torch.analysis.rules.ALL_RULES``. Rules never read
files: the runner (``repro_torch.analysis.lint``) parses once and owns
suppressions, so rules only decide whether a node is a hazard.

Beyond the reference's helpers, the torch rules share a small
intra-function view of which names hold tensors (``tensor_names``): the
port's hazards (a host sync, an unclamped gather, a contraction below
float32) are properties of tensor values, which Python's AST does not type.
"""
from __future__ import annotations

import ast


def dotted_name(node: ast.AST) -> str | None:
    """``torch.gather`` / ``F.embedding`` -> the dotted string, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def keyword_names(call: ast.Call) -> set[str]:
    return {kw.arg for kw in call.keywords if kw.arg is not None}


def get_keyword(call: ast.Call, name: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def is_literal_index(node: ast.expr) -> bool:
    """Static indices (int literals, +-literals, tuples/lists of them) can
    never be out of bounds at run time without failing the first test run;
    only runtime-computed indices need a clamp."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, bool))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        return is_literal_index(node.operand)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(is_literal_index(e) for e in node.elts)
    return False


def contains_float_literal(node: ast.expr) -> bool:
    """True if the expression mixes in a bare Python float literal anywhere
    (``x * 1.0``, ``0.5 * (a + b)``); calls are not descended into."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    if isinstance(node, ast.Call):
        return False
    return any(
        contains_float_literal(child)
        for child in ast.iter_child_nodes(node)
        if isinstance(child, ast.expr)
    )


# ------------------------------------------------------- tensor inference
# attributes of a tensor that are host values, not tensors
HOST_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad",
              "is_leaf", "names"}
# tensor methods that return host values
HOST_METHODS = {"dim", "size", "numel", "data_ptr", "is_contiguous", "element_size",
                "get_device", "stride", "storage_offset", "is_floating_point",
                "is_complex", "nelement", "untyped_storage"}
# torch callables that return no tensor
HOST_TORCH = {"torch.device", "torch.Size", "torch.is_grad_enabled", "torch.is_tensor",
              "torch.finfo", "torch.iinfo", "torch.get_default_dtype", "torch.Generator",
              "torch.is_floating_point", "torch.no_grad", "torch.enable_grad"}
TENSOR_MODULES = ("torch.", "F.", "torch.nn.functional.")
# the port's names for the id, position and mask tensors its steps take: a
# parameter of one of these names holds a tensor wherever it appears
TENSOR_PARAMS = {"tokens", "task_ids", "positions", "pos", "live", "valid", "ids", "idx",
                 "block_tables", "labels", "mask", "reset"}


def scoped_functions(tree: ast.AST):
    """Yield (qualified name, node, tensor names) of every def, the names
    of an enclosing def's scope (its closure) seeding a nested one's, and
    ``TENSOR_PARAMS`` seeding every one."""
    def walk(node, prefix, outer):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                names = tensor_names(child, outer | TENSOR_PARAMS)
                yield name, child, names
                yield from walk(child, f"{name}.", names)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", frozenset())
            else:
                yield from walk(child, prefix, outer)
    yield from walk(tree, "", frozenset())


def functions(tree: ast.AST):
    """Yield (qualified name, node) of every def: ``f``, ``Class.f``, and
    ``outer.inner`` for nested defs."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                yield name, child
                yield from walk(child, f"{name}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


def own_nodes(fn: ast.AST):
    """Every node of ``fn``'s body that is not inside a nested def or
    lambda (those are scopes of their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def assignments(fn: ast.AST) -> dict[str, list[ast.expr | None]]:
    """name -> the values bound to it in ``fn`` (own scope). A name bound
    by unpacking gets the matching element when the value is a tuple or
    list display of the same length, else None (unknown); loop targets get
    None, except ``for i in range(...)``, which binds an int (recorded as
    the constant 0)."""
    out: dict[str, list] = {}

    def bind(target, value):
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = None
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts):
                elts = value.elts
            for i, t in enumerate(target.elts):
                bind(t, elts[i] if elts is not None else None)
        elif isinstance(target, ast.Starred):
            bind(target.value, None)

    for node in own_nodes(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                bind(t, node.value)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None:
            if isinstance(node, ast.AugAssign):
                value = ast.BinOp(left=node.target, op=node.op, right=node.value)
                ast.copy_location(value, node)
                bind(node.target, value)
            else:
                bind(node.target, node.value)
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            it = node.iter
            if isinstance(it, ast.Call) and dotted_name(it.func) == "range":
                bind(node.target, ast.Constant(0))
            else:
                bind(node.target, None)
        elif isinstance(node, ast.NamedExpr):
            bind(node.target, node.value)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    bind(item.optional_vars, None)
    return out


def tensor_names(fn: ast.AST, seed: set[str] = frozenset()) -> set[str]:
    """The names of ``fn`` that hold tensors: ``seed`` (parameters known to
    be tensors), every parameter annotated ``torch.Tensor``, and every name
    some assignment binds to a tensor expression (``is_tensor_expr``),
    to a fixpoint."""
    names = set(seed)
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if ann is not None and "Tensor" in ast.unparse(ann) and "None" not in ast.unparse(ann):
            names.add(a.arg)
    binds = assignments(fn)
    changed = True
    while changed:
        changed = False
        for name, values in binds.items():
            if name in names:
                continue
            if any(v is not None and is_tensor_expr(v, names) for v in values):
                names.add(name)
                changed = True
    return names


def is_tensor_expr(node: ast.expr, names: set[str]) -> bool:
    """Whether ``node`` evaluates to a tensor, given the tensor ``names``:
    a tensor name, a ``torch.*`` / ``F.*`` call (bar ``HOST_TORCH``), a
    tensor's method call or attribute (bar ``HOST_METHODS`` /
    ``HOST_ATTRS``), a subscript of a tensor, arithmetic or a comparison
    with a tensor operand."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        if node.attr in HOST_ATTRS:
            return False
        return is_tensor_expr(node.value, names)
    if isinstance(node, ast.Subscript):
        return is_tensor_expr(node.value, names)
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name is not None and name in HOST_TORCH:
            return False
        if name is not None and name.startswith(TENSOR_MODULES) and not name.startswith(
                ("torch.cuda.", "torch.backends.")):
            return True
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in HOST_METHODS or node.func.attr in ("item", "tolist"):
                return False
            return is_tensor_expr(node.func.value, names)
        return False
    if isinstance(node, ast.BinOp):
        return is_tensor_expr(node.left, names) or is_tensor_expr(node.right, names)
    if isinstance(node, ast.UnaryOp):
        return is_tensor_expr(node.operand, names)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
            return False
        return any(is_tensor_expr(c, names) for c in [node.left, *node.comparators])
    if isinstance(node, ast.BoolOp):
        return any(is_tensor_expr(v, names) for v in node.values)
    if isinstance(node, ast.IfExp):
        return is_tensor_expr(node.body, names) or is_tensor_expr(node.orelse, names)
    return False
