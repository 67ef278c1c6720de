"""Host-sync & recompile-hazard pass (JP2xx) — the torch counterpart of the
JAX package's JIT-purity pass, under the same rule ids.

On the card a Python read of a device value stalls the host until the
stream drains: the launch queue empties and the device idles while the host
catches up. Inside a ``torch.compile`` region the same read is a graph
break, and inside a CUDA-graph capture it is an error. The regions the pass
patrols:

* ``forward``/``backward`` of a ``torch.autograd.Function`` subclass;
* a function decorated with, or passed to, ``torch.compile``; a function
  passed to ``torch.cuda.make_graphed_callables`` or called inside a
  ``with torch.cuda.graph(...)`` capture;
* every function of a module under ``kernels/`` except ``_build.py`` and
  ``ref.py`` (the kernel wrappers and their plain versions);
* the JRBA engine's dispatch functions in ``core/jrba.py``
  (:data:`JRBA_DISPATCH`), which stage a solve's inputs on the device, run
  the solver and bring its results back.

The rules:

* ``JP201`` — host syncs: ``.item()``/``.cpu()``/``.tolist()``/``.numpy()``
  or ``float()``/``int()``/``bool()`` on a tensor, or
  ``torch.cuda.synchronize()``.
* ``JP202`` — a Python ``if``/``while``/``assert``/ternary on a tensor
  value: an implicit ``bool()``, so an implicit sync.
* ``JP203`` (``torch.compile`` and CUDA-graph regions only) — a read of
  mutable instance or module state (``self.x``, a module-level
  list/dict/set): a compiled or captured region bakes it in, and a later
  mutation is silently ignored or recompiles.
* ``JP204`` (``torch.compile`` regions only) — a parameter whose default is
  an unhashable literal (list/dict/set): every call re-guards on it, the
  accidental-recompile hazard it is under ``jax.jit``.

The pass reasons about names, not types: a value is a tensor when it is
rooted at a tensor parameter of the region function (annotated ``Tensor``,
or unannotated without a constant default; ``self``, ``cls``, ``ctx`` and
metadata names such as ``device``, ``dtype`` or ``shape`` excepted) or at
a name assigned from a tensor expression or a ``torch.*`` call, and its
root chain never passes through a metadata attribute or method
(``.shape``, ``.device``, ``.size()``, …) or an ``is``/``is not`` test.
This is first-order on purpose, as the JAX pass is: the suppression syntax
covers the judgment calls, and a sync the host needs carries its reason
there.
"""
from __future__ import annotations

import ast
from collections import ChainMap

from ..framework import LintPass, Rule

# attribute hops that turn a tensor into host metadata
STATIC_ATTRS = frozenset(
    {"shape", "dtype", "ndim", "device", "is_cuda", "requires_grad", "layout", "is_leaf",
     "names", "grad_fn", "type"}
)
# tensor methods that answer from metadata without reading the data
STATIC_METHODS = frozenset(
    {"size", "dim", "numel", "stride", "data_ptr", "is_contiguous", "element_size",
     "nelement", "storage_offset", "get_device", "is_floating_point", "is_complex",
     "untyped_storage"}
)
# builtins whose result is static regardless of the argument
STATIC_FUNCS = frozenset({"len", "isinstance", "type", "hasattr", "getattr", "callable", "id"})
# torch.* calls that return host values, not tensors
TORCH_HOST_CALLS = frozenset(
    {"torch.is_grad_enabled", "torch.is_tensor", "torch.device", "torch.Size",
     "torch.cuda.is_available", "torch.cuda.current_stream", "torch.cuda.device_count",
     "torch.cuda.get_device_name", "torch.cuda.current_device", "torch.get_default_dtype",
     "torch.finfo", "torch.iinfo", "torch.promote_types", "torch.result_type",
     "torch.no_grad", "torch.enable_grad", "torch.inference_mode"}
)
HOST_CASTS = frozenset({"float", "int", "bool", "complex"})
HOST_METHODS = frozenset({"item", "tolist", "numpy", "cpu"})
# parameters never taken for tensors: the receiver, autograd's context, and
# the names the kernels give metadata they check a tensor against
UNTRACKED_PARAMS = frozenset({"self", "cls", "ctx", "name", "size", "stride"}) | STATIC_ATTRS
AUTOGRAD_BASES = frozenset({"torch.autograd.Function", "autograd.Function", "Function"})
AUTOGRAD_METHODS = frozenset({"forward", "backward"})
BRANCH_KINDS = {"If": "if", "While": "while", "IfExp": "ternary", "Assert": "assert"}
# core/jrba.py: the functions between a program on the host and its relaxed
# solution back on the host — staging, the solver call, the readback
JRBA_DISPATCH = frozenset(
    {
        "_to_host",
        "_solve_md_batched",
        "solve_relaxation",
        "solve_relaxation_sparse",
        "sparse_batch_inputs",
        "solve_relaxation_sparse_batch",
        "solve_relaxation_batch",
        "_relax_one",
        "_relax_group",
    }
)
KERNEL_EXEMPT = ("_build.py", "ref.py")


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` -> ``"a.b.c"`` (None for anything fancier)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_compile_expr(node: ast.AST) -> bool:
    return _dotted(node) == "torch.compile"


def _is_partial_expr(node: ast.AST) -> bool:
    return _dotted(node) in ("partial", "functools.partial")


def _is_graph_capture(node: ast.AST) -> bool:
    d = _dotted(node.func) if isinstance(node, ast.Call) else None
    return d is not None and (d == "torch.cuda.graph" or d.endswith("cuda.graph"))


def _unhashable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func) in ("list", "dict", "set", "bytearray")
    return False


def _tensor_annotation(node: ast.AST | None) -> bool | None:
    """True for a ``Tensor`` annotation, False for any other, None for none."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split("|")[0].strip().endswith("Tensor")
    if isinstance(node, ast.BinOp):  # ``Tensor | None``
        return bool(_tensor_annotation(node.left) or _tensor_annotation(node.right))
    d = _dotted(node)
    return d is not None and d.endswith("Tensor")


def _tensor_params(fn: ast.AST) -> set[str]:
    """The parameters taken for tensors (see the module docstring)."""
    a = fn.args
    positional = [*a.posonlyargs, *a.args]
    defaults = dict(zip([p.arg for p in positional[len(positional) - len(a.defaults):]],
                        a.defaults))
    defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    out = set()
    for p in (*positional, *a.kwonlyargs, *(x for x in (a.vararg,) if x is not None)):
        if p.arg in UNTRACKED_PARAMS:
            continue
        ann = _tensor_annotation(p.annotation)
        if ann is False:
            continue
        default = defaults.get(p.arg)
        if ann is None and isinstance(default, ast.Constant) and default.value is not None:
            continue
        out.add(p.arg)
    return out


def _targets(node: ast.AST) -> list[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for e in node.elts for n in _targets(e)]
    if isinstance(node, ast.Starred):
        return _targets(node.value)
    return []


class _Region:
    """One patrolled function."""

    __slots__ = ("fn", "kind")

    def __init__(self, fn: ast.AST, kind: str):
        self.fn = fn
        self.kind = kind


class HostSyncPass(LintPass):
    name = "host-sync"
    rules = (
        Rule("JP201", "host sync (.item()/.cpu()/.tolist()/.numpy()/float()/synchronize) "
                      "on a tensor inside a device region"),
        Rule("JP202", "Python branch on a tensor value inside a device region (implicit sync)"),
        Rule("JP203", "torch.compile/CUDA-graph region reads mutable instance/module state"),
        Rule("JP204", "torch.compile region parameter with an unhashable (list/dict/set) default"),
    )

    def run(self, tree: ast.Module, relpath: str) -> list[tuple[int, int, str, str]]:
        self._module_mutables = {
            t.id
            for stmt in tree.body
            if isinstance(stmt, ast.Assign) and _unhashable_default(stmt.value)
            for t in stmt.targets
            if isinstance(t, ast.Name)
        }
        regions: dict[int, _Region] = {}
        rel = f"/{relpath}"
        if "/kernels/" in rel and not rel.endswith(KERNEL_EXEMPT):
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._mark(node, "kernel", regions)
        if rel.endswith("/core/jrba.py"):
            for node in ast.walk(tree):
                if isinstance(node, ast.FunctionDef) and node.name in JRBA_DISPATCH:
                    self._mark(node, "dispatch", regions)
        self._collect(tree.body, ChainMap({}), regions)
        out: list[tuple[int, int, str, str]] = []
        for region in regions.values():
            self._check_region(region, out)
        return out

    # -- region discovery ---------------------------------------------------
    def _mark(self, fn, kind: str, regions: dict) -> None:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        key = id(fn)
        prior = regions.get(key)
        # a compile/graph region also carries the JP203/JP204 obligations
        if prior is None or (kind in ("compile", "graph") and prior.kind not in ("compile",)):
            regions[key] = _Region(fn, kind)

    def _collect(self, body: list, scope: ChainMap, regions: dict) -> None:
        """One lexical scope: register every local def first, then classify
        the marker calls against the completed scope, then recurse into each
        nested scope (class bodies are scopes of their own, as in the JAX
        package's pass)."""
        local: dict = {}
        scope = scope.new_child(local)
        nested: list = []
        calls: list = []
        captures: list = []
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local[node.name] = node
                self._classify_decorators(node, regions)
                nested.append(node.body)
                stack.extend(node.decorator_list)
                continue
            if isinstance(node, ast.ClassDef):
                if any(_dotted(b) in AUTOGRAD_BASES for b in node.bases):
                    for item in node.body:
                        if isinstance(item, ast.FunctionDef) and item.name in AUTOGRAD_METHODS:
                            self._mark(item, "autograd", regions)
                nested.append(node.body)
                stack.extend(node.decorator_list)
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_graph_capture(item.context_expr) for item in node.items
            ):
                captures.append(node)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Lambda):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        local[t.id] = node.value
            if isinstance(node, ast.Call):
                calls.append(node)
            stack.extend(ast.iter_child_nodes(node))
        for call in calls:
            self._classify_call(call, scope, regions)
        for capture in captures:
            for node in ast.walk(capture):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                    self._mark(scope.get(node.func.id), "graph", regions)
        for b in nested:
            self._collect(b, scope, regions)

    def _classify_decorators(self, fn: ast.FunctionDef, regions: dict) -> None:
        for dec in fn.decorator_list:
            if _is_compile_expr(dec):
                self._mark(fn, "compile", regions)
            elif isinstance(dec, ast.Call) and (
                _is_compile_expr(dec.func)
                or (_is_partial_expr(dec.func) and dec.args and _is_compile_expr(dec.args[0]))
            ):
                self._mark(fn, "compile", regions)

    def _classify_call(self, call: ast.Call, scope: ChainMap, regions: dict) -> None:
        def target(i: int = 0):
            if i >= len(call.args):
                return None
            arg = call.args[i]
            if isinstance(arg, ast.Lambda):
                return arg
            if isinstance(arg, ast.Name):
                return scope.get(arg.id)
            return None

        func = call.func
        d = _dotted(func) or ""
        if _is_compile_expr(func):
            self._mark(target(), "compile", regions)
        elif isinstance(func, ast.Call) and _is_partial_expr(func.func):
            if func.args and _is_compile_expr(func.args[0]):
                self._mark(target(), "compile", regions)
        elif d.endswith("make_graphed_callables"):
            self._mark(target(), "graph", regions)

    # -- region checks ------------------------------------------------------
    def _check_region(self, region: _Region, out: list) -> None:
        fn = region.fn
        label = getattr(fn, "name", "<lambda>")
        if region.kind == "compile" and not isinstance(fn, ast.Lambda):
            self._check_defaults(fn, out)
        body = fn.body if isinstance(fn.body, list) else [ast.Expr(value=fn.body)]
        tracked = self._tracked(fn, body)
        hazards = region.kind in ("compile", "graph")
        for stmt in body:
            for node in ast.walk(stmt):
                self._check_node(node, tracked, label, hazards, out)

    def _tracked(self, fn: ast.AST, body: list) -> set[str]:
        """The tensor params, closed over the function's assignments
        (flow-insensitive, to a fixed point)."""
        tracked = _tensor_params(fn)
        binds = []
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Assign):
                    binds += [(t, node.value) for t in node.targets]
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None:
                    binds.append((node.target, node.value))
                elif isinstance(node, (ast.For, ast.comprehension)):
                    binds.append((node.target, node.iter))
                elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                    binds.append((node.optional_vars, node.context_expr))
        changed = True
        while changed:
            changed = False
            for target, value in binds:
                if not (self._roots(value, tracked) or self._is_torch_call(value)):
                    continue
                for name in _targets(target):
                    if name not in tracked:
                        tracked.add(name)
                        changed = True
        return tracked

    @staticmethod
    def _is_torch_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        d = _dotted(node.func) or ""
        return d.startswith("torch.") and d not in TORCH_HOST_CALLS

    def _check_defaults(self, fn: ast.FunctionDef, out: list) -> None:
        a = fn.args
        pos = [*a.posonlyargs, *a.args]
        pairs = [*zip(pos[len(pos) - len(a.defaults):], a.defaults),
                 *((p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None)]
        for p, default in pairs:
            if _unhashable_default(default):
                msg = (
                    f"parameter '{p.arg}' of compiled '{fn.name}' defaults to an unhashable "
                    "literal — every call re-guards on it (a recompile hazard)"
                )
                out.append((default.lineno, default.col_offset + 1, "JP204", msg))

    def _check_node(self, node: ast.AST, tracked: set[str], label: str, hazards: bool,
                    out: list) -> None:
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d == "torch.cuda.synchronize":
                msg = f"torch.cuda.synchronize() inside '{label}' — the host waits for the stream"
                out.append((node.lineno, node.col_offset + 1, "JP201", msg))
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in HOST_CASTS
                and node.args
                and self._roots(node.args[0], tracked)
            ):
                msg = (
                    f"{node.func.id}() on a tensor inside '{label}' — host sync (the host "
                    "waits for the value)"
                )
                out.append((node.lineno, node.col_offset + 1, "JP201", msg))
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in HOST_METHODS
                and self._roots(node.func.value, tracked)
            ):
                msg = f".{node.func.attr}() on a tensor inside '{label}' — host sync"
                out.append((node.lineno, node.col_offset + 1, "JP201", msg))
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            test = node.test
            hits = self._roots(test, tracked)
            if hits:
                kind = BRANCH_KINDS[type(node).__name__]
                msg = (
                    f"Python {kind} on tensor value '{sorted(hits)[0]}' inside '{label}' — an "
                    "implicit bool(), so a host sync (use torch.where, or branch on metadata)"
                )
                out.append((test.lineno, test.col_offset + 1, "JP202", msg))
        elif hazards and isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                msg = (
                    f"'self.{node.attr}' read inside compiled/captured '{label}' — instance "
                    "state is baked in; pass it as an argument"
                )
                out.append((node.lineno, node.col_offset + 1, "JP203", msg))
        elif hazards and isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in self._module_mutables and node.id not in tracked:
                msg = (
                    f"module-level mutable '{node.id}' read inside compiled/captured "
                    f"'{label}' — its value is frozen at capture time"
                )
                out.append((node.lineno, node.col_offset + 1, "JP203", msg))

    # -- tensor-root extraction ----------------------------------------------
    def _roots(self, expr: ast.AST, tracked: set[str]) -> set[str]:
        """The tracked names an expression's value is data-dependent on,
        stopping at metadata attributes and methods, host reads and static
        builtins."""
        if isinstance(expr, ast.Name):
            return {expr.id} & tracked
        if isinstance(expr, ast.Attribute):
            return set() if expr.attr in STATIC_ATTRS else self._roots(expr.value, tracked)
        if isinstance(expr, ast.Subscript):
            return self._roots(expr.value, tracked)
        if isinstance(expr, ast.Starred):
            return self._roots(expr.value, tracked)
        if isinstance(expr, ast.BinOp):
            return self._roots(expr.left, tracked) | self._roots(expr.right, tracked)
        if isinstance(expr, ast.UnaryOp):
            return self._roots(expr.operand, tracked)
        if isinstance(expr, ast.BoolOp):
            return set().union(*(self._roots(v, tracked) for v in expr.values))
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return set()  # identity tests read no data
            return self._roots(expr.left, tracked).union(
                *(self._roots(c, tracked) for c in expr.comparators))
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func)
            if d in STATIC_FUNCS or d in TORCH_HOST_CALLS:
                return set()
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in STATIC_METHODS or expr.func.attr in HOST_METHODS - {"cpu"}:
                    return set()
                roots = self._roots(expr.func.value, tracked)
                for a in expr.args:
                    roots |= self._roots(a, tracked)
                return roots
            return set()
        if isinstance(expr, (ast.Tuple, ast.List)):
            return set().union(set(), *(self._roots(e, tracked) for e in expr.elts))
        return set()
