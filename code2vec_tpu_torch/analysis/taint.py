"""Function-local taint analysis shared by the port's rules — the
counterpart of ``code2vec_tpu/analysis/taint.py``, written for torch.

One ordered walk over a function body computes, per local name:

- **shape state** — UNTAINTED / TAINTED / WARM.  ``len(...)``,
  ``.shape`` and ``.size()`` reads taint; passing through a warm-ladder
  source (``catalog.WARM_SHAPE_SOURCES``) launders to WARM.  Arithmetic
  combining a WARM value stays WARM; a join with a WARM part is WARM.
- **device taint** — True when the value is a result on the card: the
  output of a step (``catalog.DEVICE_ENTRY_POINTS``), ``.cuda()``, or a
  ``torch`` constructor given a ``device=`` other than ``'cpu'``.
  ``float``/``int``/``bool``/``np.asarray``/``.numpy()`` over such a
  value is a host sync (kind 'fetch'); after ``.cpu()`` the value is on
  the host and nothing more over it is a sync.
- **host syncs** by name: ``.item()``, ``.tolist()``, ``.cpu()`` /
  ``.to('cpu')``, ``torch.cuda.synchronize()`` and ``Event`` /
  ``Stream.synchronize()``.
- **graph-keyed calls** — a call that picks a captured CUDA graph by its
  shape key (``catalog.GRAPH_KEYED_CALLS``), with the arguments whose
  shape taints back to a raw ``len()``/``.shape`` size.

The walk is LEXICAL, as the reference's: statements are visited once, in
source order, with no branch joins or loop fixpoints, so loop-carried
and cross-function flows are not seen.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from code2vec_tpu_torch.analysis import catalog
from code2vec_tpu_torch.analysis.walker import (assigned_names, dotted_name,
                                                terminal_name)

UNTAINTED, TAINTED, WARM = 0, 1, 2

# constructors whose result SHAPE is their first argument
_ARRAY_CTORS = ('zeros', 'empty', 'ones', 'full', 'arange')
# combinators whose result shape merges the parts'
_ARRAY_JOINS = ('concatenate', 'stack', 'vstack', 'hstack', 'cat')
# value-preserving methods: x.float() etc. keep x's taint
_PASSTHROUGH_METHODS = ('astype', 'reshape', 'copy', 'items', 'values',
                        'keys', 'sum', 'max', 'min', 'mean', 'float',
                        'half', 'bfloat16', 'int', 'long', 'detach',
                        'clone', 'contiguous', 'view', 'flatten', 'abs',
                        'squeeze', 'unsqueeze', 'argmax', 'all', 'any')
# builtins and numpy calls that read a tensor's value on the host
_FETCHES = ('np.asarray', 'numpy.asarray', 'np.array', 'numpy.array')
_FETCH_BUILTINS = ('float', 'int', 'bool')


class Value:
    __slots__ = ('shape', 'device', 'host')

    def __init__(self, shape: int = UNTAINTED, device: bool = False,
                 host: bool = False):
        self.shape = shape
        self.device = device    # a result on the card
        self.host = host        # already copied to the host (.cpu())


def _merge(values) -> Value:
    out = Value()
    for v in values:
        out.shape = max(out.shape, v.shape)
        out.device = out.device or v.device
    return out


def _join_shapes(values) -> int:
    states = [v.shape for v in values]
    if WARM in states:
        return WARM  # a warm pad pins the joined result to the ladder
    if TAINTED in states:
        return TAINTED
    return UNTAINTED


class GraphKeyed:
    """One call that picks a captured graph by its shape key."""

    __slots__ = ('node', 'callee', 'tainted_args')

    def __init__(self, node: ast.Call, callee: str,
                 tainted_args: List[str]):
        self.node = node
        self.callee = callee
        self.tainted_args = tainted_args


class SyncSite:
    """One host synchronization (host-sync rule)."""

    __slots__ = ('node', 'kind')

    def __init__(self, node: ast.Call, kind: str):
        self.node = node
        self.kind = kind


def _is_cpu_literal(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value == 'cpu'


def _to_cpu(node: ast.Call) -> bool:
    """``x.to('cpu')`` / ``x.to(device='cpu')``."""
    if terminal_name(node.func) != 'to' or \
            not isinstance(node.func, ast.Attribute):
        return False
    if node.args and _is_cpu_literal(node.args[0]):
        return True
    return any(kw.arg == 'device' and _is_cpu_literal(kw.value)
               for kw in node.keywords)


def _device_kw(node: ast.Call) -> bool:
    """A ``device=`` keyword naming something other than the CPU."""
    return any(kw.arg == 'device' and not _is_cpu_literal(kw.value)
               for kw in node.keywords)


class FunctionTaint:
    """Ordered walk of ONE function body (nested defs are skipped —
    they get their own analysis)."""

    def __init__(self, func: ast.AST):
        self.env: Dict[str, Value] = {}
        self.syncs: List[SyncSite] = []
        self.keyed: List[GraphKeyed] = []
        for stmt in func.body:
            self._stmt(stmt)

    def _bind(self, target: ast.AST, value: Value) -> None:
        for name, node in assigned_names(target):
            if isinstance(node, ast.Name):
                self.env[name] = Value(value.shape, value.device,
                                       value.host)

    # -------------------------------------------------------- statements
    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested scopes analyzed separately
        if isinstance(stmt, ast.Assign):
            value = self._expr(stmt.value)
            for target in stmt.targets:
                self._bind(target, value)
        elif isinstance(stmt, ast.AnnAssign):
            value = (self._expr(stmt.value) if stmt.value is not None
                     else Value())
            self._bind(stmt.target, value)
        elif isinstance(stmt, ast.AugAssign):
            value = self._expr(stmt.value)
            prior = (self.env.get(stmt.target.id, Value())
                     if isinstance(stmt.target, ast.Name) else Value())
            self._bind(stmt.target, _merge((value, prior)))
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            value = self._expr(stmt.iter)
            self._bind(stmt.target, value)  # element ~ iterable taint
            for child in stmt.body + stmt.orelse:
                self._stmt(child)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, Value())
            for child in stmt.body:
                self._stmt(child)
        elif isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test)
            for child in stmt.body + stmt.orelse:
                self._stmt(child)
        elif isinstance(stmt, ast.Try):
            for child in (stmt.body + stmt.orelse + stmt.finalbody):
                self._stmt(child)
            for handler in stmt.handlers:
                for child in handler.body:
                    self._stmt(child)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._expr(stmt.value)
        elif isinstance(stmt, ast.Expr):
            self._expr(stmt.value)
        elif isinstance(stmt, (ast.Assert, ast.Raise, ast.Delete)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child)
        # pass/break/continue/import/global/nonlocal: nothing to track

    # ------------------------------------------------------- expressions
    def _expr(self, node: ast.expr) -> Value:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, Value())
        if isinstance(node, ast.Attribute):
            base = self._expr(node.value)
            if node.attr == 'shape':
                return Value(TAINTED)
            return Value(base.shape, base.device, base.host)
        if isinstance(node, ast.Subscript):
            base = self._expr(node.value)
            self._expr(node.slice)
            return Value(base.shape, base.device, base.host)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.BinOp):
            left, right = self._expr(node.left), self._expr(node.right)
            return Value(_join_shapes((left, right)),
                         left.device or right.device)
        if isinstance(node, ast.UnaryOp):
            operand = self._expr(node.operand)
            return Value(operand.shape, operand.device)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return _merge([self._expr(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            return _merge([self._expr(v) for v in node.values
                           if v is not None])
        if isinstance(node, ast.IfExp):
            self._expr(node.test)
            return _merge([self._expr(node.body), self._expr(node.orelse)])
        if isinstance(node, ast.BoolOp):
            return _merge([self._expr(v) for v in node.values])
        if isinstance(node, ast.Compare):
            self._expr(node.left)
            for comp in node.comparators:
                self._expr(comp)
            return Value()
        if isinstance(node, ast.Starred):
            return self._expr(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return self._comprehension(node)
        if isinstance(node, ast.Lambda):
            return Value()
        if isinstance(node, ast.JoinedStr):
            for part in node.values:
                if isinstance(part, ast.FormattedValue):
                    self._expr(part.value)
            return Value()
        if isinstance(node, ast.FormattedValue):
            self._expr(node.value)
            return Value()
        return Value()  # constants and the rest

    def _comprehension(self, node) -> Value:
        for gen in node.generators:
            self._bind(gen.target, self._expr(gen.iter))
            for cond in gen.ifs:
                self._expr(cond)
        if isinstance(node, ast.DictComp):
            self._expr(node.key)
            return self._expr(node.value)
        return self._expr(node.elt)

    # -------------------------------------------------------------- calls
    def _describe_arg(self, arg: ast.expr) -> str:
        name = dotted_name(arg)
        if name is not None:
            return name
        return '<%s at line %d>' % (type(arg).__name__, arg.lineno)

    def _call(self, node: ast.Call) -> Value:
        func = node.func
        dotted = dotted_name(func)
        term = terminal_name(func)
        method = isinstance(func, ast.Attribute)

        # --- host syncs by name -------------------------------------
        if dotted == 'torch.cuda.synchronize' or (
                method and term == 'synchronize' and not node.args):
            if method and dotted != 'torch.cuda.synchronize':
                self._expr(func.value)
            for arg in node.args:
                self._expr(arg)
            self.syncs.append(SyncSite(node, 'synchronize'))
            return Value()
        if method and (term == 'cpu' and not node.args or _to_cpu(node)):
            base = self._expr(func.value)
            if not base.host:
                self.syncs.append(SyncSite(node, 'cpu'))
            return Value(base.shape, False, True)
        if method and term in ('item', 'tolist') and not node.args:
            base = self._expr(func.value)
            if not base.host:
                self.syncs.append(SyncSite(node, term))
            return Value(host=True)
        if method and term == 'numpy' and not node.args:
            base = self._expr(func.value)
            if base.device and not base.host:
                self.syncs.append(SyncSite(node, 'fetch'))
            return Value(base.shape, False, True)

        arg_nodes = list(node.args) + [kw.value for kw in node.keywords]
        args = [self._expr(n) for n in arg_nodes]

        # --- device fetches (sync iff the value is on the card) ------
        if dotted in _FETCHES or (isinstance(func, ast.Name)
                                  and func.id in _FETCH_BUILTINS):
            if args and args[0].device and not args[0].host:
                self.syncs.append(SyncSite(node, 'fetch'))
            return Value(args[0].shape if args else UNTAINTED, False,
                         True)

        # --- shape sources ------------------------------------------
        if isinstance(func, ast.Name) and func.id == 'len':
            return Value(TAINTED)
        if method and term in ('size', 'numel', 'dim') and not node.args:
            self._expr(func.value)
            return Value(TAINTED)
        if term in catalog.WARM_SHAPE_SOURCES:
            return Value(WARM)

        # --- graph-keyed calls --------------------------------------
        if term in catalog.GRAPH_KEYED_CALLS:
            tainted = [self._describe_arg(arg)
                       for arg, value in zip(arg_nodes, args)
                       if value.shape == TAINTED]
            self.keyed.append(GraphKeyed(node, dotted or term, tainted))
            if method:
                self._expr(func.value)
            return Value()

        # --- results on the card ------------------------------------
        if term in catalog.DEVICE_ENTRY_POINTS:
            if method:
                self._expr(func.value)
            return Value(device=True)
        if method and term == 'cuda':
            base = self._expr(func.value)
            return Value(base.shape, True)
        if term in _ARRAY_CTORS:
            return Value(args[0].shape if args else UNTAINTED,
                         _device_kw(node))
        if term in _ARRAY_JOINS:
            joined = _merge(args)
            return Value(_join_shapes(args) if args else UNTAINTED,
                         joined.device)

        # --- passthrough methods ------------------------------------
        if method and term in _PASSTHROUGH_METHODS:
            base = self._expr(func.value)
            return Value(base.shape, base.device, base.host)
        if method and term == 'to':
            base = self._expr(func.value)
            return Value(base.shape, base.device or _device_kw(node),
                         base.host)
        if method:
            self._expr(func.value)
        return Value()


def analyze_file(source):
    """[(FunctionInfo, FunctionTaint)] for every function in a file,
    computed once and cached on the SourceFile — several rules consume
    the taint pass, and the walker's one-parse contract extends to it."""
    cache = getattr(source, '_taint_analysis', None)
    if cache is None:
        cache = [(info, FunctionTaint(info.node))
                 for info in source.functions]
        source._taint_analysis = cache
    return cache


def imported_names(tree: ast.Module) -> Dict[str, Tuple[str, str]]:
    """{local name: (module, name)} of a file's ``from X import Y [as
    Z]`` statements (the capture rules resolve a captured call's def
    through them)."""
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = (node.module, alias.name)
    return out


def module_path(module: str) -> str:
    """'code2vec_tpu_torch.serving.steps' -> its repo-relative file."""
    return module.replace('.', '/') + '.py'


def called_names(func: ast.AST) -> Set[str]:
    """Bare names called anywhere in a def's body (``f(...)``)."""
    return {node.func.id for node in ast.walk(func)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}
