"""Shared AST walker: one parse per file, reused by every rule — the
port's copy of ``code2vec_tpu/analysis/walker.py``.

``SourceTree`` loads and parses the scanned files once; rules receive
the tree and iterate ``tree.files(scope)``.  Each ``SourceFile`` carries
the raw text (for the grep-shaped rules and the suppression comments),
the parsed AST, and a per-file function index (qualified names +
line->enclosing-function map) so rules never re-derive structure.

Dependency-free: the lint pass imports neither torch nor the modules it
scans (the catalog rules import the catalogs alone) and stays far under
its 20 s budget.
"""
from __future__ import annotations

import ast
import io
import os
import tokenize
from typing import Dict, Iterator, List, Optional, Tuple

# Default scan scopes, relative to the repo root.  'package' is the
# port's runtime tree the invariant rules guard; 'all' adds the port's
# card harness (chip_smoke.py) and kernel checks for the catalog-drift
# rules.  tests/ stays out everywhere: tests mint throwaway names and
# seed deliberate violations to exercise the rules themselves.
PACKAGE_DIRS = ('code2vec_tpu_torch',)
ALL_DIRS = ('code2vec_tpu_torch',)
ALL_FILES = ('chip_smoke.py', 'scripts/torch_kernel_checks.py')


class FunctionInfo:
    """One function (or method) definition: qualified name, the AST
    node, and its line span."""

    __slots__ = ('qualname', 'node', 'lineno', 'end_lineno')

    def __init__(self, qualname: str, node: ast.AST):
        self.qualname = qualname
        self.node = node
        self.lineno = node.lineno
        self.end_lineno = getattr(node, 'end_lineno', node.lineno)


class SourceFile:
    """One parsed source file. ``rel`` is the repo-relative path every
    finding/catalog entry keys on."""

    def __init__(self, root: str, rel: str):
        self.rel = rel
        self.path = os.path.join(root, rel)
        with open(self.path, 'r') as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.Module] = ast.parse(self.text)
        except SyntaxError as exc:  # surfaced as an engine finding
            self.tree = None
            self.parse_error = exc
        self._functions: Optional[List[FunctionInfo]] = None
        self._comments: Optional[List[Tuple[int, str]]] = None

    @property
    def comments(self) -> List[Tuple[int, str]]:
        """(lineno, text) of every REAL comment token — docstrings and
        string literals that merely look like annotations never count
        (suppress.py and the lock-discipline annotations key off this)."""
        if self._comments is None:
            self._comments = []
            try:
                for tok in tokenize.generate_tokens(
                        io.StringIO(self.text).readline):
                    if tok.type == tokenize.COMMENT:
                        self._comments.append((tok.start[0], tok.string))
            except (tokenize.TokenError, IndentationError, SyntaxError):
                pass  # unparsable files already surface via parse_error
        return self._comments

    # ------------------------------------------------------- structure
    @property
    def functions(self) -> List[FunctionInfo]:
        """Every def/async-def in the file (nested included), with
        ``Class.method`` / ``outer.<locals>.inner`` qualified names."""
        if self._functions is None:
            self._functions = []
            if self.tree is not None:
                self._collect(self.tree, '', self._functions)
        return self._functions

    def _collect(self, node: ast.AST, prefix: str,
                 out: List[FunctionInfo]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (prefix + '.' if prefix else '') + child.name
                out.append(FunctionInfo(qual, child))
                self._collect(child, qual + '.<locals>', out)
            elif isinstance(child, ast.ClassDef):
                qual = (prefix + '.' if prefix else '') + child.name
                self._collect(child, qual, out)
            else:
                self._collect(child, prefix, out)

    def enclosing_function(self, lineno: int) -> Optional[str]:
        """Qualified name of the innermost function containing a line
        (None at module level)."""
        best: Optional[FunctionInfo] = None
        for info in self.functions:
            if info.lineno <= lineno <= info.end_lineno:
                if best is None or info.lineno >= best.lineno:
                    best = info
        return best.qualname if best is not None else None

    def classes(self) -> Iterator[ast.ClassDef]:
        if self.tree is None:
            return
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                yield node


class SourceTree:
    """All scanned files of one repository, parsed once.

    ``scan_dirs``/``scan_files`` default to the repo layout; tests point
    them at a tmp tree of synthetic snippets.
    """

    def __init__(self, root: str,
                 scan_dirs: Tuple[str, ...] = ALL_DIRS,
                 scan_files: Tuple[str, ...] = ALL_FILES,
                 package_dirs: Tuple[str, ...] = PACKAGE_DIRS):
        self.root = os.path.abspath(root)
        self.package_dirs = package_dirs
        self._files: Dict[str, SourceFile] = {}
        for rel in self._iter_relpaths(scan_dirs, scan_files):
            self._files[rel] = SourceFile(self.root, rel)

    def _iter_relpaths(self, scan_dirs, scan_files) -> Iterator[str]:
        for rel_dir in scan_dirs:
            top = os.path.join(self.root, rel_dir)
            if not os.path.isdir(top):
                continue
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = [d for d in dirnames if d != '__pycache__']
                for name in sorted(filenames):
                    if name.endswith('.py'):
                        yield os.path.relpath(
                            os.path.join(dirpath, name), self.root)
        for rel in scan_files:
            if os.path.isfile(os.path.join(self.root, rel)):
                yield rel

    def files(self, scope: str = 'all') -> List[SourceFile]:
        """'package' = the runtime tree only; 'all' = everything
        scanned."""
        if scope == 'package':
            prefixes = tuple(d + os.sep for d in self.package_dirs)
            return [f for f in self._files.values()
                    if f.rel.startswith(prefixes)]
        return list(self._files.values())

    def get(self, rel: str) -> Optional[SourceFile]:
        return self._files.get(rel)

    def doc_text(self, *names: str) -> str:
        """Concatenated text of the named repo-root docs that exist
        (doc-coverage rules)."""
        parts = []
        for name in names:
            path = os.path.join(self.root, name)
            if os.path.isfile(path):
                with open(path, 'r') as f:
                    parts.append(f.read())
        return '\n'.join(parts)

    def root_docs(self) -> List[str]:
        """Every *.md at the repo root (the documentation surface the
        config-knob rule accepts)."""
        return sorted(name for name in os.listdir(self.root)
                      if name.endswith('.md'))


# --------------------------------------------------------------- helpers
def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' / 'self._graphs' for a Name/Attribute chain;
    None for anything not a plain dotted chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return '.'.join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last attribute/name of a call target: ``self.a.b`` -> 'b',
    ``f`` -> 'f'.  The match key for method-style catalogs."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def assigned_names(target: ast.AST) -> List[Tuple[str, ast.AST]]:
    """(name, target_node) pairs bound by one assignment target —
    handles Name, tuple/list destructuring, starred; attribute targets
    report their terminal name."""
    out: List[Tuple[str, ast.AST]] = []

    def walk(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            out.append((t.id, t))
        elif isinstance(t, ast.Attribute):
            out.append((t.attr, t))
        elif isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                walk(elt)
        elif isinstance(t, ast.Starred):
            walk(t.value)
    walk(target)
    return out
