"""Rules ``capture-purity`` and ``capture-hazard``: what a CUDA graph
captures, and where graphs are captured and kernels built.

``capture-purity`` is the counterpart of the JAX ``jit-purity``
(``code2vec_tpu/analysis/rules/jit_purity.py``). A body captured into a
CUDA graph runs its Python ONCE, at capture; the graph replays only the
card's work. ``time.*`` reads, ``np.random`` draws, logging, prints,
``os.environ`` reads, telemetry writes and fault probes inside it run at
capture and never again; a host sync inside it (``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()``, ``synchronize()``) fails the
capture outright. Captured bodies are found from the capture regions:
the statements between ``capture_begin`` and ``capture_end``, the body of
``with torch.cuda.graph(...)``, and the function passed to
``torch.cuda.make_graphed_callables``; a bare-name call there resolves to
its def in the same file or, through the file's ``from ... import``, in
the scanned tree (``serving/steps.py::predict_step`` as
``serving/graphs.py`` captures it), and what that def calls by bare name
in its own file is captured with it.

``capture-hazard`` is the counterpart of the JAX ``recompile-hazard``
(``code2vec_tpu/analysis/rules/recompile_hazard.py``). The port's
compiles are a graph capture and a kernel library's build; both cost
seconds and belong to a warm-up. It fails on:

1. a capture or a kernel build (``ops/_build.py::build``) outside the
   cataloged warm-up sites (``catalog.WARMUP_SITES``; counts pinned,
   stale entries fail);
2. a call that picks a captured graph by its shape key
   (``catalog.GRAPH_KEYED_CALLS``) with an argument whose shape taints
   back to a raw ``len()``/``.shape`` size without a warm-ladder source:
   a key outside the warmed ladder, which has no graph.
"""
from __future__ import annotations

import ast
import collections
from typing import Dict, List, Optional, Set, Tuple

from code2vec_tpu_torch.analysis import catalog, taint
from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import (SourceFile, SourceTree,
                                                dotted_name, terminal_name)

# dotted-prefix ban list (the reference's jit-purity list); matched
# against the full chain so `torch.random` never collides with
# `np.random`
_BANNED_PREFIXES = (
    ('time.', 'host clock read runs once, at capture'),
    ('np.random.', 'host RNG draws once at capture — draw on the card '
                   'with a generator whose state the graph reads'),
    ('numpy.random.', 'host RNG draws once at capture'),
    ('random.', 'host RNG draws once at capture'),
    ('os.environ', 'environment read runs once, at capture'),
    ('logging.', 'logging runs at capture only'),
    ('logger.', 'logging runs at capture only'),
    ('tele_core.', 'telemetry registry access runs once — instrument the '
                   'replay site, not the captured body'),
    ('telemetry.', 'telemetry registry access runs once — instrument the '
                   'replay site, not the captured body'),
    ('faults.maybe_fire', 'fault probes run once and never fire again — '
                          'probe at the replay site'),
)
_BANNED_BARE_CALLS = {
    'print': 'print runs at capture only',
    'open': 'file I/O inside a captured body runs once, at capture',
}
_SYNC_METHODS = {
    'item': 'a host sync fails the capture',
    'tolist': 'a host sync fails the capture',
    'cpu': 'a copy to the host fails the capture',
    'numpy': 'a host read fails the capture',
    'synchronize': 'a synchronize fails the capture',
}


def _banned(node: ast.Call) -> Optional[Tuple[str, str]]:
    name = dotted_name(node.func)
    if name is not None:
        for prefix, why in _BANNED_PREFIXES:
            if name == prefix.rstrip('.') or name.startswith(prefix):
                return name, why
    if isinstance(node.func, ast.Name):
        why = _BANNED_BARE_CALLS.get(node.func.id)
        if why is not None:
            return node.func.id, why
    term = terminal_name(node.func)
    if isinstance(node.func, ast.Attribute) and term in _SYNC_METHODS and \
            not node.args:
        return (name or '.' + term), _SYNC_METHODS[term]
    if name == 'torch.cuda.synchronize':
        return name, _SYNC_METHODS['synchronize']
    return None


def capture_regions(source: SourceFile) -> List[Tuple[str, List[ast.AST]]]:
    """[(enclosing function, nodes captured)] of one file: the calls
    between ``capture_begin`` and ``capture_end``, the body of ``with
    torch.cuda.graph(...)``, and ``make_graphed_callables``' first
    argument."""
    out: List[Tuple[str, List[ast.AST]]] = []
    for info in source.functions:
        begins, ends = [], []
        for node in ast.walk(info.node):
            if isinstance(node, ast.Call):
                term = terminal_name(node.func)
                if term == 'capture_begin':
                    begins.append(node.lineno)
                elif term == 'capture_end':
                    ends.append(node.lineno)
                elif term == 'make_graphed_callables' and node.args:
                    out.append((info.qualname, [node.args[0]]))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call) and \
                            dotted_name(ctx.func) in ('torch.cuda.graph',
                                                      'cuda.graph'):
                        out.append((info.qualname, list(node.body)))
        for begin in begins:
            end = min((e for e in ends if e > begin), default=None)
            if end is None:
                continue
            nodes = [n for n in ast.walk(info.node)
                     if isinstance(n, ast.Call)
                     and begin < n.lineno < end
                     and source.enclosing_function(n.lineno)
                     == info.qualname]
            out.append((info.qualname, nodes))
    return out


def _module_defs(source: SourceFile) -> Dict[str, ast.AST]:
    if source.tree is None:
        return {}
    return {node.name: node for node in source.tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def captured_defs(tree: SourceTree, scope: str
                  ) -> List[Tuple[SourceFile, str, ast.AST]]:
    """[(file, def name, def node)] of every def a capture region
    reaches by bare name, with what those defs call by bare name in their
    own files."""
    found: Dict[Tuple[str, str], Tuple[SourceFile, ast.AST]] = {}
    work: List[Tuple[SourceFile, str]] = []
    for source in tree.files(scope):
        if source.tree is None:
            continue
        imports = taint.imported_names(source.tree)
        for _func, nodes in capture_regions(source):
            names: Set[str] = set()
            for node in nodes:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Name):
                        names.add(sub.func.id)
                if isinstance(node, ast.Name):
                    names.add(node.id)   # make_graphed_callables(fn)
            for name in sorted(names):
                if name in _module_defs(source):
                    work.append((source, name))
                elif name in imports:
                    module, real = imports[name]
                    target = tree.get(taint.module_path(module))
                    if target is not None:
                        work.append((target, real))
    while work:
        source, name = work.pop()
        key = (source.rel, name)
        defs = _module_defs(source)
        if key in found or name not in defs:
            continue
        found[key] = (source, defs[name])
        for callee in sorted(taint.called_names(defs[name])):
            if callee in defs:
                work.append((source, callee))
    return [(src, name, node)
            for (_rel, name), (src, node) in sorted(found.items())]


@register
class CapturePurityRule(Rule):
    name = 'capture-purity'
    doc = ('no time/np.random/logging/os.environ/telemetry/fault-probe '
           'side effects and no host sync inside a body captured into a '
           'CUDA graph')
    scope = 'package'

    def run(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()

        def check(source, nodes, where) -> None:
            for node in nodes:
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    hit = _banned(sub)
                    if hit is None or (source.rel, sub.lineno) in seen:
                        continue
                    seen.add((source.rel, sub.lineno))
                    findings.append(self.finding(
                        source.rel, sub.lineno,
                        'impure call `%s(...)` inside captured `%s`: %s'
                        % (hit[0], where, hit[1])))

        for source in tree.files(self.scope):
            if source.tree is None:
                continue
            for func, nodes in capture_regions(source):
                check(source, nodes, func)
        for source, name, node in captured_defs(tree, self.scope):
            check(source, [node], name)
        return findings


def _is_build(node: ast.Call, source: SourceFile,
              imports: Dict[str, Tuple[str, str]]) -> bool:
    dotted = dotted_name(node.func)
    if dotted is not None and dotted.endswith('_build.build'):
        return True
    if isinstance(node.func, ast.Name) and node.func.id == 'build':
        if source.rel.endswith('ops/_build.py'):
            return True
        return imports.get('build', ('', ''))[0].endswith('ops._build')
    return False


def _is_capture(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        return terminal_name(node.func) in ('capture_begin',
                                            'make_graphed_callables')
    if isinstance(node, (ast.With, ast.AsyncWith)):
        return any(isinstance(item.context_expr, ast.Call)
                   and dotted_name(item.context_expr.func)
                   in ('torch.cuda.graph', 'cuda.graph')
                   for item in node.items)
    return False


def find_warmup_sites(tree: SourceTree, scope: str
                      ) -> List[Tuple[str, str, int, str]]:
    """[(relpath, enclosing function, lineno, kind)] of every capture and
    kernel build in the scanned tree."""
    out = []
    for source in tree.files(scope):
        if source.tree is None:
            continue
        imports = taint.imported_names(source.tree)
        for node in ast.walk(source.tree):
            kind = None
            if _is_capture(node):
                kind = 'capture'
            elif isinstance(node, ast.Call) and \
                    _is_build(node, source, imports):
                kind = 'build'
            if kind is not None:
                func = source.enclosing_function(node.lineno) or ''
                out.append((source.rel, func, node.lineno, kind))
    return out


@register
class CaptureHazardRule(Rule):
    name = 'capture-hazard'
    doc = ('CUDA-graph captures and kernel builds only at cataloged '
           'warm-up sites; graph keys only from warm-ladder shapes')
    scope = 'package'

    def run(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        sanctioned = {(e['file'], e['func'], e['kind']): e
                      for e in catalog.WARMUP_SITES}
        observed: Dict[Tuple[str, str, str], int] = collections.Counter()
        for rel, func, lineno, kind in find_warmup_sites(tree, self.scope):
            key = (rel, func, kind)
            observed[key] += 1
            if key not in sanctioned:
                findings.append(self.finding(
                    rel, lineno,
                    '%s outside a warm-up site in `%s` — a graph capture '
                    'or a kernel build costs seconds; move it into a '
                    'warm-up or add a WARMUP_SITES entry with its '
                    'justification (analysis/catalog.py)'
                    % ('graph capture' if kind == 'capture'
                       else 'kernel build', func or '<module>')))
        for key, entry in sorted(sanctioned.items()):
            if tree.get(entry['file']) is None:
                continue
            if not str(entry.get('reason', '')).strip():
                findings.append(self.finding(
                    entry['file'], 0,
                    'WARMUP_SITES entry `%s` (%s) has no reason'
                    % (entry['func'], entry['kind'])))
            seen = observed.get(key, 0)
            if seen == 0:
                findings.append(self.finding(
                    entry['file'], 0,
                    'stale WARMUP_SITES entry: no %s in `%s` — update '
                    'the catalog' % (entry['kind'], entry['func'])))
            elif seen != entry['count']:
                findings.append(self.finding(
                    entry['file'], 0,
                    '`%s` has %d %s site(s) but the catalog pins %d'
                    % (entry['func'], seen, entry['kind'],
                       entry['count'])))
        for source in tree.files(self.scope):
            if source.tree is None:
                continue
            for info, analysis in taint.analyze_file(source):
                for keyed in analysis.keyed:
                    for arg in keyed.tainted_args:
                        findings.append(self.finding(
                            source.rel, keyed.node.lineno,
                            'graph key `%s(...)` in `%s`: argument `%s` '
                            'has a shape derived from a raw len()/.shape '
                            'size — route it through a warm-ladder '
                            'source (pick_bucket/capacity_ladder/'
                            'bucketed_capacity)'
                            % (keyed.callee, info.qualname, arg)))
        return findings
