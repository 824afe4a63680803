"""Rule ``lock-discipline``: declared guarded fields stay guarded — the
JAX counterpart is the rule of the same name
(``code2vec_tpu/analysis/rules/locks.py``); the annotations use the same
syntax in both packages.

The serving engine's dispatcher and decode workers, the mesh's pullers
and receivers, the watchdog monitor and the telemetry registry all
share mutable state across threads.  Each owning
module DECLARES its locking contract in a module-level annotation::

    # graftlint: guard ServingEngine._queues,_pending_rows by _lock|_cond

meaning: every ``self.<field>`` access on the listed fields, in any
method of that class, must sit inside a ``with self.<lock>:`` block for
one of the listed lock aliases (a Condition wrapping a Lock lists
both).  Exemptions, matching how thread-safe classes are actually
written:

- ``__init__`` — construction happens-before any thread can observe
  the object (the thread/pool starts are the publication points);
- methods named ``*_locked`` — the documented called-with-lock-held
  convention (the caller owns the ``with``).

The rule also flags a declared field that never appears in the class
(stale annotation) and an annotation naming an unknown class — the
contract file cannot drift from the code it governs.  This is a
lightweight static race detector: it catches the common regression
(a new method touching shared state barehanded), not every interleaving.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import SourceTree, dotted_name

GUARD_RE = re.compile(
    r'#\s*graftlint:\s*guard\s+(\w+)\.([\w,]+)\s+by\s+([\w|]+)')


def parse_annotations(source) -> List[Tuple[str, Set[str], Set[str]]]:
    """[(class, fields, lock aliases)] from one file's annotation
    comments (real COMMENT tokens only — docstring examples never parse
    as live annotations).  Groups stay SEPARATE: a class may guard
    different fields with different locks, and holding the wrong one
    must not count."""
    out: List[Tuple[str, Set[str], Set[str]]] = []
    for _lineno, text in source.comments:
        match = GUARD_RE.search(text)
        if match is None:
            continue
        cls, fields_text, locks_text = match.groups()
        out.append((cls,
                    {f for f in fields_text.split(',') if f},
                    {l for l in locks_text.split('|') if l}))
    return out


@register
class LockDisciplineRule(Rule):
    name = 'lock-discipline'
    doc = ('fields declared `# graftlint: guard Cls.f by lock` are only '
           'touched under `with self.lock:` (cross-thread state)')
    scope = 'package'

    def run(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        for source in tree.files(self.scope):
            if source.tree is None:
                continue
            annotations = parse_annotations(source)
            if not annotations:
                continue
            classes = {node.name: node for node in source.classes()}
            for cls_name, fields, locks in annotations:
                cls = classes.get(cls_name)
                if cls is None:
                    findings.append(self.finding(
                        source.rel, 0,
                        'guard annotation names unknown class `%s`'
                        % cls_name))
                    continue
                findings.extend(self._check_class(
                    source, cls, fields, locks))
        return findings

    def _check_class(self, source, cls: ast.ClassDef,
                     fields: Set[str], locks: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        seen_fields: Set[str] = set()
        for node in cls.body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            method = node
            exempt = (method.name == '__init__'
                      or method.name.endswith('_locked'))
            held_spans = self._lock_spans(method, locks)
            for sub in ast.walk(method):
                if not (isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == 'self'
                        and sub.attr in fields):
                    continue
                seen_fields.add(sub.attr)
                if exempt:
                    continue
                if not any(a <= sub.lineno <= b for a, b in held_spans):
                    findings.append(self.finding(
                        source.rel, sub.lineno,
                        'unguarded access to `%s.%s` in `%s` — '
                        'declared guarded by %s; wrap in `with '
                        'self.%s:` (or suppress with the why if the '
                        'race is benign)'
                        % (cls.name, sub.attr, method.name,
                           '/'.join(sorted(locks)),
                           sorted(locks)[0])))
        for field in sorted(fields - seen_fields):
            findings.append(self.finding(
                source.rel, cls.lineno,
                'stale guard annotation: `%s.%s` is declared guarded '
                'but never accessed in the class' % (cls.name, field)))
        return findings

    @staticmethod
    def _lock_spans(method: ast.AST,
                    locks: Set[str]) -> List[Tuple[int, int]]:
        """Line spans of `with self.<lock>:` bodies in the method."""
        spans: List[Tuple[int, int]] = []
        for node in ast.walk(method):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                ctx = item.context_expr
                # accept `self._lock` and `self._lock.acquire_timeout()`-
                # style wrappers whose base is the declared lock
                name = dotted_name(ctx) if not isinstance(ctx, ast.Call) \
                    else dotted_name(ctx.func)
                if name is None:
                    continue
                parts = name.split('.')
                if len(parts) >= 2 and parts[0] == 'self' and \
                        parts[1] in locks:
                    spans.append((node.lineno,
                                  getattr(node, 'end_lineno',
                                          node.lineno)))
                    break
        return spans
